"""The CUDA fused kernel's launch plan (kernels/fused.py fused_plan), on the
CPU.

csrc/fused.cu walks each strip of output columns down a run of rows,
staging the raw rows of the next chunk while it computes this one, and
keeps rings of distinct source rows (and, in the fast core, half-res
rows). The host computes the strip width, the ring depths and the staged
column ranges; ``plan_chunks`` replays the kernel's walk. These tests
replay it at index level: for each output row and column they list the
source rows and columns the kernel would read through its rings and
staged offsets, and hold them to the ones ``fused_pipeline_ref`` reads
(the index maps over the gaussian window, or the bilinear taps of the
fast core's down and up passes)."""

import dataclasses

import numpy as np
import pytest
import torch

from pythoncrt_tpu_torch.kernels import fused as kfused

# (B, H, W) of the card tests, the walk's edges and the main paths' sizes
SHAPES = {"small": (48, 200), "odd": (45, 251), "tiny": (7, 9), "short": (5, 200),
          "row": (1, 300), "column": (40, 1), "h_mod_px": (43, 130),
          "1080p": (1080, 1920), "4k": (2160, 3840)}
CORES = {"off": dict(bloom=False), "r4": dict(sigma=4 / 3), "r12": dict(sigma=4.0),
         "r31": dict(sigma=31 / 3), "fast": dict(fast=True),
         "fast_knee": dict(fast=True, threshold=0.35),
         # above the launch arguments' 63 taps: the CLI's sigma 10.5, 11, 20
         "r32": dict(sigma=10.5), "r33": dict(sigma=11.0), "r60": dict(sigma=20.0)}
MAPS = {"px1_ab0": (1, 0), "px2_ab1": (2, 1), "px3_abm2": (3, -2)}


def make(shape, core, maps, pre=True):
    h, w = SHAPES[shape]
    px, ab = MAPS[maps]
    if abs(ab) >= w:
        ab = 0  # the roll needs |aberration| < W
    spec = kfused.build_fused_spec(h, w, strength=0.25, px=px, ab=ab, pre=pre,
                                   corder=(1, 2, 0), **CORES[core])
    return spec, kfused.fused_consts(spec)


def taps_np(consts):
    return None if consts.fast_taps is None else [t.numpy() for t in consts.fast_taps]


def decode(seg, off):
    """The source column a staged offset holds, from a strip's ranges."""
    a0, n0, a1, _ = seg
    return np.where(off < n0, a0 + off, a1 + off - n0)


def staged_offsets(seg, sx):
    """csrc/fused.cu: the staged offset of each source column."""
    a0, n0, a1, _ = seg
    return np.where((sx >= a0) & (sx < a0 + n0), sx - a0, n0 + sx - a1)


def row_reads(plan, consts, y_map):
    """Replay the walk of every run. Returns, per output row y, the source
    rows its output reads through the rings (gaussian: the taps' rows and
    the composite's; fast: the source rows of its two half-res rows and
    the composite's), after checking that every ring slot read holds the
    row the kernel expects."""
    h, r, dist = plan.h, plan.r, plan.ydist
    ft = taps_np(consts)
    reads = [None] * h
    for y0 in range(0, h, plan.run):
        ring = np.full(plan.depth, -1)
        half = np.full(max(plan.hdepth, 1), -1)
        half_src = {}  # half-res row -> the source rows it was made of

        def src(y):
            slot = dist[y] % plan.depth
            assert ring[slot] == dist[y], f"row {y}: slot {slot} holds {ring[slot]}"
            return int(plan.ysrc[dist[y]])

        for d, e, nh, he, nxt, ye, alive, halive in kfused.plan_chunks(plan, y0, ft):
            assert e - d <= plan.step and e - alive <= plan.depth
            for k in range(d, e):
                ring[k % plan.depth] = k
            for i in range(nh, he):
                lo = int(ft[0][i])
                half[i % plan.hdepth] = i
                half_src[i] = {src(lo), src(min(lo + 1, h - 1))}
            for y in range(nxt, ye):
                rows = {src(y)}  # the composite's pre-knee value
                if plan.fast:
                    lo = int(ft[4][y])
                    for i in (lo, min(lo + 1, len(ft[0]) - 1)):
                        assert half[i % plan.hdepth] == i, f"row {y}: half row {i} evicted"
                        rows |= half_src[i]
                else:
                    for t in range(max(0, y - r), min(h, y + r + 1)):
                        rows.add(src(t))
                    if y < r:
                        rows.add(src(0))
                    if h - 1 - y < r:
                        rows.add(src(h - 1))
                assert reads[y] is None, f"row {y} written twice"
                reads[y] = rows
    assert all(rw is not None for rw in reads), "an output row was never written"
    return reads


def ref_rows(plan, consts, y_map):
    """The source rows fused_pipeline_ref reads for each output row."""
    h, r = plan.h, plan.r
    if plan.fast:
        ft = taps_np(consts)
        h2 = len(ft[0])
        out = []
        for y in range(h):
            lo = int(ft[4][y])
            need = {y}
            for i in (lo, min(lo + 1, h2 - 1)):
                need |= {int(ft[0][i]), min(int(ft[0][i]) + 1, h - 1)}
            out.append({int(y_map[t]) for t in need})
        return out
    return [{int(y_map[t]) for t in range(max(0, y - r), min(h, y + r + 1))} for y in range(h)]


def col_reads(plan, consts, x_maps):
    """Per plane and output column, the source columns the kernel reads
    through its staged offsets (gaussian: the taps' window; fast: the
    down taps of its two up taps' half-res columns), after checking that
    the staged offsets fit the staged row and decode to the map."""
    w, r = plan.w, plan.r
    ft = taps_np(consts)
    out = [[None] * w for _ in range(3)]
    for s, (c0, c1, j0, j1) in enumerate(plan.windows):
        x0, xe = s * plan.sw, min(s * plan.sw + plan.sw, w)
        # the fast core's ring shifts the window by up to 3 columns
        assert c1 - c0 + 3 * plan.fast <= plan.win
        assert not plan.fast or j1 - j0 + 1 <= plan.hwin
        for p in range(3):
            seg = plan.segs[s, p]
            assert seg[1] + seg[3] <= plan.seg_pitch
            assert seg[0] % plan.gran == 0 and seg[2] % plan.gran == 0
            assert seg[0] + seg[1] <= w and seg[2] + seg[3] <= w
            sx = x_maps[p][c0:c1] if plan.pre else np.arange(c0, c1)
            off = staged_offsets(seg, sx)
            assert off.min() >= 0 and off.max() < seg[1] + seg[3]
            got = decode(seg, off)  # what the kernel reads for window column c0 + i
            assert np.array_equal(got, sx), f"strip {s} plane {p}: a column is not staged"
            for x in range(x0, xe):
                if plan.fast:
                    cols = {x}
                    for j in (int(ft[6][x]), min(int(ft[6][x]) + 1, len(ft[2]) - 1)):
                        assert j0 <= j <= j1
                        cols |= {int(ft[2][j]), min(int(ft[2][j]) + 1, w - 1)}
                else:
                    cols = set(range(max(0, x - r), min(w, x + r + 1)))
                assert min(cols) >= c0 and max(cols) < c1
                out[p][x] = {int(got[c - c0]) for c in cols}
    return out


def ref_cols(plan, consts, x_maps):
    w, r = plan.w, plan.r
    src = x_maps if plan.pre else np.tile(np.arange(w), (3, 1))
    if plan.fast:
        ft = taps_np(consts)
        w2 = len(ft[2])
        need = []
        for x in range(w):
            cols = {x}
            for j in (int(ft[6][x]), min(int(ft[6][x]) + 1, w2 - 1)):
                cols |= {int(ft[2][j]), min(int(ft[2][j]) + 1, w - 1)}
            need.append(cols)
    else:
        need = [set(range(max(0, x - r), min(w, x + r + 1))) for x in range(w)]
    return [[{int(src[p][c]) for c in need[x]} for x in range(w)] for p in range(3)]


@pytest.mark.parametrize("maps", sorted(MAPS))
@pytest.mark.parametrize("core", sorted(CORES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_walk_reads_what_the_twin_reads(shape, core, maps):
    """Every source row, half-res row and staged column an output needs is
    in place when the kernel produces it (the wrap columns of the roll
    included), and they are the ones the plain twin reads."""
    spec, consts = make(shape, core, maps)
    plan = consts.plan
    y_map, x_maps = consts.y_map.numpy(), consts.x_maps.numpy()
    assert row_reads(plan, consts, y_map) == ref_rows(plan, consts, y_map)
    if plan.w <= 400:  # per-column sets; the wide frames check the ranges below
        assert col_reads(plan, consts, x_maps) == ref_cols(plan, consts, x_maps)
    else:
        for s, (c0, c1, _, _) in enumerate(plan.windows):
            for p in range(3):
                seg = plan.segs[s, p]
                sx = x_maps[p][c0:c1]
                assert np.array_equal(decode(seg, staged_offsets(seg, sx)), sx)
    assert plan.smem <= kfused.SMEM_MAX


@pytest.mark.parametrize("core", ["r4", "fast", "off"])
@pytest.mark.parametrize("shape", ["odd", "tiny", "row", "column", "1080p"])
def test_plan_walk_f32_input(shape, core):
    """The f32-input mode reads every row and column once as it is (no
    maps, no dedupe): the same walk over the identity."""
    spec, consts = make(shape, core, "px1_ab0", pre=False)
    plan = consts.plan
    assert np.array_equal(plan.ydist, np.arange(plan.h)) and plan.seg_pitch % 16 == 0
    ident = np.arange(plan.h)
    assert row_reads(plan, consts, ident) == ref_rows(plan, consts, ident)
    if plan.w <= 400:
        xm = np.tile(np.arange(plan.w), (3, 1))
        assert col_reads(plan, consts, xm) == ref_cols(plan, consts, xm)


@pytest.mark.parametrize("h,px", [(43, 2), (43, 3), (1080, 2), (2160, 3), (7, 8), (1, 2)])
def test_dedupe_reuses_only_equal_map_rows(h, px):
    """A row shares its ring slot with the row above exactly when their
    y_map entries are equal, also where H % px != 0 gives runs of unequal
    length; each distinct row stages its own source row."""
    spec = kfused.build_fused_spec(h, 64, sigma=1.2, strength=0.25, px=px, ab=1)
    consts = kfused.fused_consts(spec)
    y_map, plan = consts.y_map.numpy(), consts.plan
    same = np.diff(plan.ydist) == 0
    assert np.array_equal(same, np.diff(y_map) == 0)
    assert np.array_equal(plan.ysrc[plan.ydist], y_map)
    assert plan.ydist[0] == 0 and np.all(np.diff(plan.ydist) <= 1)


@pytest.mark.parametrize("shape", ["1080p", "4k"])
@pytest.mark.parametrize("pre", [True, False])
def test_shared_memory_fits_every_radius(shape, pre):
    """Every radius the kernel takes (0-31), and the fast core, fit in a
    block's 227 KB at 1080p and at 4K; the main paths keep 128-column
    strips."""
    h, w = SHAPES[shape]
    for r in range(32):
        spec = kfused.build_fused_spec(h, w, sigma=r / 3, strength=0.25, px=2, ab=1, pre=pre)
        assert spec.r == r
        plan = kfused.fused_consts(spec).plan
        assert plan.smem <= kfused.SMEM_MAX, (r, plan.smem)
        assert plan.depth <= 2 * r + plan.step
        if r <= 12:
            assert plan.sw == 128
    spec = kfused.build_fused_spec(h, w, fast=True, strength=0.25, px=1, ab=1, pre=pre)
    plan = kfused.fused_consts(spec).plan
    assert plan.smem <= kfused.SMEM_MAX and plan.sw == 128


def test_plan_smem_is_the_kernels_layout():
    """plan_smem adds the block's buffers in csrc/fused.cu's order; the
    launcher refuses a plan whose total differs from its own layout."""
    spec = kfused.build_fused_spec(1080, 1920, sigma=1.2, strength=0.25, px=2, ab=1)
    p = kfused.fused_consts(spec).plan
    assert p.smem == kfused.plan_smem(False, True, 4, p.sw, p.step, p.depth, p.hdepth, p.win,
                                      p.hwin, p.seg_pitch, False)
    assert (p.sw, p.step, p.run, p.depth, p.win, p.gran) == (128, 8, 64, 12, 136, 16)


@pytest.mark.parametrize("other", [
    dict(), dict(sigma=31 / 3), dict(sigma=4.0, fast=True),
    dict(sigma=4.0, threshold=0.35), dict(sigma=4.0, pre=False), dict(sigma=4.0, h=44),
    dict(sigma=4.0, noise=True, grain_size=2), dict(sigma=4.0, noise=True, grain_size=3),
    dict(sigma=4.0, text_box=(3, 9, 10, 40))])
def test_plan_is_checked_against_the_spec(other):
    """The wrapper launches only with a plan made for the spec's frame,
    input, core, radius, knee, raw grain and text box (the kernel takes its taps and
    knee from the spec and its ring sizes and raw stage from the plan);
    another spec's consts are refused, and taps of the same radius share a
    plan."""
    spec = kfused.build_fused_spec(45, 251, sigma=4.0, strength=0.25, px=2, ab=1)
    kw = dict(dict(sigma=3.9, h=45), **other)  # sigma 3.9: radius 12 as well
    consts = kfused.fused_consts(kfused.build_fused_spec(
        kw.pop("h"), 251, strength=0.25, px=2, ab=1, **kw))
    if other:
        with pytest.raises(ValueError, match="not made for this spec"):
            kfused.check_plan(spec, consts)
    else:
        assert kfused.check_plan(spec, consts) is consts.plan
        assert consts.plan.key == kfused.plan_key(spec)


def test_cpu_tensors_run_the_twin():
    """On the CPU the wrapper runs the plain twin (the plan is not read)."""
    spec = kfused.build_fused_spec(9, 14, sigma=1.2, strength=0.25, px=2, ab=1)
    consts = kfused.fused_consts(spec)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 3, 9, 14), np.uint8))
    assert torch.equal(kfused.fused_pipeline(x, spec, consts),
                       kfused.fused_pipeline_ref(x, spec, consts))


@pytest.mark.parametrize("core", sorted(CORES))
@pytest.mark.parametrize("shape", ["odd", "tiny", "short", "row", "column", "h_mod_px", "1080p"])
def test_kernel_tables_follow_the_walk(shape, core):
    """The tables the kernel reads instead of walking itself: each run's
    schedule is plan_chunks', and each output row's (and half-res row's)
    ring offsets name the slots the walk above holds its rows in."""
    spec, consts = make(shape, core, "px2_ab1")
    plan, ft = consts.plan, taps_np(consts)
    h, r, dist = plan.h, plan.r, plan.ydist
    for i, y0 in enumerate(range(0, h, plan.run)):
        chunks = kfused.plan_chunks(plan, y0, ft)
        want = [chunks[0][0], chunks[-1][1], chunks[0][2]] + [
            v for c in chunks for v in (c[3], c[5])]
        assert list(plan.runtab[i, :len(want)]) == want
    y = np.arange(h)
    rows = plan.rowtab.astype(np.int64)
    strip = plan.win if plan.fast and not plan.knee else plan.sw  # the pre-knee strip's pitch
    assert np.array_equal(rows[:, 0], dist % plan.depth * 3 * strip)
    if not plan.fast:
        for k in range(2 * r + 1):
            tap = dist[np.clip(y + k - r, 0, h - 1)] % plan.depth * 3 * plan.sw
            assert np.array_equal(rows[:, 1 + k], tap)
        return
    h2 = len(ft[0])
    assert np.array_equal(rows[:, 1], ft[4] % plan.hdepth * 3 * plan.hwin)
    assert np.array_equal(rows[:, 2], np.minimum(ft[4] + 1, h2 - 1) % plan.hdepth * 3 * plan.hwin)
    assert np.array_equal(plan.rowtab[:, 3].view(np.float32), ft[5])
    half = plan.halftab.astype(np.int64)
    lo = ft[0].astype(np.int64)
    assert np.array_equal(half[:, 0], dist[lo] % plan.depth * 3 * plan.win)
    assert np.array_equal(half[:, 1], dist[np.minimum(lo + 1, h - 1)] % plan.depth * 3 * plan.win)
    assert np.array_equal(half[:, 2], np.arange(h2) % plan.hdepth * 3 * plan.hwin)
    assert np.array_equal(plan.halftab[:, 3].view(np.float32), ft[1])


@pytest.mark.parametrize("ab", [0, 1, -2])
@pytest.mark.parametrize("px", [1, 2, 3])
@pytest.mark.parametrize("shape", ["odd", "h_mod_px", "4k"])
def test_staged_ranges_cover_every_map(shape, px, ab):
    """Every pixel size with every aberration: the one or two staged
    ranges of each strip and plane hold every source column its window
    reads, the roll's wrap columns at both edges included, and distinct
    rows follow the pixelated y_map."""
    h, w = SHAPES[shape]
    for fast in (False, True):
        spec = kfused.build_fused_spec(h, w, strength=0.25, px=px, ab=ab, sigma=1.2,
                                       fast=fast)
        consts = kfused.fused_consts(spec)
        plan, x_maps = consts.plan, consts.x_maps.numpy()
        for s, (c0, c1, _, _) in enumerate(plan.windows):
            for p in range(3):
                sx = x_maps[p][c0:c1]
                off = staged_offsets(plan.segs[s, p], sx)
                assert off.min() >= 0 and off.max() < plan.seg_pitch
                assert np.array_equal(decode(plan.segs[s, p], off), sx)
        assert np.array_equal(plan.ysrc[plan.ydist], consts.y_map.numpy())


@pytest.mark.parametrize("core", ["r4", "r31", "fast", "fast_knee", "off"])
def test_static_args_are_built_once_and_copied(core):
    """The wrapper fills the arguments that follow from the spec and its
    consts once per (spec, consts, device) and hands each call a copy:
    what a call sets does not reach the next, the copy holds the plan's
    sizes and the tables' pointers, and the kept entries stay bounded."""
    spec, consts = make("odd", core, "px2_ab1")
    cpu = torch.device("cpu")
    a = kfused.static_args(spec, consts, cpu)
    a.b, a.img = 8, 1234
    b = kfused.static_args(spec, consts, cpu)
    assert (b.b, b.img) == (0, None) and a is not b
    p = consts.plan
    assert (b.h, b.w, b.sw, b.step, b.run, b.depth, b.hdepth, b.smem) == (
        p.h, p.w, p.sw, p.step, p.run, p.depth, p.hdepth, p.smem)
    assert b.rowtab == consts.plan_tables[3].data_ptr()
    assert b.xmap == consts.x_maps.data_ptr()
    assert (b.r, b.fast_on, b.knee_on) == (p.r, int(p.fast), int(p.knee))
    for _ in range(kfused.STATIC_CACHE + 3):
        other = kfused.fused_consts(spec)
        kfused.static_args(spec, other, cpu)
    assert len(kfused._static) <= kfused.STATIC_CACHE
    with pytest.raises(ValueError, match="not made for this spec"):
        kfused.static_args(kfused.build_fused_spec(45, 251, sigma=0.4, strength=0.25,
                                                   px=2, ab=1), consts, cpu)


@pytest.mark.parametrize("shape", ["1080p", "4k"])
@pytest.mark.parametrize("pre", [True, False])
def test_shared_memory_fits_large_radii(shape, pre):
    """The radii of sigma 10.5, 11 and 20 (32, 33, 60) fit a block's
    227 KB at 1080p and at 4K, their taps and border coefficients (4r + 1
    floats) in shared memory, the strip narrowed as the rings grow."""
    h, w = SHAPES[shape]
    widths = []
    for sigma, r in ((10.5, 32), (11.0, 33), (20.0, 60)):
        spec = kfused.build_fused_spec(h, w, sigma=sigma, strength=0.25, px=2, ab=1, pre=pre)
        assert spec.r == r
        consts = kfused.fused_consts(spec)
        p = consts.plan
        assert not p.split and p.smem <= kfused.SMEM_MAX, (r, p.smem)
        assert p.smem == kfused.plan_smem(False, pre, r, p.sw, p.step, p.depth, p.hdepth, p.win,
                                          p.hwin, p.seg_pitch, False)
        assert p.depth <= min(2 * r + p.step, len(p.ysrc))
        assert tuple(consts.tapdev.shape) == (4 * r + 1,)
        np.testing.assert_array_equal(consts.tapdev[:2 * r + 1].numpy(),
                                      np.asarray(spec.taps, np.float32))
        widths.append(p.sw)
    assert widths == sorted(widths, reverse=True) and widths[-1] < 128


@pytest.mark.parametrize("shape", ["tiny", "short", "row", "h_mod_px", "small"])
@pytest.mark.parametrize("pre", [True, False])
def test_ring_is_capped_at_the_frames_rows(shape, pre):
    """A radius at least the frame's height: the ring never holds more
    rows than the frame's distinct rows, and the walk still reads what the
    twin reads."""
    h, w = SHAPES[shape]
    r = max(h, w) + 2
    spec = kfused.build_fused_spec(h, w, sigma=r / 3, strength=0.25, px=2, ab=1, pre=pre,
                                   corder=(1, 2, 0))
    assert spec.r == r
    consts = kfused.fused_consts(spec)
    plan = consts.plan
    assert not plan.split and plan.depth <= len(plan.ysrc) <= h
    y_map = consts.y_map.numpy() if pre else np.arange(h)
    assert row_reads(plan, consts, y_map) == ref_rows(plan, consts, y_map)
    xm = consts.x_maps.numpy() if pre else np.tile(np.arange(w), (3, 1))
    assert col_reads(plan, consts, xm) == ref_cols(plan, consts, xm)


# the first radius that fits no strip, at 3840x2160 (pixel size 1: every
# row distinct) and at the smallest frames
SPLIT_AT = {((2160, 3840), True): 424, ((2160, 3840), False): 269,
            ((1, 1), True): 13923, ((1, 1), False): 13779}


@pytest.mark.parametrize("key", sorted(SPLIT_AT), ids=lambda k: f"{k[0][0]}x{k[0][1]}_{k[1]}")
def test_radius_that_fits_no_strip_splits(key):
    """Above these radii no strip fits a block (the rings, the staged
    window and the taps grow with the radius): the plan is split, and
    fused_pipeline runs the prologue, the stand-alone bloom and the
    epilogue as three launches. One radius less still fits."""
    (h, w), pre = key
    r = SPLIT_AT[key]
    maps = kfused.oresize.plane_index_maps(h, w, 1, 1)
    for rr, split in ((r - 1, False), (r, True)):
        spec = kfused.build_fused_spec(h, w, sigma=rr / 3, strength=0.25, px=1, ab=1, pre=pre)
        assert spec.r == rr
        plan = kfused.fused_plan(spec, *maps)
        assert plan.split == split and (split or plan.smem <= kfused.SMEM_MAX)


@pytest.mark.parametrize("pre", [True, False, "text"])
def test_split_route_is_the_fused_twin(pre):
    """The split route's three twins (prologue alone, with the text
    composited where the spec has a text box; stand-alone bloom; epilogue
    on the f32 image) give the fused twin's bits, at the smallest frame
    that splits."""
    from pythoncrt_tpu_torch.kernels import bloom3 as kbloom3

    text, pre = pre == "text", bool(pre)
    r = SPLIT_AT[((1, 1), pre)]
    spec = kfused.build_fused_spec(1, 1, sigma=r / 3, strength=0.6, threshold=0.2, px=1,
                                   ab=1, pre=pre, triad=True, scanlines=True, vignette=True,
                                   vig_strength=0.25, noise=True, noise_scale=0.01,
                                   emit="u8", corder=(1, 2, 0),
                                   text_box=(0, 1, 0, 1) if text else ())
    consts = kfused.fused_consts(spec)
    assert consts.plan.split and consts.tapdev is None
    pre_spec, pre_consts, bloom, post, post_consts = consts.split
    assert (pre_spec is not None) == pre and not post.pre and not post.bloom
    assert bloom.taps == spec.taps and bloom.r == r and not post.text_box
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (2, 3, 1, 1), np.uint8)) if pre else \
        torch.from_numpy(rng.random((2, 3, 1, 1), np.float32))
    kw = dict(grain=torch.from_numpy(rng.standard_normal((2, 1, 1), np.float32)),
              sl=torch.from_numpy(rng.random((2, 1), np.float32)),
              vy2=torch.zeros(1), vx2=torch.zeros(1), tri=torch.ones(3, 1))
    ops = {}
    if text:
        assert pre_spec.text_box == spec.text_box and pre_consts.plan.trow.tolist() == [0]
        ops = dict(talpha=torch.tensor([[0.6]]), trgb=torch.tensor([[[0.1]], [[0.9]], [[0.4]]]))
        kw.update(ops)
    want = kfused.fused_pipeline_ref(x, spec, consts, **kw)
    mid = kfused.fused_pipeline_ref(x, pre_spec, pre_consts, **ops) if pre else x
    got = kfused.fused_pipeline_ref(kbloom3.bloom3_planar_ref(mid, bloom), post, post_consts,
                                    **kw)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert torch.equal(kfused.fused_pipeline(x, spec, consts, **kw), want)


@pytest.mark.parametrize("w", range(1, 9))
@pytest.mark.parametrize("ab", [8, -8])
def test_aberration_of_the_width_or_more_is_taken_mod_w(w, ab):
    """|aberration| >= W builds: the roll is taken mod W, which gives the
    maps of the unreduced roll, and the walk reads what the twin reads."""
    h = 16
    spec = kfused.build_fused_spec(h, w, sigma=1.2, strength=0.25, px=1, ab=ab,
                                   corder=(1, 2, 0))
    assert abs(spec.ab) < w and (spec.ab - ab) % w == 0
    consts = kfused.fused_consts(spec)
    xm = consts.x_maps.numpy()
    by_color = ((np.arange(w) - ab) % w, np.arange(w), (np.arange(w) + ab) % w)
    np.testing.assert_array_equal(xm, np.stack([by_color[c] for c in (1, 2, 0)]))
    plan, y_map = consts.plan, consts.y_map.numpy()
    assert row_reads(plan, consts, y_map) == ref_rows(plan, consts, y_map)
    assert col_reads(plan, consts, xm) == ref_cols(plan, consts, xm)


# the raw-grain mode (GRAW: grain size above 1 with the noise on): frames at
# the main paths' width and at narrow ones (W % 4 != 0 at 130), and one
# whose raw field is one column wide (W < 2 * grain size)
GRAW_SHAPES = {"1080p": (1080, 1920), "small": (45, 200), "h_mod_px": (43, 130),
               "gw1": (33, 3)}


def make_graw(shape, grain_size, px, fast=False, pre=True):
    h, w = SHAPES.get(shape) or GRAW_SHAPES[shape]
    spec = kfused.build_fused_spec(h, w, strength=0.25, px=px, ab=1 if w > 1 else 0, pre=pre,
                                   corder=(1, 2, 0), noise=True, noise_scale=0.1,
                                   grain_size=grain_size,
                                   **(dict(fast=True) if fast else dict(sigma=1.2)))
    return spec, kfused.fused_consts(spec)


def staged_grain(plan, consts, field):
    """csrc/fused.cu's raw-grain path at index level, in f32 NumPy: per
    strip its raw column window and column taps (less the window's first
    column), per run and chunk the raw rows grawtab names staged in a
    (gdepth, gpitch) buffer with the rows' taps, and each output's
    upsample from that buffer alone (stage_grain, grain_staged). Checks
    every index against the stage's bounds; returns the (H, W) grain."""
    h, w, sw = plan.h, plan.w, plan.sw
    gh, gw = field.shape
    gylo, gyf, gxlo, gxf = (t.numpy() for t in consts.grain_taps)
    one = np.float32(1.0)
    out = np.full((h, w), np.nan, np.float32)
    for s, (jr0, jr1) in enumerate(plan.gwindows):
        x0, xe = s * sw, min(s * sw + sw, w)
        assert (jr0, jr1) == (gxlo[x0], gxlo[xe - 1] + 1)
        nraw = jr1 - jr0 + 1
        assert nraw <= plan.gpitch
        lx, xf = gxlo[x0:xe] - jr0, gxf[x0:xe]
        # the window holds each output's lo column and lo + 1
        assert lx.min() >= 0 and lx.max() + 1 < nraw
        cols = np.minimum(np.arange(jr0, jr0 + nraw), gw - 1)  # past the field: its last
        for i, y0 in enumerate(range(0, h, plan.run)):
            chunks = kfused.plan_chunks(plan, y0, taps_np(consts))
            for ci, (*_, nxt, ye, _, _) in enumerate(chunks):
                g0, gn, ny = plan.grawtab[i, 3 * ci:3 * ci + 3]
                assert ny == ye - nxt
                if ye == nxt:
                    continue
                assert g0 == gylo[nxt] and gn == gylo[ye - 1] + 2 - g0
                assert gn <= plan.gdepth and ye - nxt <= plan.grows
                stage = np.full((plan.gdepth, plan.gpitch), np.nan, np.float32)
                rows = np.minimum(np.arange(g0, g0 + gn), gh - 1)
                stage[:gn, :nraw] = field[rows[:, None], cols[None, :]]
                for y in range(nxt, ye):
                    k = gylo[y] - g0
                    assert 0 <= k and k + 1 < gn
                    r0, r1, fy = stage[k], stage[k + 1], gyf[y]
                    lo = r0[lx] * (one - fy) + r1[lx] * fy
                    hi = r0[lx + 1] * (one - fy) + r1[lx + 1] * fy
                    out[y, x0:xe] = lo * (one - xf) + hi * xf
    return out


@pytest.mark.parametrize("fast", [False, True], ids=["gaussian", "fast"])
@pytest.mark.parametrize("px", [1, 2, 3])
@pytest.mark.parametrize("shape", sorted(GRAW_SHAPES))
@pytest.mark.parametrize("grain_size", [2, 3, 5])
def test_raw_grain_stage_holds_what_each_output_reads(grain_size, shape, px, fast):
    """Each strip's raw column window holds every lo and hi column its
    outputs read, each chunk's raw rows fit the stage's depth and its rows
    the taps' room, and the upsample from the stage alone is bit for bit
    the twin's resize_bilinear of the field (at 1080p: the windows and the
    row ranges, without the upsample)."""
    spec, consts = make_graw(shape, grain_size, px, fast)
    plan = consts.plan
    gh, gw = spec.grain_hw
    assert plan.grain == (grain_size, gh, gw) and plan.key == kfused.plan_key(spec)
    assert shape != "gw1" or gw == 1
    if shape == "1080p":  # the windows and row ranges only: the upsample is per pixel
        gylo, gxlo = (consts.grain_taps[i].numpy() for i in (0, 2))
        for s, (jr0, jr1) in enumerate(plan.gwindows):
            x0, xe = s * plan.sw, min(s * plan.sw + plan.sw, plan.w)
            assert jr0 == gxlo[x0] and jr1 - jr0 + 1 <= plan.gpitch
            assert gxlo[x0:xe].max() + 1 <= jr1 <= gw - 1
        for i, y0 in enumerate(range(0, plan.h, plan.run)):
            stage = kfused.grain_stage(kfused.plan_chunks(plan, y0, taps_np(consts)), gylo)
            assert list(plan.grawtab[i, :3 * len(stage)]) == [v for c in stage for v in c]
            assert not plan.grawtab[i, 3 * len(stage):].any()
            for g0, gn, ny in stage:
                assert gn <= plan.gdepth and ny <= plan.grows
                assert ny == 0 or g0 + gn - 1 <= gh  # lo + 1 of the last row: at most gh
        return
    field = np.random.default_rng(grain_size).standard_normal((gh, gw)).astype(np.float32)
    t = [a.long() if i % 2 == 0 else a for i, a in enumerate(consts.grain_taps)]
    want = kfused.oresize.resize_bilinear(torch.from_numpy(field), *t).numpy()
    got = staged_grain(plan, consts, field)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("px", [1, 2, 3])
@pytest.mark.parametrize("fast", [False, True], ids=["gaussian", "fast"])
def test_raw_grain_plan_smem_is_the_layout(fast, px):
    """plan_smem with the raw stage equals the kernel's layout: the walk's
    block at grain size 1 plus the strip's column taps, two buffers of
    (gdepth, gpitch) raw floats and the rows' taps, and the run's row of
    grawtab. At 1080p and grain size
    2 the block leaves room for as many blocks per SM as the grain-size-1
    plan's: c3's gaussian core keeps its walk (3 per SM at pixel size 2
    and 3, 2 at 1), and the fast core at pixel size 2, whose raw stage
    would cost a block at WALK's chunk of 12 rows, takes GRAW_STEPS' 8."""
    spec, consts = make_graw("1080p", 2, px, fast)
    p = consts.plan
    base = kfused.plan_smem(p.fast, True, p.r, p.sw, p.step, p.depth, p.hdepth, p.win, p.hwin,
                            p.seg_pitch, p.knee)
    stage = 2 * (p.gdepth * p.gpitch + 2 * p.grows) * 4
    gstride = p.grawtab.shape[1]
    assert gstride == 3 * max(len(kfused.plan_chunks(p, y0, taps_np(consts)))
                              for y0 in range(0, p.h, p.run))
    assert p.smem == kfused.plan_smem(p.fast, True, p.r, p.sw, p.step, p.depth, p.hdepth, p.win,
                                      p.hwin, p.seg_pitch, p.knee, False,
                                      (p.gdepth, p.gpitch, p.grows, gstride))
    assert p.smem == base + p.sw * 8 + -(-stage // 16) * 16 + -(-gstride * 4 // 16) * 16
    flat = kfused.fused_consts(dataclasses.replace(spec, grain_size=1)).plan
    assert kfused.blocks_per_sm(p.smem) == kfused.blocks_per_sm(flat.smem)
    assert (p.sw, p.run) == (flat.sw, flat.run) == (128, 128 if fast else 64)
    shorter = fast and px == 2
    assert p.step == (kfused.GRAW_STEPS[0] if shorter else flat.step)
    if not shorter:
        assert (p.depth, base) == (flat.depth, flat.smem)
    if not fast:
        assert kfused.blocks_per_sm(p.smem) == {1: 2, 2: 3, 3: 3}[px]
        assert (p.gpitch, p.gdepth, p.grows) == {1: (66, 6, 8), 2: (66, 10, 16),
                                                 3: (66, 14, 24)}[px]


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_raw_grain_chunk_rule_counts_the_register_cap(precision):
    """A shorter chunk is taken only where it gives back the blocks per SM
    the raw stage costs: the CLI defaults at grain size 2 (fast core,
    pixel size 2) take GRAW_STEPS' 8 with the LUT-exact triad (four
    64-register blocks by shared memory again), but keep WALK's 12 with
    the direct-pow triad, whose 80-register cap allows three blocks at
    either chunk."""
    direct = precision == "fast"
    spec = kfused.build_fused_spec(1080, 1920, fast=True, strength=0.25, px=2, ab=1, triad=True,
                                   lut_exact=not direct, noise=True, noise_scale=0.1,
                                   grain_size=2)
    p = kfused.fused_consts(spec).plan
    assert p.direct == direct and p.grain == (2, 540, 960)
    assert kfused.register_blocks(True, True, direct, True) == (3 if direct else 4)
    assert p.step == (kfused.WALK["fast", True][0] if direct else kfused.GRAW_STEPS[0])
    assert min(kfused.blocks_per_sm(p.smem), kfused.register_blocks(True, True, direct, True)) \
        == (3 if direct else 4)


# text boxes' rows (y0, y1) at the odd shape, and c4.caption's at 1080p
TEXT_ROWS = {("odd", "inner"): (10, 25), ("odd", "top"): (0, 9), ("odd", "bottom"): (36, 45),
             ("odd", "whole"): (0, 45), ("odd", "one_row"): (7, 8),
             ("1080p", "caption"): (108, 243)}


@pytest.mark.parametrize("core", ["r4", "fast", "fast_knee", "r33", "off"])
@pytest.mark.parametrize("maps", ["px2_ab1", "px3_abm2"])
@pytest.mark.parametrize("shape,box", sorted(TEXT_ROWS), ids=lambda v: str(v))
def test_text_plan_walk_keeps_the_box_rows_distinct(shape, box, maps, core):
    """plan_chunks replays a TEXT walk (the text composited in the
    prologue): each output row of the text box is a distinct row of its own
    (the composite makes rows of one source row differ there), named by
    trow, and the row after the box starts one; the rows outside it still
    share a ring slot where their y_map entries are equal. Every ring read
    of the walk is in place and is the row the twin reads."""
    h, w = SHAPES[shape]
    y0, y1 = TEXT_ROWS[shape, box]
    px, ab = MAPS[maps]
    spec = kfused.build_fused_spec(h, w, strength=0.25, px=px, ab=ab, corder=(1, 2, 0),
                                   text_box=(y0, y1, 20, 90), **CORES[core])
    consts = kfused.fused_consts(spec)
    plan, y_map = consts.plan, consts.y_map.numpy()
    dist = plan.ydist
    inbox = np.zeros(h + 1, bool)
    inbox[y0:y1] = True
    new = np.diff(dist) == 1
    assert np.all(np.diff(dist) <= 1) and dist[0] == 0
    assert np.array_equal(new, (np.diff(y_map) != 0) | inbox[1:h] | inbox[:h - 1])
    assert np.array_equal(plan.ysrc[dist], y_map)
    assert len(plan.ysrc) < h or (y0, y1) == (0, h)  # rows outside the box deduplicated
    want = np.full(len(plan.ysrc), -1)
    want[dist[y0:y1]] = np.arange(y1 - y0)
    assert np.array_equal(plan.trow, want)
    assert torch.equal(consts.plan_tables[6], torch.from_numpy(want.astype(np.int32)))
    assert row_reads(plan, consts, y_map) == ref_rows(plan, consts, y_map)
    assert plan.key == kfused.plan_key(spec) and plan.smem <= kfused.SMEM_MAX
