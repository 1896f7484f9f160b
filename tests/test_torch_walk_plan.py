"""The stand-alone blooms' row walk (kernels/bloom_walk.py walk_plan), on
the CPU.

csrc/bloom_walk.cu walks each strip of output columns of a plane down a
run of rows: it stages the raw rows of the next chunk while it filters
this one, keeps a ring of horizontally filtered rows and a ring of the
strip's pre-knee rows, and writes every output row whose band the ring
holds. The host sizes the strips, chunks and rings; ``walk_chunks``
replays the kernel's walk. These tests replay it at index level for the
three weight sources (the fold of bloom3, the clamp of the stripe bloom,
the tables of bloom2): for each output row and column they list the
source rows and columns the kernel reads through its rings, slots and
staged window, and hold them to the ones the plain twin reads. The fast
source (bloom3's fast bloom: the oracle's bilinear resize to half size
and back) is replayed the same way through its rings of staged rows,
pre-knee rows and half-res rows, with the kernel's own tables."""

import numpy as np
import pytest
import torch

from pythoncrt_tpu_torch.kernels import bloom2 as kbloom2
from pythoncrt_tpu_torch.kernels import bloom_walk as kwalk
from pythoncrt_tpu_torch.kernels import fused as kfused

SHAPES = {"odd": (45, 251), "tiny": (7, 9), "row": (1, 300), "column": (40, 1),
          "1080p": (1080, 1920), "4k": (2160, 3840)}
RADII = [0, 1, 4, 12, 31, 32, 33, 60, "ge_hw"]  # ge_hw: a radius >= H and >= W
BIG = ("1080p", "4k")  # a radius past H and W is replayed at the small shapes only
BIG_RADII = tuple(r for r in RADII if r != "ge_hw")
SOURCES = {"fold": kwalk.FOLD, "clamp": kwalk.CLAMP, "table": kwalk.TABLE}


def bands_of(src, r, shape):
    """(hd0, hd1, vd0, vd1): -r..r on both axes; for the table source an
    uneven band as well (bloom2's bands come from its matrices)."""
    if src == kwalk.TABLE and r == 1:
        return (-3, 1, 0, 2)
    return (-r, r, -r, r)


def radius(r, shape):
    return max(shape) + 3 if r == "ge_hw" else r


def cases():
    out = []
    for name, shape in SHAPES.items():
        for r in (BIG_RADII if name in BIG else RADII):
            for s in SOURCES:
                out.append((name, r, s))
    return out


def twin_rows(src, y, h, d0, d1):
    """The source rows (or columns) the plain twin reads for output y."""
    if src == kwalk.FOLD:
        r = d1
        rows = set(range(max(0, y - r), min(h, y + r + 1)))
        if y < r:
            rows.add(0)
        if h - 1 - y < r:
            rows.add(h - 1)
        return rows
    return {min(max(y + d, 0), h - 1) for d in range(d0, d1 + 1)}


def slot(base, s, d, depth):
    """csrc/bloom_walk.cu's ring slot of source row s from the chunk that
    starts at row d (its slot base = d % depth): one wrap either way."""
    t = base + s - d
    assert -depth < t < 2 * depth, "the slot needs more than one wrap"
    return t + depth if t < 0 else (t - depth if t >= depth else t)


def replay_rows(plan):
    """Per output row, the source rows its vertical sum reads, after
    checking that each ring slot it reads holds that row and that its
    pre-knee row is in the strip ring."""
    h = plan.h
    reads = [None] * h
    for y0 in range(0, h, plan.run):
        ring = np.full(plan.depth, -1)
        xring = np.full(max(plan.xdepth, 1), -1)
        for d, e, nxt, ye, alive in kwalk.walk_chunks(plan, y0):
            assert 0 < e - d <= plan.step
            assert e - alive <= plan.depth and e - nxt <= plan.xdepth
            rb, xb = d % plan.depth, d % plan.xdepth
            for k in range(e - d):
                assert k < plan.depth and k < plan.xdepth
                ring[(rb + k) % plan.depth] = d + k
                xring[(xb + k) % plan.xdepth] = d + k
            for y in range(nxt, ye):
                rows = twin_rows(plan.src, y, h, plan.vd0, plan.vd1)
                for s in rows:
                    assert ring[slot(rb, s, d, plan.depth)] == s, f"row {y}: row {s} evicted"
                assert xring[slot(xb, y, d, plan.xdepth)] == y, f"row {y}: pre-knee row evicted"
                assert reads[y] is None, f"row {y} written twice"
                reads[y] = rows
    assert all(r is not None for r in reads), "an output row was never written"
    return reads


def check_columns(plan):
    """Every column an output reads lies in its strip's staged window (both
    copy granules), the window fits the staged pitch and the frame, and
    the unrolled instances' vector loads are aligned."""
    w, hd0, hd1 = plan.w, plan.hd0, plan.hd1
    for s in range(plan.strips):
        x0, xe = s * plan.sw, min(s * plan.sw + plan.sw, w)
        for gran in (4, 1):
            a0, n = kwalk.strip_window(w, plan.sw, hd0, hd1, s, gran)
            assert n <= plan.win and plan.win % 4 == 0
            assert a0 + n <= w or gran == 4 and w % 4, "the window leaves the frame"
            need = set()
            for x in range(x0, xe):
                need |= twin_rows(plan.src, x, w, hd0, hd1)
            assert a0 <= min(need) and max(need) < a0 + n
            assert a0 <= x0 and xe <= a0 + n  # the pre-knee strip is staged
            sym = hd0 == -hd1 == plan.vd0 == -plan.vd1
            for gx in range(x0, xe, 4):
                if gx + hd0 >= 0 and gx + 3 + hd1 <= w - 1:  # the interior path
                    off = gx + hd0 - a0
                    assert 0 <= off and off + 4 + hd1 - hd0 <= n
                    if sym and hd1 == 4:
                        assert off % 4 == 0, "the 16-byte window loads"
                    if sym and hd1 == 2 and plan.src == kwalk.TABLE:
                        assert off % 2 == 0, "the 8-byte window loads"


@pytest.mark.parametrize("name,r,src", cases())
def test_walk_reads_what_the_twin_reads(name, r, src):
    """Every source row and column an output needs is in place when the
    kernel writes it, and they are the ones the plain twin reads; the
    block fits in shared memory at every radius."""
    h, w = SHAPES[name]
    r = radius(r, (h, w))
    hd0, hd1, vd0, vd1 = bands_of(SOURCES[src], r, (h, w))
    plan = kwalk.walk_plan(SOURCES[src], h, w, hd0, hd1, vd0, vd1)
    assert not plan.scratch
    assert plan.smem <= kwalk.SMEM_MAX
    assert plan.smem == kwalk.walk_smem(plan.src, hd0, hd1, plan.sw, plan.step, plan.depth,
                                        plan.xdepth, plan.win)
    assert plan.sw % 4 == 0 and (plan.sw // 4) & (plan.sw // 4 - 1) == 0  # shifts split items
    reads = replay_rows(plan)
    assert reads == [twin_rows(plan.src, y, h, vd0, vd1) for y in range(h)]
    check_columns(plan)
    # the rings never hold more than the frame's rows
    assert plan.depth <= max(h, plan.step) and plan.xdepth <= max(h, plan.step)


@pytest.mark.parametrize("src", sorted(SOURCES))
def test_main_path_plans(src):
    """At 1080p the sigma 1.2 band (and bloom2's fast band) keep 128-column
    strips; every radius up to 60 fits a block at 1080p and at 4K."""
    for h, w in (SHAPES["1080p"], SHAPES["4k"]):
        for r in range(61):
            plan = kwalk.walk_plan(SOURCES[src], h, w, -r, r, -r, r)
            assert not plan.scratch and plan.smem <= kwalk.SMEM_MAX, (r, plan)
            if r <= 12:
                assert plan.sw == 128
    spec = kbloom2.build_bloom2_spec(1080, 1920, variant="fast")
    plan = kwalk.walk_plan(kwalk.TABLE, 1080, 1920, spec.hd0, spec.hd1, spec.vd0, spec.vd1)
    assert (plan.sw, plan.step, plan.run) == (128, 16, 64)


@pytest.mark.parametrize("src", sorted(SOURCES))
def test_band_too_wide_for_a_block_takes_the_scratch_route(src):
    """The weight table grows with the band (the taps, or the strip's
    columns of hw): past a block's shared memory even at 4-column strips
    and 1-row chunks the plan is the scratch route, here at the smallest
    frame, one pixel."""
    s = SOURCES[src]
    limit = {kwalk.FOLD: 14524, kwalk.CLAMP: 29048, kwalk.TABLE: 7262}[s]  # the first reach
    below = kwalk.walk_plan(s, 1, 1, -(limit - 1), limit - 1, -(limit - 1), limit - 1)
    assert not below.scratch and below.sw == 4 and below.smem <= kwalk.SMEM_MAX
    plan = kwalk.walk_plan(s, 1, 1, -limit, limit, -limit, limit)
    assert plan.scratch and plan.sw == 0


def test_walk_plan_refuses_bad_bands():
    with pytest.raises(ValueError):
        kwalk.walk_plan(kwalk.FOLD, 8, 8, 1, 0, 0, 0)
    with pytest.raises(ValueError):
        kwalk.walk_plan(7, 8, 8, 0, 0, 0, 0)


# the fast source's edges: odd sizes, one pixel, a row, a column, H or W of
# 2 (one half-res row or column), W % 4 != 0, a frame narrower than a
# strip and shorter than a run, and the main path's sizes
FAST_SHAPES = {"odd": (45, 251), "tiny": (7, 9), "pixel": (1, 1), "row": (1, 300),
               "column": (40, 1), "h2": (2, 300), "w2": (40, 2), "w_mod4": (33, 130),
               "three": (3, 3), "1080p": (1080, 1920), "4k": (2160, 3840)}


def replay_fast(plan, taps):
    """Walk every run as csrc/bloom_walk.cu's fast source does, holding
    what each ring slot contains: the next chunk is staged into its slots
    before this chunk is read, then this chunk's pre-knee rows, its
    half-res rows (their source rows through the kernel's halftab
    offsets), its output rows (their pre-knee row and half-res rows
    through rowtab). Returns per output row the half-res rows it read
    (a run recomputes the half-res rows it shares with the run above)."""
    h, h2 = plan.h, plan.h2
    fd_ylo, fd_yf, fu_ylo, fu_yf = (np.asarray(taps[i]) for i in (0, 1, 4, 5))
    out_reads = [None] * h
    for ri, y0 in enumerate(range(0, h, plan.run)):
        sched = [int(v) for v in plan.sched[ri]]
        pa, pe, nh = sched[:3]
        ring = np.full(plan.depth, -1)
        xring = np.full(max(plan.xdepth, 1), -1)
        hring = np.full(plan.hdepth, -1)
        done = set()

        def stage(d, dn):
            assert dn <= plan.depth  # a chunk's copies wrap the ring at most once
            for k in range(dn):
                ring[(d + k) % plan.depth] = d + k
        stage(pa, min(plan.step, pe - pa))
        nxt = y0
        for ci, d in enumerate(range(pa, pe, plan.step)):
            dn = min(plan.step, pe - d)
            e = d + dn
            if e < pe:
                stage(e, min(plan.step, pe - e))
            for k in range(dn):  # the knee pass reads the chunk's own rows
                assert ring[(d + k) % plan.depth] == d + k, f"row {d + k} evicted before its knee"
                if plan.knee:
                    xring[(d + k) % plan.xdepth] = d + k
            he, ye = sched[3 + 2 * ci], sched[4 + 2 * ci]
            for i in range(nh, he):
                lo_off, hi_off, own, bits = plan.halftab[i]
                assert lo_off % plan.win == 0 and hi_off % plan.win == 0 and own % plan.hwin == 0
                rows = (ring[lo_off // plan.win], ring[hi_off // plan.win])
                assert rows == (fd_ylo[i], min(fd_ylo[i] + 1, h - 1)), f"half row {i}: {rows}"
                assert np.int32(bits).view(np.float32) == fd_yf[i]
                assert i not in done, f"half row {i} computed twice in a run"
                done.add(i)
                hring[own // plan.hwin] = i
            for y in range(nxt, ye):
                xo, lo_off, hi_off, bits = plan.rowtab[y]
                if plan.knee:  # its own ring
                    assert xo % plan.sw == 0 and xring[xo // plan.sw] == y, f"row {y}: pre-knee"
                else:  # the staged ring, never knee'd
                    assert xo % plan.win == 0 and ring[xo // plan.win] == y, f"row {y}: pre-knee"
                halves = (hring[lo_off // plan.hwin], hring[hi_off // plan.hwin])
                assert halves == (fu_ylo[y], min(fu_ylo[y] + 1, h2 - 1)), f"row {y}: {halves}"
                assert np.int32(bits).view(np.float32) == fu_yf[y]
                assert out_reads[y] is None, f"row {y} written twice"
                out_reads[y] = halves
            nh, nxt = he, ye
        assert nxt == min(y0 + plan.run, h)
    assert all(r is not None for r in out_reads), "an output row was never written"
    return out_reads


def check_fast_columns(plan, taps):
    """Each strip's staged window holds every column its down-column taps
    read and the strip itself (the pre-knee copy), its half-res window
    every column its up-column taps read; both fit their pitches and the
    frame, and where W % 4 == 0 they start and end on 16-byte words."""
    w, w2 = plan.w, plan.w2
    fd_xlo, fu_xlo = np.asarray(taps[2]), np.asarray(taps[6])
    assert plan.windows.shape == (plan.strips, 4)
    for s, (a0, n, j0, nh) in enumerate(plan.windows):
        x0, xe = s * plan.sw, min(s * plan.sw + plan.sw, w)
        assert 0 <= a0 and a0 + n <= w and n <= plan.win and plan.win % 4 == 0
        assert 0 <= j0 and j0 + nh <= w2 and nh <= plan.hwin
        ups = {int(v) for x in range(x0, xe) for v in (fu_xlo[x], min(fu_xlo[x] + 1, w2 - 1))}
        assert ups == set(range(j0, j0 + nh)), f"strip {s}: half columns {ups}"
        downs = {int(v) for j in range(j0, j0 + nh) for v in (fd_xlo[j], min(fd_xlo[j] + 1, w - 1))}
        assert a0 <= min(downs) and max(downs) < a0 + n
        assert a0 <= x0 and xe <= a0 + n
        if w % 4 == 0:
            assert a0 % 4 == 0 and n % 4 == 0 and (x0 - a0) % 4 == 0 and (xe - x0) % 4 == 0


@pytest.mark.parametrize("knee", [True, False], ids=["knee", "no_knee"])
@pytest.mark.parametrize("name", sorted(FAST_SHAPES))
def test_fast_walk_reads_what_the_twin_reads(name, knee):
    """Every source row, half-res row and column the twin's taps read is in
    its ring or window when the kernel reads it, through the kernel's own
    ring offsets; each output row is written once; the block fits."""
    h, w = FAST_SHAPES[name]
    plan = kwalk.fast_plan(h, w, knee)
    assert plan.knee == knee and (plan.xdepth > 0) == knee
    taps = kfused.fast_tables(h, w)
    assert plan.smem == kwalk.fast_smem(plan.sw, plan.depth, plan.xdepth, plan.hdepth, plan.win,
                                        plan.hwin) <= kwalk.SMEM_MAX
    assert plan.sw % 4 == 0 and (plan.sw // 4) & (plan.sw // 4 - 1) == 0  # shifts split items
    reads = replay_fast(plan, taps)
    assert [set(r) for r in reads] == [{int(taps[4][y]), min(int(taps[4][y]) + 1, plan.h2 - 1)}
                                       for y in range(h)]
    check_fast_columns(plan, taps)


def test_fast_main_path_plan():
    """At 1080p and 4K the fast source keeps 128-column strips, chunks of
    FAST_STEP rows and runs of FAST_RUN, with rings of two chunks of
    staged rows, a few more without a knee (the output rows lag the
    source rows they composite); the tables are sized by the frame."""
    for h, w in (FAST_SHAPES["1080p"], FAST_SHAPES["4k"]):
        plan = kwalk.fast_plan(h, w, True)
        off = kwalk.fast_plan(h, w, False)
        assert (plan.sw, plan.step, plan.run) == (128, kwalk.FAST_STEP, kwalk.FAST_RUN)
        assert (off.sw, off.step, off.run) == (128, kwalk.FAST_STEP, kwalk.FAST_RUN)
        assert plan.depth == 2 * kwalk.FAST_STEP < off.depth <= 2 * kwalk.FAST_STEP + 4
        assert off.xdepth == 0 and off.smem < plan.smem
        assert plan.rowtab.shape == (h, 4) and plan.halftab.shape == (h // 2, 4)
        assert plan.sched.shape[0] == -(-h // plan.run)


def test_fast_tables_carry_the_twins_taps():
    """The device tables of the fast source: the oracle's bilinear taps and
    the plan's tables, int32 and contiguous, as the launcher checks."""
    t = kwalk.fast_tables(45, 251, 0.0)
    for got, want in zip(t.taps, kfused.fast_tables(45, 251)):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(t.walk, (t.plan.windows, t.plan.sched, t.plan.rowtab, t.plan.halftab)):
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    assert not t.plan.knee and kwalk.fast_tables(45, 251, 0.3).plan.knee
    with pytest.raises(ValueError):
        kwalk.fast_plan(0, 5, False)
