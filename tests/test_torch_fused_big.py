"""The fused kernel's gaussian core past radius 31 (csrc/fused.cu, the BIG
instantiations), replayed on the CPU.

Past 31 the taps come from a table in shared memory and the tap loops are
register-blocked: an interior strip's horizontal pass slides a window of
eight knee'd columns through registers (one 16-byte load of the row and
one of the taps per four taps), and the vertical pass sums BIG_ROWS inner
output rows at once, walking their union window of ring rows once. The
kernel's bits are the twin's only if every output still adds its terms
in the twin's order: the in-frame taps ascending, then the left (top)
border coefficient times the edge sample, then the right (bottom) one
(ops/blur.py). These tests replay the kernel's loops at index level,
term by term, against that order: which window column or ring slot each
term reads and which tap it multiplies, with the ring's contents
followed through the walk (kernels/fused.py plan_chunks)."""

import numpy as np
import pytest

from pythoncrt_tpu_torch.kernels import fused as kfused

BR = kfused.BIG_ROWS
SHAPES = {"96x160": (96, 160), "48x256": (48, 256), "200x50": (200, 50), "40x1": (40, 1),
          "1080p": (1080, 1920)}
RADII = {"r32": 32, "r33": 33, "r60": 60, "r_past_h": None}  # None: a radius past H


def make(shape, radius, px, pre):
    h, w = SHAPES[shape]
    r = max(h, w) + 2 if radius is None else radius
    spec = kfused.build_fused_spec(h, w, sigma=r / 3, strength=0.25, px=px, ab=1, pre=pre,
                                   corder=(1, 2, 0))
    assert spec.r == r > kfused.MAX_R
    consts = kfused.fused_consts(spec)
    assert not consts.plan.split
    return spec, consts


def twin_terms(n, r, i):
    """The twin's terms of output i of an axis of n samples: (term, sample)
    for each in-frame tap ascending, then each border coefficient that is
    not zero (distance from the left/top, then from the right/bottom)."""
    terms = [(("tap", k), i + k - r) for k in range(2 * r + 1) if 0 <= i + k - r < n]
    if i < r:
        terms.append((("edgel", i), 0))
    if n - 1 - i < r:
        terms.append((("edger", n - 1 - i), n - 1))
    return terms


def h_terms_interior(r, q):
    """csrc/fused.cu htaps_interior<BIG> for the quad of outputs 4q .. 4q + 3
    of an interior strip: per output, (term, window column) in the order
    the kernel adds them. Registers x[0..7] hold window columns t + 4q ..
    t + 4q + 7; the float4 of taps holds taps t .. t + 3."""
    kt, base = 2 * r + 1, 4 * q
    out = [[] for _ in range(4)]
    t = 0
    while t + 4 <= kt:
        assert (base + t + 4) % 4 == 0 and t % 4 == 0  # the 16-byte loads are aligned
        x = [base + t + i for i in range(8)]
        for j in range(4):
            for v in range(4):
                out[v].append((("tap", t + j), x[v + j]))
        t += 4
    if t < kt:
        x = [base + t + i for i in range(8)]
        for j in range(3):
            if t + j < kt:
                for v in range(4):
                    out[v].append((("tap", t + j), x[v + j]))
    return out


def h_terms_edge(r, w, x):
    """The kernel's per-output loop of an edge strip: (term, frame column),
    the in-frame taps ascending, then the fold."""
    terms = [(("tap", t), x + t - r) for t in range(2 * r + 1) if 0 <= x + t - r < w]
    if x < r:
        terms.append((("edgel", x), 0))
    if w - 1 - x < r:
        terms.append((("edger", w - 1 - x), w - 1))
    return terms


def h_replay(plan):
    """Per output column, the kernel's horizontal terms with frame columns."""
    w, r, sw = plan.w, plan.r, plan.sw
    got = [None] * w
    for s in range(plan.strips):
        x0 = s * sw
        win0 = max(0, x0 - r)
        interior = x0 >= r and x0 + sw + r <= w
        for q in range(-(-min(sw, w - x0) // 4)):
            if interior:
                quad = h_terms_interior(r, q)
                for v in range(4):
                    x = x0 + 4 * q + v
                    cols = [c for _, c in quad[v]]
                    # x[v + j] is column x - r + t of the frame: inside the window
                    assert max(cols) < min(w, x0 + sw + r) - win0
                    got[x] = [(term, win0 + c) for term, c in quad[v]]
            else:
                for v in range(4):
                    x = x0 + 4 * q + v
                    if x < w:
                        got[x] = h_terms_edge(r, w, x)
    return got


def strip_quads(plan):
    """The distinct quad counts nq of the plan's strips (a frame narrower
    than the strip, or a last strip cut short, has fewer)."""
    return sorted({-(-min(plan.sw, plan.w - x0) // 4) for x0 in range(0, plan.w, plan.sw)})


def v_replay(plan, nq):
    """Replay csrc/fused.cu's vertical pass past MAX_R down every run, for
    a strip of nq quads: the rows each chunk completes go in passes of
    step * win // (4 nq) rows (their composites fill S.kw, 4 nq columns a
    row and plane), each pass in groups of BR rows from its first.
    A whole group of inner rows walks its union window j = 0 .. 2r + BR - 1
    (vtaps_block: offset rowtab[y - r + j][0], tap j - i for output i);
    any other row (the frame's top and bottom rows, a pass's last rows)
    takes the per-row loop (rowtab[y][1 + k], then the fold). Per output
    row, (term, distinct row the ring slot holds), after checking that
    every slot read holds a row the walk has filtered and not evicted, and
    the pre-knee row of each composite."""
    h, r, sw, depth = plan.h, plan.r, plan.sw, plan.depth
    tab, dist = plan.rowtab.astype(np.int64), plan.ydist
    slot_of = 3 * sw
    vcap = plan.step * plan.win // (4 * nq)
    assert vcap >= plan.step  # the window holds the strip: win >= 4 nq
    got = [None] * h
    blocked = 0
    for y0 in range(0, h, plan.run):
        ring = np.full(depth, -1)

        def held(off):
            assert off % slot_of == 0
            return int(ring[off // slot_of])

        for d, e, _, _, nxt, ye, _, _ in kfused.plan_chunks(plan, y0):
            for k in range(d, e):
                ring[k % depth] = k
            for ya in range(nxt, ye, vcap):
                yb = min(ya + vcap, ye)
                for y in range(ya, yb, BR):
                    n = min(BR, yb - y)
                    terms = [[] for _ in range(n)]
                    if n == BR and y - r >= 0 and y + BR - 1 + r < h:
                        blocked += 1
                        for j in range(2 * r + BR):
                            row = held(tab[y - r + j, 0])
                            for i in range(BR):
                                if 0 <= j - i <= 2 * r:
                                    terms[i].append((("tap", j - i), row))
                    else:
                        for i in range(n):
                            yi, t = y + i, tab[y + i]
                            terms[i] = [(("tap", k), held(t[1 + k])) for k in range(2 * r + 1)
                                        if 0 <= yi + k - r < h]
                            if yi < r:
                                terms[i].append((("edgel", yi), held(t[1 + r - yi])))
                            if h - 1 - yi < r:
                                terms[i].append((("edger", h - 1 - yi),
                                                 held(t[1 + (h - 1 - yi) + r])))
                    for i in range(n):
                        assert held(tab[y + i, 0]) == dist[y + i]  # the composite's pre-knee row
                        assert got[y + i] is None, f"row {y + i} written twice"
                        got[y + i] = terms[i]
    assert all(g is not None for g in got), "an output row was never written"
    return got, blocked


@pytest.mark.parametrize("pre", [True, False], ids=["u8_input", "f32_input"])
@pytest.mark.parametrize("px", [1, 2])
@pytest.mark.parametrize("radius", sorted(RADII))
@pytest.mark.parametrize("shape", ["96x160", "48x256", "200x50", "40x1"])
def test_horizontal_terms_are_the_twins(shape, radius, px, pre):
    """Every output column adds the twin's horizontal terms in the twin's
    order: the interior strips' register window, the edge strips' loop
    with its fold."""
    _, consts = make(shape, RADII[radius], px, pre)
    plan = consts.plan
    got = h_replay(plan)
    for x in range(plan.w):
        assert got[x] == twin_terms(plan.w, plan.r, x), f"column {x}"


@pytest.mark.parametrize("pre", [True, False], ids=["u8_input", "f32_input"])
@pytest.mark.parametrize("px", [1, 2])
@pytest.mark.parametrize("radius", sorted(RADII))
@pytest.mark.parametrize("shape", ["96x160", "48x256", "200x50", "40x1"])
def test_vertical_terms_are_the_twins(shape, radius, px, pre):
    """Every output row adds the twin's vertical terms in the twin's order,
    each from the ring slot that holds its filtered row when the kernel
    reads it: the whole groups' union windows, and the per-row loop of the
    rows at the frame's edges and past a pass's last whole group."""
    _, consts = make(shape, RADII[radius], px, pre)
    plan = consts.plan
    for nq in strip_quads(plan):
        got, blocked = v_replay(plan, nq)
        for y in range(plan.h):
            want = [(term, int(plan.ydist[row])) for term, row in twin_terms(plan.h, plan.r, y)]
            assert got[y] == want, f"row {y}, strips of {nq} quads"
        if plan.h - 2 * plan.r < BR:  # no group of inner rows
            assert blocked == 0


@pytest.mark.parametrize("pre", [True, False], ids=["u8_input", "f32_input"])
@pytest.mark.parametrize("radius", ["r33", "r60"])
def test_main_path_terms_are_the_twins(radius, pre):
    """The CLI defaults' frame (1080p, pixel 2) at sigma 11 and 20: both
    passes term for term, most rows through whole groups."""
    _, consts = make("1080p", RADII[radius], 2, pre)
    plan = consts.plan
    got = h_replay(plan)
    for x in range(plan.w):
        assert got[x] == twin_terms(plan.w, plan.r, x), f"column {x}"
    for nq in strip_quads(plan):
        got, blocked = v_replay(plan, nq)
        for y in range(plan.h):
            want = [(term, int(plan.ydist[row])) for term, row in twin_terms(plan.h, plan.r, y)]
            assert got[y] == want, f"row {y}, strips of {nq} quads"
        assert blocked * BR > (plan.h - 2 * plan.r) // 2


@pytest.mark.parametrize("pre", [True, False], ids=["u8_input", "f32_input"])
@pytest.mark.parametrize("px", [1, 2])
@pytest.mark.parametrize("shape,radius", [
    (shape, radius) for shape in sorted(SHAPES) for radius in sorted(RADII)
    if (shape, radius) != ("1080p", "r_past_h")])  # that one splits
def test_inner_rows_read_their_taps_from_the_first_column(shape, radius, px, pre):
    """rowtab[y][1 + k] == rowtab[y + k - r][0] for every inner row: the
    tap rows and the composite's row share one ring slot per distinct row,
    so the blocked walk reads its offsets from rowtab's first column."""
    _, consts = make(shape, RADII[radius], px, pre)
    plan = consts.plan
    tab, r = plan.rowtab, plan.r
    inner = np.arange(r, plan.h - r)
    for k in range(2 * r + 1):
        np.testing.assert_array_equal(tab[inner, 1 + k], tab[inner + k - r, 0])


def smem_at(spec, consts, sw, step, run):
    """plan_smem of the spec's plan rebuilt at strip width sw and walk
    (step, run): what fused_plan weighs for each candidate strip."""
    keep = (kfused.STRIP_WIDTHS, dict(kfused.WALK))
    try:
        kfused.STRIP_WIDTHS = (sw,)
        kfused.WALK["big", spec.pre] = kfused.WALK["gaussian", spec.pre] = (step, run)
        plan = kfused.fused_plan(spec, consts.y_map.numpy(), consts.x_maps.numpy())
    finally:
        kfused.STRIP_WIDTHS, kfused.WALK = keep
    return None if plan.split else plan.smem


# (H, W), sigma, pixel size, input -> the strip width the plan gives and
# whether it leaves room for two blocks per SM (LUT-exact and direct-pow
# triad alike): the CLI defaults (pixel 2) at sigma 11 and 20, c4 (pixel 1)
# and c4-text (the f32 input) at sigma 11, and at 3840x2160
BIG_PLANS = {((1080, 1920), 11.0, 2, True): (32, True), ((1080, 1920), 20.0, 2, True): (32, True),
             ((1080, 1920), 11.0, 1, True): (32, True), ((1080, 1920), 11.0, 1, False): (64, False),
             ((1080, 1920), 20.0, 1, False): (32, False), ((2160, 3840), 11.0, 2, True): (32, True),
             ((2160, 3840), 20.0, 1, True): (32, False)}


@pytest.mark.parametrize("direct", [False, True], ids=["lut_exact", "direct_pow"])
@pytest.mark.parametrize("key", sorted(BIG_PLANS), ids=lambda k: f"{k[0][0]}p_s{k[1]:g}_px{k[2]}_"
                         f"{'u8' if k[3] else 'f32'}")
def test_big_plan_takes_its_walk_and_two_blocks_where_they_fit(key, direct):
    """Past MAX_R the plan walks WALK's "big" chunk and run, its shared
    memory is plan_smem of its own sizes (csrc/fused.cu smem_layout, which
    the launcher holds it to), and its strip is the widest of at least
    BIG_MIN_SW columns that leaves room for two blocks per SM, else the
    widest that fits one."""
    (h, w), sigma, px, pre = key
    spec = kfused.build_fused_spec(h, w, sigma=sigma, strength=0.25, px=px, ab=1, pre=pre,
                                   triad=True, lut_exact=not direct)
    consts = kfused.fused_consts(spec)
    p = consts.plan
    step, run = kfused.WALK["big", pre]
    assert (p.step, p.run, p.direct) == (step, min(run, h), direct) and not p.split
    assert p.smem == kfused.plan_smem(False, pre, p.r, p.sw, p.step, p.depth, p.hdepth, p.win,
                                      p.hwin, p.seg_pitch, False, direct) <= kfused.SMEM_MAX
    two = kfused.blocks_per_sm(p.smem) >= 2
    assert (p.sw, two) == BIG_PLANS[key]
    for sw in kfused.STRIP_WIDTHS:
        smem = smem_at(spec, consts, sw, step, run)
        if sw > p.sw:  # a wider strip leaves room for one block only, or fits none
            assert smem is None or (two and kfused.blocks_per_sm(smem) < 2)
        elif sw == p.sw:
            assert smem == p.smem
        elif sw >= kfused.BIG_MIN_SW and not two:  # no narrower strip gives two blocks
            assert smem is None or kfused.blocks_per_sm(smem) < 2


def test_big_walk_falls_back_to_the_gaussian_chunk_before_splitting():
    """Near the largest radius a block holds, WALK's "big" chunk fits no
    strip and the plan takes the gaussian walk's, as before the big walk
    existed; one radius more splits (tests/test_torch_fused_plan.py
    SPLIT_AT)."""
    maps = kfused.oresize.plane_index_maps(2160, 3840, 1, 1)
    spec = kfused.build_fused_spec(2160, 3840, sigma=423 / 3, strength=0.25, px=1, ab=1)
    plan = kfused.fused_plan(spec, *maps)
    assert not plan.split and (plan.step, plan.run) == kfused.WALK["gaussian", True]
    assert plan.sw == 4 and plan.smem <= kfused.SMEM_MAX
