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
staged window, and hold them to the ones the plain twin reads."""

import numpy as np
import pytest

from pythoncrt_tpu_torch.kernels import bloom2 as kbloom2
from pythoncrt_tpu_torch.kernels import bloom_walk as kwalk

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
        xring = np.full(plan.xdepth, -1)
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
