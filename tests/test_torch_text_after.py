"""Stage 13, the text composited after the effects (kernels/text.py,
csrc/text.cu), on the CPU.

The twin ``composite_box_ref`` is ops/color.composite_text bit for bit:
over the box alone on a batch in [0, 1] (the box grid), over the whole
frame on any batch (the whole-frame grid), and a clear overlay leaves the
box grid's batch as it was. The kernel's walk is replayed at index level
from its launch plan (``text_plan``): every value of the box, or of the
frame, taken by one thread once, by the composite inside the box and the
clip outside it, its 16-byte accesses aligned. The engine finds the same
box and crops for text after the effects as for text before the bloom,
picks the whole-frame grid exactly when the warp feeds stage 13, and its
step is the step with stage 13 as composite_text over the whole frame, on
every route that reaches stage 13."""

import numpy as np
import pytest
import torch

from pythoncrt_tpu_torch import CRTEngine, EffectParams, TextParams
from pythoncrt_tpu_torch.kernels import text as ktext
from pythoncrt_tpu_torch.ops import color as ocolor

from conftest import synth_frames
from test_torch_engine import C4

H, W, B = 20, 37, 2

# (y0, y1, x0, x1) boxes in an H x W frame: at each edge and corner, the
# whole frame, x0 and the width off multiples of 4, one pixel
BOXES = {"inner": (5, 12, 9, 30), "top_left": (0, 6, 0, 11), "bottom_right": (14, 20, 26, 37),
         "left": (3, 17, 0, 5), "right": (2, 9, 31, 37), "top": (0, 1, 4, 33),
         "bottom": (19, 20, 0, 37), "whole": (0, 20, 0, 37), "aligned": (4, 10, 8, 24),
         "x0_1_w_6": (7, 9, 1, 7), "x0_3_w_9": (1, 18, 3, 12), "pixel": (11, 12, 17, 18),
         "pixel_at_0": (0, 1, 0, 1), "column": (0, 20, 22, 23)}


def overlay(box, h=H, w=W, seed=1, hollow=False):
    """(H, W) alpha and (3, H, W) colour, u8 / 255 in f32, non-zero alpha
    bounded by ``box``, with clear rows and columns inside it (all of its
    inside when ``hollow``)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((h, w), np.float32)
    y0, y1, x0, x1 = box
    a[y0:y1, x0:x1] = rng.integers(0, 256, (y1 - y0, x1 - x0)) / np.float32(255.0)
    if y1 - y0 > 2:
        a[y0 + 1] = 0.0  # a clear row inside the box
    if x1 - x0 > 2:
        a[:, x0 + 1] = 0.0  # a clear column
    if hollow:
        a[y0 + 1:y1 - 1, x0 + 1:x1 - 1] = 0.0
    a[y0, x0] = a[y1 - 1, x1 - 1] = 1.0  # the box bounds the alpha
    a[y0, x1 - 1] = 0.5
    rgb = rng.integers(0, 256, (3, h, w)) / np.float32(255.0)
    return torch.from_numpy(a), torch.from_numpy(rgb.astype(np.float32))


def batch(seed=2, b=B, h=H, w=W, planted=False):
    """(B, 3, H, W) f32 in [0, 1] with exact 0s and 1s; ``planted``: values
    outside it too (-0.5, 1 + 2^-23, 3.0), as an unclamped sum gives."""
    rng = np.random.default_rng(seed)
    x = rng.random((b, 3, h, w), dtype=np.float32)
    x[rng.random(x.shape) < 0.05] = 0.0
    x[rng.random(x.shape) < 0.05] = 1.0
    if planted:
        for v in (-0.5, np.float32(1.0) + np.float32(2.0 ** -23), 3.0):
            x[rng.random(x.shape) < 0.1] = v
    return torch.from_numpy(x)


@pytest.mark.parametrize("hollow", [False, True], ids=["seeded", "hollow"])
@pytest.mark.parametrize("name", sorted(BOXES))
def test_box_twin_is_composite_text(name, hollow):
    alpha, rgb = overlay(BOXES[name], hollow=hollow)
    tb = ktext.find_box(alpha, rgb)
    assert tb.box == BOXES[name]
    img = batch()
    want = ocolor.composite_text(img, alpha, rgb)
    for whole in (False, True):
        got = img.clone()
        assert ktext.composite_box_ref(got, tb, whole) is got
        assert torch.equal(got, want), whole


@pytest.mark.parametrize("name", sorted(BOXES) + ["clear"])
def test_whole_frame_twin_is_composite_text_out_of_range(name):
    """The whole-frame grid on values off [0, 1]: composite_text bit for
    bit; the box grid leaves them as they were outside the box."""
    alpha, rgb = (overlay(BOXES[name]) if name != "clear"
                  else (torch.zeros(H, W), torch.rand(3, H, W)))
    tb = ktext.find_box(alpha, rgb)
    img = batch(planted=True)
    want = ocolor.composite_text(img, alpha, rgb)
    assert torch.equal(ktext.composite_box_ref(img.clone(), tb, True), want)
    box_only = ktext.composite_box_ref(img.clone(), tb, False)
    assert torch.equal(box_only, want) == (tb.box == (0, H, 0, W))


def test_clear_overlay_leaves_the_batch():
    alpha, rgb = torch.zeros(H, W), torch.rand(3, H, W)
    tb = ktext.find_box(alpha, rgb)
    assert tb == ktext.TextBox() and ktext.text_plan(B, H, W, (), False, True, True) is None
    img = batch()
    assert torch.equal(ktext.composite_box_ref(img.clone(), tb, False), img)
    assert torch.equal(ocolor.composite_text(img, alpha, rgb), img)


# ---- the kernel's walk, replayed at index level ------------------------

def replay(h, w, box, whole, aligned, crops_aligned):
    """csrc/text.cu's walk of one (plane, frame) under text_plan: per value
    the times a thread took it and how (1 composite, 2 clip); asserts each
    16-byte access aligned."""
    plan = ktext.text_plan(1, h, w, box, whole, aligned, crops_aligned)
    if plan is None:
        return None, np.zeros((h, w), int), np.zeros((h, w), int)
    y0, y1, x0, x1 = box or (0, 0, 0, 0)
    bw = x1 - x0
    count, how = np.zeros((h, w), int), np.zeros((h, w), int)

    def take(y, x, kind):
        count[y, x] += 1
        how[y, x] = kind

    def one(y, x):
        take(y, x, 1 if x0 <= x < x1 else 2)

    for by in range(h if whole else y1 - y0):  # csrc/text.cu's grid: a block per row
        y = by if whole else y0 + by
        for t in range(plan.tx):
            if not y0 <= y < y1:
                if plan.vec:
                    for q in range(t, w >> 2, plan.tx):
                        for k in range(4):
                            take(y, 4 * q + k, 2)
                else:
                    for x in range(t, w, plan.tx):
                        take(y, x, 2)
                continue
            xs, xe = (0, w) if whole else (x0, x1)
            va = min((xs + 3) & ~3, xe) if plan.vec else xs
            vb = max(va, xe & ~3) if plan.vec else xs
            for x in list(range(xs + t, va, plan.tx)) + list(range(vb + t, xe, plan.tx)):
                one(y, x)
            for q in range(t, (vb - va) >> 2, plan.tx):
                x = va + 4 * q
                assert (y * w + x) % 4 == 0  # the batch's 16-byte access
                if plan.cvec and x >= x0 and x + 4 <= x1:
                    assert ((y - y0) * bw + x - x0) % 4 == 0  # the crops'
                    for k in range(4):
                        take(y, x + k, 1)
                else:
                    for k in range(4):
                        one(y, x + k)
    return plan, count, how


WALK_SHAPES = [(H, W), (9, 64), (6, 1), (5, 3), (7, 1300)]


@pytest.mark.parametrize("crops_aligned", [True, False], ids=["crops16", "crops4"])
@pytest.mark.parametrize("aligned", [True, False], ids=["img16", "img4"])
@pytest.mark.parametrize("whole", [False, True], ids=["box", "whole"])
@pytest.mark.parametrize("shape", WALK_SHAPES, ids=[f"{h}x{w}" for h, w in WALK_SHAPES])
def test_walk_takes_each_value_once(shape, whole, aligned, crops_aligned):
    h, w = shape
    boxes = {(0, h, 0, w), (0, 1, 0, 1), (h - 1, h, w - 1, w), ()}
    for x0 in range(min(w, 5)):
        for bw in (1, 3, 4, 5, 8, 13):
            if x0 + bw <= w:
                boxes.add((h // 3, h // 3 + 2, x0, x0 + bw))
                boxes.add((1, h, w - bw - x0, w - x0))
    for box in sorted(boxes):
        plan, count, how = replay(h, w, box, whole, aligned, crops_aligned)
        inside = np.zeros((h, w), bool)
        if box:
            inside[box[0]:box[1], box[2]:box[3]] = True
        if plan is None:
            assert not box and not whole
            continue
        assert plan.tx % 32 == 0 and 32 <= plan.tx <= ktext.MAX_TX
        assert plan.vec == int(aligned and w % 4 == 0)
        want = inside | whole
        assert (count == want).all(), box
        assert (how[inside] == 1).all() and (how[want & ~inside] == 2).all(), box


# ---- the engine ---------------------------------------------------------

ROUTES = {  # name -> (params overrides, whole-frame grid)
    "fused": (C4, False),
    "fused_warp": ({**C4, "warp_strength": 0.2}, True),
    "staged": ({**C4, "scanline_angle": 12.0, "scanline_thickness": 2.0}, False),
    "staged_warp": ({**C4, "scanline_angle": 12.0, "scanline_thickness": 2.0,
                     "warp_strength": -0.3}, True),
    "fused_still": ({"warp_strength": 0.0, "persistence": 0.0}, False),
    "warp_still": ({"warp_strength": 0.25, "persistence": 0.0}, True),
}


def rgba(h=H, w=W, clear=False):
    ov = np.zeros((h, w, 4), np.uint8)
    if not clear:
        rng = np.random.default_rng(7)
        ov[4:13, 6:31] = rng.integers(0, 256, (9, 25, 4))
        ov[4, 6, 3] = ov[12, 30, 3] = 255
    return ov


@pytest.mark.parametrize("clear", [False, True], ids=["caption", "clear"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_engine_text_after_is_stage_13_over_the_whole_frame(route, clear, monkeypatch):
    """The engine's text after: the box and crops that text before the
    bloom finds, the whole-frame grid exactly when the warp is on, and two
    batches (state carried) bit for bit the step with stage 13 as
    composite_text over the whole batch."""
    over, whole = ROUTES[route]
    ov = rgba(clear=clear)

    def build(after):
        return CRTEngine(EffectParams(**over, text=TextParams(text="T", after=after)), H, W,
                         24.0, rng="host", seed=3, device="cpu", text_rgba=ov, layout="planar")

    eng = build(True)
    assert eng.text_route == "after" and eng.spec.text_box == () and not eng._text_box_ops
    assert eng.text_grid == ("whole" if whole else "box") and whole == eng.params.warp_on
    before = build(False)
    assert before.text_grid is None and eng._staged == before._staged
    if not before._staged:
        assert before.spec.text_box == eng._text_crops.box
    assert eng._text_crops.box == ((4, 13, 6, 31) if not clear else ())
    if not clear:
        for a, b in zip(eng._text_crops[1:], ktext.find_box(*before._text)[1:]):
            assert torch.equal(a, b)
    x = np.ascontiguousarray(np.transpose(synth_frames(2 * B, H, W, seed=5), (0, 3, 1, 2)))
    got, s = [], None
    for k in range(2):
        out, s = eng.process(x[k * B:(k + 1) * B], np.arange(k * B, (k + 1) * B), s)
        got.append(out)
    calls = []

    def whole_frame(img, tb, whole_grid):
        calls.append(whole_grid)
        return ocolor.composite_text(img, *eng._text)

    monkeypatch.setattr(ktext, "composite_after", whole_frame)
    ref = build(True)
    want, sr = [], None
    for k in range(2):
        out, sr = ref.process(x[k * B:(k + 1) * B], np.arange(k * B, (k + 1) * B), sr)
        want.append(out)
    assert calls == [whole, whole]
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(s, sr)
