"""Host-side text overlay rasterization.

The port's own copy of pythoncrt_tpu/text.py (the PIL path): the overlay
is rasterized once per (canvas size, text config) into an RGBA uint8
array, which the engine turns into f32 alpha and colour planes and
composites on the device (ops/color.composite_text), before the bloom
(stage 5) or after the warp (stage 13).

Font resolution mirrors the reference's PIL path (crt_filter.py:366-414):
explicit .ttf/.otf path -> known family map in the system font dirs ->
<family>.ttf -> arial.ttf -> PIL builtin default. PIL is imported when a
text is rasterized, not with the module; without it ``rasterize_text``
raises ImportError. ``rasterize_text_qt`` is the reference's Qt
rasterizer (the GUI's), with the PIL path where Qt or its application is
missing.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from .params import TextParams

_FAMILY_FILES = {
    "arial": "arial.ttf",
    "segoe ui": "segoeui.ttf",
    "consolas": "consola.ttf",
    "tahoma": "tahoma.ttf",
    "times new roman": "times.ttf",
    "courier new": "cour.ttf",
    "dejavu sans": "DejaVuSans.ttf",
    "dejavu sans mono": "DejaVuSansMono.ttf",
    "liberation sans": "LiberationSans-Regular.ttf",
}

_FONT_DIRS = (
    os.path.join(os.environ.get("WINDIR", "C:\\Windows"), "Fonts"),
    "/usr/share/fonts/truetype/dejavu",
    "/usr/share/fonts/truetype/liberation",
    "/usr/share/fonts/truetype",
    "/usr/share/fonts",
    "/Library/Fonts",
)


def parse_hex_color(s: str) -> Tuple[int, int, int]:
    """#RRGGBB -> (r, g, b); anything unparsable -> white (crt_filter.py:351-363)."""
    try:
        st = s.strip().lstrip("#")
        if len(st) == 6:
            return int(st[0:2], 16), int(st[2:4], 16), int(st[4:6], 16)
    except Exception:
        pass
    return 255, 255, 255


def _pil():
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError("text overlays (--text) need Pillow (PIL) to rasterize the "
                          "text, and it is not installed") from e
    return Image, ImageDraw, ImageFont


def _resolve_font(font_family: str, size: int):
    ImageFont = _pil()[2]
    if font_family and os.path.isfile(font_family):
        try:
            return ImageFont.truetype(font_family, size)
        except Exception:
            pass
    fam = (font_family or "").lower()
    candidates = []
    for d in _FONT_DIRS:
        if fam in _FAMILY_FILES:
            candidates.append(os.path.join(d, _FAMILY_FILES[fam]))
        if fam:
            candidates.append(os.path.join(d, f"{fam}.ttf"))
    candidates.append("arial.ttf")
    candidates.append("DejaVuSans.ttf")
    for path in candidates:
        try:
            if os.path.sep not in path or os.path.isfile(path):
                return ImageFont.truetype(path, size)
        except Exception:
            continue
    return ImageFont.load_default()


def rasterize_text(w: int, h: int, t: TextParams) -> np.ndarray:
    """Render ``t`` into an (h, w, 4) RGBA uint8 canvas (transparent
    background). Empty text returns an all-zero canvas."""
    if not t.text:
        return np.zeros((h, w, 4), dtype=np.uint8)
    Image, ImageDraw, _ = _pil()
    img = Image.new("RGBA", (w, h), (0, 0, 0, 0))
    draw = ImageDraw.Draw(img)
    font = _resolve_font(t.font, int(t.size))
    r, g, b = parse_hex_color(t.color)
    draw.text((int(t.x), int(t.y)), t.text, font=font, fill=(r, g, b, 255))
    return np.asarray(img, dtype=np.uint8)


def rasterize_text_qt(w: int, h: int, t: TextParams) -> np.ndarray:
    """Qt-based rasterizer (reference crt_filter.py:417-466): antialiased
    QPainter text with pixel-size fonts and bytesPerLine-aware extraction.
    Falls back to the PIL path when PySide6 is unavailable (the fallback
    the reference implements)."""
    try:
        from PySide6 import QtCore, QtGui
    except ImportError:
        return rasterize_text(w, h, t)
    if QtGui.QGuiApplication.instance() is None:
        # QPainter text / QFontDatabase without a QGuiApplication is a
        # Qt FATAL abort, not an exception: headless callers (tests,
        # CLI renders on a PySide6-equipped host) take the PIL path
        return rasterize_text(w, h, t)
    if not t.text:
        return np.zeros((h, w, 4), dtype=np.uint8)
    img = QtGui.QImage(w, h, QtGui.QImage.Format_RGBA8888)
    img.fill(QtCore.Qt.transparent)
    painter = QtGui.QPainter(img)
    try:
        painter.setRenderHints(
            QtGui.QPainter.Antialiasing
            | QtGui.QPainter.TextAntialiasing
            | QtGui.QPainter.SmoothPixmapTransform,
            True,
        )
        family = None
        if t.font and os.path.isfile(t.font):
            fid = QtGui.QFontDatabase.addApplicationFont(t.font)
            fams = QtGui.QFontDatabase.applicationFontFamilies(fid) if fid >= 0 else []
            family = fams[0] if fams else None
        if not family and t.font:
            family = t.font
        font = QtGui.QFont(family) if family else QtGui.QFont()
        font.setPixelSize(max(1, int(t.size)))
        painter.setFont(font)
        r, g, b = parse_hex_color(t.color)
        painter.setPen(QtGui.QColor(r, g, b, 255))
        painter.drawText(int(t.x), int(t.y) + (font.pixelSize() or int(t.size)), t.text)
    finally:
        painter.end()
    bpl = int(img.bytesPerLine())
    buf = bytes(img.bits())
    arr = np.frombuffer(buf, dtype=np.uint8)
    expected = bpl * h
    if arr.size < expected:
        arr = np.pad(arr, (0, expected - arr.size))
    return arr[:expected].reshape(h, bpl // 4, 4)[:, :w, :].copy()


_OVERLAY_CACHE: "OrderedDict" = OrderedDict()
_OVERLAY_CACHE_MAX = 16  # a 1080p RGBA canvas is ~8 MB; bound the set


def overlay_for(w: int, h: int, t: TextParams) -> Optional[np.ndarray]:
    """LRU-cached rasterization keyed by the full text config and canvas
    size; None when the text is off."""
    if not t.enabled:
        return None
    key = (w, h, t)
    if key in _OVERLAY_CACHE:
        _OVERLAY_CACHE.move_to_end(key)
    else:
        _OVERLAY_CACHE[key] = rasterize_text(w, h, t)
        while len(_OVERLAY_CACHE) > _OVERLAY_CACHE_MAX:
            _OVERLAY_CACHE.popitem(last=False)
    return _OVERLAY_CACHE[key]
