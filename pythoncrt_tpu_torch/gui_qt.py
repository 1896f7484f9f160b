"""Qt GUI (reference crt_filter.py:1272-2349; pythoncrt_tpu/gui_qt.py).

Same surface as the reference: a main window with Open/Play/Render
toolbar, five parameter tabs (Effects / Motion / Advanced / Text /
Output), a live preview, preset save/load (reference JSON schema), and
a modal export dialog. Differences by design:

- Preview frames run through the port's CRTEngine on the window's device
  (one engine per preset and preview size, an LRU of four), with the
  preview's time-seeded grain injected through ``process_at``; within
  1 uint8 LSB of the oracle. ``PCRT_PREVIEW_ENGINE=0`` selects the NumPy
  oracle instead. A failed engine build or launch raises out of
  ``render_preview_frame``; the window shows it in the status bar and
  stops the preview. Nothing falls back to the oracle.
- Renders run pythoncrt_tpu_torch.pipeline.process_video on a worker
  thread on the window's device; the worker's progress reaches the GUI
  thread through a slot of the window (a queued connection).
- Decode uses OpenCV capture (the reference's HWPreviewReader falls
  back to the same).

This module imports PySide6 lazily; pythoncrt_tpu_torch.gui gates on
its availability.
"""

from __future__ import annotations

import dataclasses
import os
import traceback
from collections import OrderedDict
from pathlib import Path

import numpy as np

from . import oracle, perf
from .params import (
    EffectParams,
    TextParams,
    load_preset,
    load_text_preset,
    save_preset,
    save_text_preset,
)
from .text import overlay_for

PREVIEW_MAX_W, PREVIEW_MAX_H = 960, 540  # crt_filter.py:1680-1681


class PreviewReader:
    """cv2-based preview capture with restart-on-EOF
    (HWPreviewReader role, crt_filter.py:1275-1341)."""

    def __init__(self, path: str) -> None:
        import cv2

        self._cv2 = cv2
        self.path = path
        self.cap = cv2.VideoCapture(path)
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS) or 24.0)
        self.duration = (
            float(self.cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0) / self.fps
            if self.fps > 0
            else 0.0
        )
        self.size = (
            int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        )

    def frame_at(self, t_sec: float):
        cv2 = self._cv2
        self.cap.set(cv2.CAP_PROP_POS_MSEC, max(0.0, t_sec) * 1000.0)
        ok, bgr = self.cap.read()
        if not ok:
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
            ok, bgr = self.cap.read()
            if not ok:
                return None
        return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)

    def read_next(self):
        cv2 = self._cv2
        ok, bgr = self.cap.read()
        if not ok:
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
            ok, bgr = self.cap.read()
            if not ok:
                return None
        return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)

    def close(self) -> None:
        self.cap.release()


def _preview_size(w: int, h: int) -> tuple[int, int]:
    scale = min(PREVIEW_MAX_W / max(1, w), PREVIEW_MAX_H / max(1, h), 1.0)
    return max(1, int(w * scale)), max(1, int(h * scale))


# One CRTEngine per (params, preview size, device) renders the live
# preview; an LRU of a few presets. A preset change builds an engine
# (host tables; the CUDA library is built once per process), then ticks
# run at the device's rate.
_PREVIEW_ENGINES: "OrderedDict[tuple, object]" = OrderedDict()
_PREVIEW_ENGINES_MAX = 4


def _get_preview_engine(p: EffectParams, pw: int, ph: int, device):
    # persistence stays on the HOST side (oracle.persistence_blend): the
    # preview blends and carries across arbitrary wall-clock ticks and
    # size changes (crt_filter.py:689-693), which the engine's step
    # refuses (PARITY.md). The cache keys on the persistence-zeroed
    # params, so persistence-slider moves are hits, not builds.
    pe = dataclasses.replace(p, persistence=0.0)
    key = (repr(dataclasses.asdict(pe)), pw, ph, str(device))
    if key in _PREVIEW_ENGINES:
        _PREVIEW_ENGINES.move_to_end(key)
        return _PREVIEW_ENGINES[key]
    from .engine import CRTEngine

    eng = CRTEngine(pe, ph, pw, fps=30.0, engine="preview", rng="host",
                    text_rgba=overlay_for(pw, ph, p.text), device=device)
    if len(_PREVIEW_ENGINES) >= _PREVIEW_ENGINES_MAX:
        _PREVIEW_ENGINES.popitem(last=False)
    _PREVIEW_ENGINES[key] = eng
    return eng


def render_preview_frame(
    frame: np.ndarray, p: EffectParams, t: float,
    prev_img: np.ndarray | None = None, stateful: bool = False, device="cuda",
) -> tuple[np.ndarray, np.ndarray | None]:
    """Preview-path frame computation, Qt-free so it is testable on
    headless hosts (reference on_tick :1810-1852 / paused preview
    :1958-2017): fit-downscale, effect chain with time-seeded grain,
    optional stateful persistence. Returns (uint8 out, new persistence
    state or None).

    The effect chain runs through a preview-sized CRTEngine on
    ``device`` (the preview glitch, the injected grain; <= 1 LSB against
    the oracle), or through the oracle when ``PCRT_PREVIEW_ENGINE`` is
    "0". Persistence blends on the host; the engine's output is quantized
    to uint8 before that blend (a <= 1-LSB-class preview-only deviation;
    the export path is untouched). An engine failure raises.

    Each step of the engine path runs in a ``perf.span`` range
    ("preview.<step>"), which scripts/port_preview_profile.py reads."""
    h, w = frame.shape[:2]
    pw, ph = _preview_size(w, h)
    with perf.span("preview.fit"):
        if (pw, ph) != (w, h):
            import cv2

            frame = cv2.resize(frame, (pw, ph), interpolation=cv2.INTER_LINEAR)
    phase = t * p.scanline_speed_px_s
    with perf.span("preview.grain"):
        noise = (
            np.random.default_rng(int(t * 1000)).standard_normal(
                (max(1, ph // p.grain_size), max(1, pw // p.grain_size)),
                dtype=np.float32,
            )
            if p.noise_on
            else None
        )
    shown = None
    if os.environ.get("PCRT_PREVIEW_ENGINE") != "0":
        with perf.span("preview.engine"):
            eng = _get_preview_engine(p, pw, ph, device)
            out, _ = eng.process_at(
                frame[None], np.asarray([t], np.float64),
                None if noise is None else noise[None])
        with perf.span("preview.d2h"):
            # the engine's uint8 frame is what to_uint8(frame / 255) gives
            # back, so it is shown as it is; the f32 copy is only the carry
            shown = out[0].cpu().numpy()
            img = shown.astype(np.float32) / 255.0 if stateful else None
    else:
        img = oracle.apply_effects(
            frame, p, phase_px=phase, time_sec=t, noise_field=noise,
            text_rgba=overlay_for(pw, ph, p.text), engine="preview",
        )
    new_prev = None
    if stateful:
        if p.persistence_on:
            with perf.span("preview.blend"):
                # a resolution change mid-preview resizes the carried state
                # (persistence_blend matches crt_filter.py:689-693)
                img = oracle.persistence_blend(prev_img, img, p.persistence)
            shown = None
        # the reference's preview returns the current frame as state even
        # at persistence 0 (crt_filter.py:687-694), so toggling
        # persistence off for a tick blends the next tick against the
        # latest frame instead of wiping or freezing the carry
        new_prev = img
    if shown is None:
        with perf.span("preview.to_uint8"):
            shown = oracle.ops.to_uint8(img)
    return shown, new_prev


# ---------------------------------------------------------------------------
# Declarative effect-control wiring (Qt-free, so the widget<->EffectParams
# map is testable on headless hosts — tests/test_torch_gui.py asserts it
# covers the parameter surface and that ranges contain the CLI clamps).
# Rows: (widget attr, EffectParams field, tab, label, kind, lo, hi, step,
# default) — kind "f" = DoubleSpinBox, "i" = SpinBox, "b" = CheckBox;
# default None reads EffectParams()'s value; the one explicit default is
# the documented GUI deviation (scanline speed 60 vs CLI 30,
# crt_filter.py:1493 vs :1177).
EFFECT_CONTROLS = (
    ("scanline_val", "scanline_strength", "Effects", "Scanlines", "f", 0, 1, 0.01, None),
    ("triad_val", "triad_strength", "Effects", "Triad", "f", 0, 1, 0.01, None),
    ("triad_gamma", "triad_gamma", "Effects", "Triad gamma", "f", 0.1, 5, 0.01, None),
    ("triad_softness", "triad_softness", "Effects", "Triad softness", "f", 0, 5, 0.01, None),
    ("triad_preserve_luma", "triad_preserve_luma", "Effects", "Preserve luma", "b", None, None, None, None),
    ("pixel_size", "pixel_size", "Effects", "Pixel size", "i", 1, 16, None, None),
    ("aberration", "aberration_px", "Effects", "Aberration px", "i", -8, 8, None, None),
    ("noise_val", "noise_strength", "Effects", "Noise", "f", 0, 50, 0.5, None),
    ("bloom_sigma", "bloom_sigma", "Effects", "Bloom sigma", "f", 0, 10, 0.01, None),
    ("bloom_strength", "bloom_strength", "Effects", "Bloom strength", "f", 0, 2, 0.01, None),
    ("bloom_threshold", "bloom_threshold", "Effects", "Bloom threshold", "f", 0, 1, 0.01, None),
    ("vignette_val", "vignette_strength", "Effects", "Vignette", "f", 0, 1, 0.01, None),
    ("fast_bloom_cb", "fast_bloom", "Effects", "Fast bloom", "b", None, None, None, None),
    ("persistence_val", "persistence", "Motion", "Persistence", "f", 0, 0.95, 0.01, None),
    ("scanline_speed", "scanline_speed_px_s", "Motion", "Scanline speed", "f", -1000, 1000, 1.0, 60.0),
    ("scanline_period", "scanline_period_px", "Motion", "Scanline period", "f", 1, 100, 0.5, None),
    ("glitch_amp", "glitch_amp_px", "Motion", "Glitch amp", "i", 0, 64, None, None),
    ("glitch_height", "glitch_height_frac", "Motion", "Glitch height", "f", 0, 1, 0.01, None),
    ("flicker_strength", "flicker_strength", "Motion", "Flicker", "f", 0, 1, 0.01, None),
    ("flicker_hz", "flicker_hz", "Motion", "Flicker Hz", "f", 0, 60, 0.5, None),
    ("brightness", "brightness", "Advanced", "Brightness", "f", -1, 1, 0.01, None),
    ("contrast", "contrast", "Advanced", "Contrast", "f", 0, 3, 0.01, None),
    ("gamma", "gamma", "Advanced", "Gamma", "f", 0.1, 3, 0.01, None),
    ("saturation", "saturation", "Advanced", "Saturation", "f", 0, 3, 0.01, None),
    ("temperature", "temperature", "Advanced", "Temperature", "f", -1, 1, 0.01, None),
    ("grain_size", "grain_size", "Advanced", "Grain size", "i", 1, 8, None, None),
    ("scanline_angle", "scanline_angle", "Advanced", "Scanline angle", "f", -45, 45, 0.5, None),
    ("scanline_thickness", "scanline_thickness", "Advanced", "Scanline thickness", "f", 0.1, 4, 0.01, None),
    ("warp_strength", "warp_strength", "Advanced", "Warp", "f", -1, 1, 0.01, None),
)

EFFECT_TABS = ("Effects", "Motion", "Advanced")


def run_render_job(kwargs: dict, emit_progress, emit_done) -> None:
    """Qt-free core of RenderWorker.run (testable headless): drive the
    port's process_video (kwargs carry the window's device) with a
    progress callback; report (ok, message) once.
    Exceptions become a failed done-signal, never a raise — the worker
    thread has no other channel to the status bar."""
    try:
        from .pipeline import process_video

        used_gpu = process_video(
            progress_cb=lambda v: emit_progress(float(v)), **kwargs,
        )
        emit_done(True, "Hardware encoder" if used_gpu else "CPU encoder")
    except Exception as e:  # surfaced in the status bar
        emit_done(False, str(e))


_QT_CLASSES = None


def qt_classes():
    """Import Qt and build the widget classes once (cached). Separate
    from run_app so offscreen tests can construct CRTWindow without
    entering the event loop; the module stays importable without
    PySide6 (pythoncrt_tpu_torch.gui gates on availability)."""
    global _QT_CLASSES
    if _QT_CLASSES is not None:
        return _QT_CLASSES
    from PySide6 import QtCore, QtGui, QtWidgets

    class ExportDialog(QtWidgets.QDialog):
        """Output path, size/fps (0 = keep), HW-encode checkbox
        (crt_filter.py:1343-1392)."""

        def __init__(self, parent=None):
            super().__init__(parent)
            self.setWindowTitle("Export")
            form = QtWidgets.QFormLayout(self)
            self.path_edit = QtWidgets.QLineEdit(str(Path.cwd() / "out_crt.mp4"))
            browse = QtWidgets.QPushButton("…")
            browse.clicked.connect(self._browse)
            row = QtWidgets.QHBoxLayout()
            row.addWidget(self.path_edit)
            row.addWidget(browse)
            form.addRow("Output", row)
            self.width_box = QtWidgets.QSpinBox(maximum=7680)
            self.height_box = QtWidgets.QSpinBox(maximum=4320)
            self.fps_box = QtWidgets.QSpinBox(maximum=240)
            for b in (self.width_box, self.height_box, self.fps_box):
                b.setSpecialValueText("keep")
            form.addRow("Width", self.width_box)
            form.addRow("Height", self.height_box)
            form.addRow("FPS", self.fps_box)
            self.gpu_cb = QtWidgets.QCheckBox("Hardware encoder")
            form.addRow(self.gpu_cb)
            bb = QtWidgets.QDialogButtonBox(
                QtWidgets.QDialogButtonBox.Ok | QtWidgets.QDialogButtonBox.Cancel
            )
            bb.accepted.connect(self.accept)
            bb.rejected.connect(self.reject)
            form.addRow(bb)

        def _browse(self):
            path, _ = QtWidgets.QFileDialog.getSaveFileName(
                self, "Output video", self.path_edit.text(), "Video (*.mp4)"
            )
            if path:
                self.path_edit.setText(path)

    class RenderWorker(QtCore.QObject):
        progress = QtCore.Signal(float)
        done = QtCore.Signal(bool, str)

        def __init__(self, kwargs: dict):
            super().__init__()
            self.kwargs = kwargs

        @QtCore.Slot()
        def run(self):
            # Qt-free core (run_render_job) so the success/failure signal
            # plumbing is testable without PySide6
            run_render_job(self.kwargs, self.progress.emit, self.done.emit)

    class CRTWindow(QtWidgets.QMainWindow):
        def __init__(self, device="cuda"):
            super().__init__()
            self.setWindowTitle("PythonCRT (CUDA)")
            self.device = device  # the preview's and the render's
            self.reader: PreviewReader | None = None
            self.t = 0.0
            self.prev_img = None  # persistence state (float32)
            self._render_thread = None
            self._build_ui()
            self._defaults = self._collect_settings()
            self.timer = QtCore.QTimer(self)
            self.timer.timeout.connect(self.on_tick)

        # ---------------- UI construction ----------------

        def _slider(self, lo, hi, val, step=0.01):
            box = QtWidgets.QDoubleSpinBox()
            box.setRange(lo, hi)
            box.setSingleStep(step)
            box.setValue(val)
            box.valueChanged.connect(self._render_current_frame)
            return box

        def _ispin(self, lo, hi, val):
            box = QtWidgets.QSpinBox()
            box.setRange(lo, hi)
            box.setValue(val)
            box.valueChanged.connect(self._render_current_frame)
            return box

        def _check(self, val):
            cb = QtWidgets.QCheckBox()
            cb.setChecked(val)
            cb.toggled.connect(self._render_current_frame)
            return cb

        def _build_ui(self):
            tb = self.addToolBar("Main")
            tb.setMovable(False)
            for name, slot in (
                ("Open", self.on_open),
                ("Play", self.on_play),
                ("Render", self.on_render),
                ("Reset", self.on_reset),
                ("Save Preset", self.on_save_preset),
                ("Load Preset", self.on_load_preset),
            ):
                act = QtGui.QAction(name, self)
                act.triggered.connect(slot)
                tb.addAction(act)

            d = EffectParams()
            tabs = QtWidgets.QTabWidget()
            tabs.setFixedWidth(420)  # crt_filter.py sidebar width

            # parameter tabs from the declarative table (EFFECT_CONTROLS)
            # so the widget<->EffectParams wiring is data, tested Qt-free
            forms = {}
            for tab in EFFECT_TABS:
                forms[tab] = QtWidgets.QFormLayout()
            for attr, field, tab, label, kind, lo, hi, step, dflt in \
                    EFFECT_CONTROLS:
                val = getattr(d, field) if dflt is None else dflt
                if kind == "f":
                    wdg = self._slider(lo, hi, val, step)
                elif kind == "i":
                    wdg = self._ispin(lo, hi, val)
                else:
                    wdg = self._check(val)
                setattr(self, attr, wdg)
                forms[tab].addRow(label, wdg)
            for tab in EFFECT_TABS:
                tw = QtWidgets.QWidget(); tw.setLayout(forms[tab])
                tabs.addTab(tw, tab)

            tx = QtWidgets.QFormLayout()
            self.text_input = QtWidgets.QLineEdit()
            self.text_input.textChanged.connect(self._render_current_frame)
            self.text_font_path = QtWidgets.QLineEdit()
            # typing a font path refreshes the preview like every other
            # text field (Browse… refreshes via on_browse_font)
            self.text_font_path.textChanged.connect(self._render_current_frame)
            self.text_size = self._ispin(4, 256, 36)
            self.text_color = QtWidgets.QLineEdit("#FFFFFF")
            self.text_color.textChanged.connect(self._render_current_frame)
            self.text_x = self._ispin(0, 7680, 32)
            self.text_y = self._ispin(0, 4320, 32)
            self.text_after = self._check(True)  # GUI default True (crt_filter.py:1443)
            browse_font = QtWidgets.QPushButton("Browse font…")
            browse_font.clicked.connect(self.on_browse_font)
            save_tp = QtWidgets.QPushButton("Save text preset")
            save_tp.clicked.connect(self.on_save_text_preset)
            load_tp = QtWidgets.QPushButton("Load text preset")
            load_tp.clicked.connect(self.on_load_text_preset)
            for label, wdg in (
                ("Text", self.text_input), ("Font path", self.text_font_path),
                ("Size", self.text_size), ("Color", self.text_color),
                ("X", self.text_x), ("Y", self.text_y), ("After effects", self.text_after),
            ):
                tx.addRow(label, wdg)
            tx.addRow(browse_font)
            tx.addRow(save_tp)
            tx.addRow(load_tp)
            tx_w = QtWidgets.QWidget(); tx_w.setLayout(tx)
            tabs.addTab(tx_w, "Text")

            out = QtWidgets.QFormLayout()
            self.crf_val = self._ispin(12, 28, 18)
            self.bitrate_kbps = self._ispin(0, 100000, 0)
            self.nvenc_preset = QtWidgets.QLineEdit("p4")
            self.gpu_cb = self._check(False)
            self.encoder_choice = QtWidgets.QComboBox()
            self.encoder_choice.addItems(["auto", "nvidia", "amd", "cpu"])
            self.decoder_choice = QtWidgets.QComboBox()
            self.decoder_choice.addItems(["auto", "nvidia", "amd", "intel", "cpu"])
            self.batch_size = self._ispin(1, 256, 16)
            for label, wdg in (
                ("CRF", self.crf_val), ("Bitrate kbps", self.bitrate_kbps),
                ("NVENC preset", self.nvenc_preset), ("HW encode", self.gpu_cb),
                ("Encoder", self.encoder_choice), ("Decoder", self.decoder_choice),
                ("Batch size", self.batch_size),
            ):
                out.addRow(label, wdg)
            out_w = QtWidgets.QWidget(); out_w.setLayout(out)
            tabs.addTab(out_w, "Output")

            self.video_label = QtWidgets.QLabel("Open a video to begin")
            self.video_label.setAlignment(QtCore.Qt.AlignCenter)
            self.video_label.setMinimumSize(640, 360)

            central = QtWidgets.QWidget()
            lay = QtWidgets.QHBoxLayout(central)
            lay.addWidget(tabs)
            lay.addWidget(self.video_label, stretch=1)
            self.setCentralWidget(central)

            self.status = self.statusBar()
            self.progress = QtWidgets.QProgressBar()
            self.progress.setMaximumWidth(220)
            self.progress.setVisible(False)
            self.status.addPermanentWidget(self.progress)

        # ---------------- parameter plumbing ----------------

        def current_params(self) -> EffectParams:
            kw = {}
            for attr, field, _tab, _lbl, kind, *_ in EFFECT_CONTROLS:
                w = getattr(self, attr)
                kw[field] = w.isChecked() if kind == "b" else w.value()
            return EffectParams(
                **kw,
                text=TextParams(
                    text=self.text_input.text(),
                    font=self.text_font_path.text(),
                    size=self.text_size.value(),
                    color=self.text_color.text(),
                    x=self.text_x.value(),
                    y=self.text_y.value(),
                    after=self.text_after.isChecked(),
                ),
            ).clamped()

        def _collect_settings(self) -> dict:
            p = self.current_params()
            return p.to_preset_dict(
                crf=self.crf_val.value(),
                bitrate_kbps=self.bitrate_kbps.value(),
                nvenc_preset=self.nvenc_preset.text(),
                gpu=self.gpu_cb.isChecked(),
                encoder=self.encoder_choice.currentText(),
            )

        def _apply_settings(self, s: dict) -> None:
            p = EffectParams.from_preset_dict(s, self.current_params())
            # block per-widget change signals for the whole batch: each
            # setValue would otherwise trigger a full preview render of
            # a half-applied param mix (and a throwaway engine build per
            # intermediate combo)
            widgets = [getattr(self, attr)
                       for attr, *_ in EFFECT_CONTROLS]
            widgets += [self.crf_val, self.bitrate_kbps,
                        self.nvenc_preset, self.gpu_cb, self.encoder_choice]
            for w in widgets:
                w.blockSignals(True)
            try:
                for attr, field, _tab, _lbl, kind, *_ in EFFECT_CONTROLS:
                    w = getattr(self, attr)
                    if kind == "b":
                        w.setChecked(bool(getattr(p, field)))
                    elif kind == "i":
                        w.setValue(int(getattr(p, field)))
                    else:
                        w.setValue(float(getattr(p, field)))
                if "crf" in s:
                    self.crf_val.setValue(int(s["crf"]))
                if "bitrate_kbps" in s:
                    self.bitrate_kbps.setValue(int(s["bitrate_kbps"]))
                if "nvenc_preset" in s:
                    self.nvenc_preset.setText(str(s["nvenc_preset"]))
                if "gpu" in s:
                    self.gpu_cb.setChecked(bool(s["gpu"]))
                if "encoder" in s:
                    idx = self.encoder_choice.findText(str(s["encoder"]).lower())
                    self.encoder_choice.setCurrentIndex(max(0, idx))
            finally:
                for w in widgets:
                    w.blockSignals(False)
            self._render_current_frame()

        # ---------------- preview ----------------

        def _apply_preview(self, frame: np.ndarray, stateful: bool):
            """The preview frame, or None when rendering it failed: the
            error goes to the status bar and the timer stops (raising in
            the timer's slot would fail again every tick)."""
            try:
                out, new_prev = render_preview_frame(
                    frame, self.current_params(), self.t,
                    prev_img=self.prev_img, stateful=stateful,
                    device=self.device,
                )
            except Exception as e:  # surfaced in the status bar
                traceback.print_exc()
                self.timer.stop()
                self.status.showMessage(f"Preview failed: {e}")
                return None
            if stateful:
                self.prev_img = new_prev
            return out

        def _show(self, rgb_u8: np.ndarray) -> None:
            h, w = rgb_u8.shape[:2]
            # hold the contiguous buffer in a local until after copy():
            # QImage does not own the Python buffer, and a temp from
            # ascontiguousarray would be freed before the copy reads it
            buf = np.ascontiguousarray(rgb_u8)
            qimg = QtGui.QImage(
                buf.data, w, h, 3 * w, QtGui.QImage.Format_RGB888,
            )
            self.video_label.setPixmap(QtGui.QPixmap.fromImage(qimg.copy()))
            del qimg, buf
            mins, secs = divmod(int(self.t), 60)
            self.status.showMessage(f"{mins:02d}:{secs:02d}")

        def _render_current_frame(self, *_):
            if self.reader is None:
                return
            frame = self.reader.frame_at(self.t)
            if frame is None:
                return
            self.prev_img = None  # paused preview is stateless (crt_filter.py:1984)
            out = self._apply_preview(frame, stateful=False)
            if out is not None:
                self._show(out)

        def on_tick(self):
            if self.reader is None:
                return
            frame = self.reader.read_next()
            if frame is None:
                return
            out = self._apply_preview(frame, stateful=True)
            if out is None:
                return
            self._show(out)
            self.t += 1.0 / max(1.0, self.reader.fps)
            if self.reader.duration and self.t >= self.reader.duration:
                self.t = 0.0

        # ---------------- actions ----------------

        def on_open(self):
            path, _ = QtWidgets.QFileDialog.getOpenFileName(
                self, "Open video", str(Path.cwd()),
                "Video (*.mp4 *.mov *.avi *.mkv *.webm);;All files (*)",
            )
            if not path:
                return
            if self.reader is not None:
                self.reader.close()
            self.reader = PreviewReader(path)
            self.t = 0.0
            self.prev_img = None
            self._render_current_frame()
            self.status.showMessage(f"Opened {Path(path).name}")

        def on_play(self):
            if self.reader is None:
                return
            if self.timer.isActive():
                self.timer.stop()
            else:
                self.timer.start(int(1000.0 / max(1.0, self.reader.fps)))

        def on_reset(self):
            self._apply_settings(self._defaults)

        def on_save_preset(self):
            path, _ = QtWidgets.QFileDialog.getSaveFileName(
                self, "Save Preset", str(Path.cwd() / "preset.json"), "JSON (*.json)"
            )
            if not path:
                return
            try:
                save_preset(
                    path, self.current_params(),
                    crf=self.crf_val.value(), bitrate_kbps=self.bitrate_kbps.value(),
                    nvenc_preset=self.nvenc_preset.text(), gpu=self.gpu_cb.isChecked(),
                    encoder=self.encoder_choice.currentText(),
                )
                self.status.showMessage("Preset saved")
            except OSError as e:
                QtWidgets.QMessageBox.critical(self, "Error", f"Failed to save preset:\n{e}")

        def on_load_preset(self):
            path, _ = QtWidgets.QFileDialog.getOpenFileName(
                self, "Load Preset", str(Path.cwd()), "JSON (*.json)"
            )
            if not path:
                return
            try:
                _, raw = load_preset(path)
                self._apply_settings(raw)
                self.status.showMessage("Preset loaded")
            except (OSError, ValueError) as e:
                QtWidgets.QMessageBox.critical(self, "Error", f"Failed to load preset:\n{e}")

        def on_browse_font(self):
            path, _ = QtWidgets.QFileDialog.getOpenFileName(
                self, "Choose Font", str(Path.cwd()), "Fonts (*.ttf *.otf)"
            )
            if path:
                self.text_font_path.setText(path)
                self._render_current_frame()

        def on_save_text_preset(self):
            path, _ = QtWidgets.QFileDialog.getSaveFileName(
                self, "Save Text Preset", str(Path.cwd() / "text_preset.json"),
                "JSON (*.json)",
            )
            if not path:
                return
            try:
                save_text_preset(path, self.current_params().text)
                self.status.showMessage("Text preset saved")
            except OSError as e:
                QtWidgets.QMessageBox.critical(self, "Error", f"Failed to save text preset:\n{e}")

        def on_load_text_preset(self):
            path, _ = QtWidgets.QFileDialog.getOpenFileName(
                self, "Load Text Preset", str(Path.cwd()), "JSON (*.json)"
            )
            if not path:
                return
            try:
                t = load_text_preset(path)
            except (OSError, ValueError) as e:
                QtWidgets.QMessageBox.critical(self, "Error", f"Failed to load text preset:\n{e}")
                return
            widgets = [self.text_input, self.text_font_path, self.text_size,
                       self.text_color, self.text_x, self.text_y,
                       self.text_after]
            for w in widgets:  # one preview render for the batch, not 7
                w.blockSignals(True)
            try:
                self.text_input.setText(t.text)
                self.text_font_path.setText(t.font)
                self.text_size.setValue(t.size)
                self.text_color.setText(t.color)
                self.text_x.setValue(t.x)
                self.text_y.setValue(t.y)
                self.text_after.setChecked(t.after)
            finally:
                for w in widgets:
                    w.blockSignals(False)
            self._render_current_frame()
            self.status.showMessage("Text preset loaded")

        def on_render(self):
            if self.reader is None:
                self.status.showMessage("Open a video first")
                return
            dlg = ExportDialog(self)
            # seed from the Output tab; the dialog's checkbox then WINS
            # (an OR could enable but never disable hardware encode)
            dlg.gpu_cb.setChecked(self.gpu_cb.isChecked())
            if dlg.exec() != QtWidgets.QDialog.Accepted:
                return
            # preview ticks must not contend with the export for the card
            self.timer.stop()
            kwargs = dict(
                input_path=self.reader.path,
                output_path=dlg.path_edit.text(),
                params=self.current_params(),
                width=dlg.width_box.value() or None,
                height=dlg.height_box.value() or None,
                fps=dlg.fps_box.value() or None,
                crf=self.crf_val.value(),
                target_bitrate_kbps=self.bitrate_kbps.value(),
                gpu=dlg.gpu_cb.isChecked(),
                nvenc_preset=self.nvenc_preset.text(),
                encoder_preference=self.encoder_choice.currentText(),
                decoder_preference=self.decoder_choice.currentText(),
                batch_size=self.batch_size.value(),
                engine_mode="export",
                report=False,
                device=self.device,
            )
            self.setEnabled(False)
            self.progress.setVisible(True)
            self.progress.setValue(0)
            self._render_thread = QtCore.QThread(self)
            self._worker = RenderWorker(kwargs)
            self._worker.moveToThread(self._render_thread)
            self._render_thread.started.connect(self._worker.run)
            # a slot of the window, which lives in the GUI thread: Qt queues
            # the worker thread's emits to it (crt_filter.py:1894-1895),
            # where a plain callable would touch the widget off that thread
            self._worker.progress.connect(self._on_render_progress)
            self._worker.done.connect(self._on_render_done)
            self._render_thread.start()

        @QtCore.Slot(float)
        def _on_render_progress(self, v: float):
            self.progress.setValue(int(v * 100))

        @QtCore.Slot(bool, str)
        def _on_render_done(self, ok: bool, msg: str):
            self._render_thread.quit()
            self._render_thread.wait()
            self.setEnabled(True)
            self.progress.setVisible(False)
            self.status.showMessage(("Render done — " + msg) if ok else ("Render failed: " + msg))

        def closeEvent(self, e):
            th = getattr(self, "_render_thread", None)
            if th is not None and th.isRunning():
                # destroying a running QThread aborts the process and
                # leaves a truncated export; refuse the close instead
                self.status.showMessage(
                    "Render in progress — wait for it to finish")
                e.ignore()
                return
            try:
                self.timer.stop()
                if self.reader is not None:
                    self.reader.close()
            except Exception:
                pass
            super().closeEvent(e)

    import types

    _QT_CLASSES = types.SimpleNamespace(
        QtCore=QtCore, QtGui=QtGui, QtWidgets=QtWidgets,
        ExportDialog=ExportDialog, RenderWorker=RenderWorker,
        CRTWindow=CRTWindow,
    )
    return _QT_CLASSES


def run_app(device="cuda") -> int:
    c = qt_classes()
    QtGui, QtWidgets = c.QtGui, c.QtWidgets
    app = QtWidgets.QApplication.instance() or QtWidgets.QApplication([])
    app.setStyle("Fusion")
    # dark palette (crt_filter.py:2309-2346)
    pal = QtGui.QPalette()
    for role, color in (
        (QtGui.QPalette.Window, (37, 37, 38)),
        (QtGui.QPalette.WindowText, (212, 212, 212)),
        (QtGui.QPalette.Base, (30, 30, 30)),
        (QtGui.QPalette.AlternateBase, (45, 45, 48)),
        (QtGui.QPalette.Text, (212, 212, 212)),
        (QtGui.QPalette.Button, (45, 45, 48)),
        (QtGui.QPalette.ButtonText, (212, 212, 212)),
        (QtGui.QPalette.Highlight, (0, 122, 204)),
        (QtGui.QPalette.HighlightedText, (255, 255, 255)),
    ):
        pal.setColor(role, QtGui.QColor(*color))
    app.setPalette(pal)
    # Widget stylesheet covering the reference's styled classes
    # (crt_filter.py:2319-2345): dark chrome, rounded controls, accent
    # highlight — same widget coverage, this app's own values.
    app.setStyleSheet("""
    QMainWindow { background: #1b1b1e; }
    QLabel { color: #d4d4d4; }
    QTabBar::tab { background: #232327; color: #c8c8cc; padding: 7px 12px;
                   border: 1px solid #303036; border-bottom: none;
                   border-top-left-radius: 5px; border-top-right-radius: 5px; }
    QTabBar::tab:selected { background: #2b2b31; color: #e8e8e8; }
    QTabWidget::pane { border: 1px solid #303036; top: -1px; }
    QPushButton { color: #e0e0e0; background: #2d2d32; padding: 7px 13px;
                  border: 1px solid #3c3c44; border-radius: 7px; }
    QPushButton:hover { background: #36363d; }
    QPushButton:pressed { background: #222228; }
    QSlider::groove:horizontal { height: 6px; background: #2d2d32;
                                 border-radius: 3px; }
    QSlider::handle:horizontal { background: #007acc; width: 15px;
                                 margin: -5px 0; border-radius: 7px; }
    QSpinBox, QDoubleSpinBox, QLineEdit { background: #232327; color: #e0e0e0;
        border: 1px solid #3c3c44; border-radius: 5px; padding: 4px 6px; }
    QCheckBox { color: #c8c8cc; }
    QStatusBar { background: #202024; color: #c8c8cc; }
    """)
    win = c.CRTWindow(device=device)
    win.resize(1280, 760)
    win.show()
    return app.exec()
