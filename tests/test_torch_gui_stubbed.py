"""Execute the port's Qt GUI classes (pythoncrt_tpu_torch.gui_qt.
qt_classes: ExportDialog, RenderWorker, CRTWindow, and run_app;
reference crt_filter.py:1272-2349) against the strict PySide6 behavioral
stub in tests/_qt_stub.py, as tests/test_gui_qt_stubbed.py does for the
JAX package's.

PySide6 is installed neither here nor on the card's machine, so the
window is exercised only under the stub, on device "cpu". Most tests
render the preview through the oracle (PCRT_PREVIEW_ENGINE=0, as the JAX
tests do); TestEnginePreview runs the window's ticks through the port's
engine, a preview failure, and the render's progress slot. Where real
PySide6 exists these tests step aside.
"""

from __future__ import annotations

import importlib.util
import json

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

pytestmark = pytest.mark.skipif(
    importlib.util.find_spec("PySide6") is not None,
    reason="real PySide6 present: the offscreen Qt smoke covers this",
)

import _qt_stub  # noqa: E402  (tests dir is on sys.path under pytest)
from pythoncrt_tpu_torch import gui_qt  # noqa: E402
from pythoncrt_tpu_torch.params import EffectParams  # noqa: E402


@pytest.fixture()
def qt(monkeypatch):
    """Fresh stub modules + a fresh qt_classes() build per test."""
    monkeypatch.setenv("PCRT_PREVIEW_ENGINE", "0")  # oracle preview
    mod = _qt_stub.install(monkeypatch)
    monkeypatch.setattr(gui_qt, "_QT_CLASSES", None)
    classes = gui_qt.qt_classes()
    yield classes
    gui_qt._QT_CLASSES = None


def window(qt):
    return qt.CRTWindow(device="cpu")


class FakeReader:
    """PreviewReader duck type with call counting."""

    def __init__(self, w=96, h=64, fps=24.0, duration=1.5):
        self.path = "/tmp/fake.mp4"
        self.fps = fps
        self.duration = duration
        self.size = (w, h)
        self.frame_at_calls = 0
        self.read_next_calls = 0
        self.closed = False
        yy, xx = np.mgrid[0:h, 0:w]
        self._frame = np.stack(
            [(xx * 2) % 256, (yy * 3) % 256, (xx + yy) % 256], -1
        ).astype(np.uint8)

    def frame_at(self, t_sec):
        self.frame_at_calls += 1
        return self._frame.copy()

    def read_next(self):
        self.read_next_calls += 1
        return self._frame.copy()

    def close(self):
        self.closed = True


@pytest.fixture()
def clip_path(tmp_path):
    p = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 24, (96, 64))
    yy, xx = np.mgrid[0:64, 0:96]
    for i in range(8):
        f = ((xx + yy + 7 * i) % 256).astype(np.uint8)
        w.write(np.stack([f, 255 - f, f], -1))
    w.release()
    return p


class TestWindowConstruction:
    def test_builds_all_controls_and_tabs(self, qt):
        win = window(qt)
        # every declarative control row became a live widget of the
        # declared kind
        for attr, _f, _tab, _lbl, kind, *_ in gui_qt.EFFECT_CONTROLS:
            wdg = getattr(win, attr)
            if kind == "f":
                assert isinstance(wdg, qt.QtWidgets.QDoubleSpinBox), attr
            elif kind == "i":
                assert isinstance(wdg, qt.QtWidgets.QSpinBox), attr
            else:
                assert isinstance(wdg, qt.QtWidgets.QCheckBox), attr
        # the reference's five tabs (crt_filter.py:1421-1508)
        central_tabs = [
            item[1]
            for item in win.centralWidget().layout()._items
            if isinstance(item[1], qt.QtWidgets.QTabWidget)
        ]
        assert len(central_tabs) == 1
        tabs = central_tabs[0]
        assert [tabs.tabText(i) for i in range(tabs.count())] == [
            "Effects", "Motion", "Advanced", "Text", "Output"]
        # toolbar actions (Open/Play/Render/Reset/Save/Load)
        assert len(win._toolbars) == 1
        assert [a.text() for a in win._toolbars[0].actions()] == [
            "Open", "Play", "Render", "Reset",
            "Save Preset", "Load Preset"]
        # status bar carries the (hidden) progress widget
        assert win.progress in win.status._permanent
        assert not win.progress.isVisible()

    def test_defaults_roundtrip_through_widgets(self, qt):
        """collect -> apply -> collect must be a fixed point: every
        default survives the widget ranges AND QDoubleSpinBox's
        2-decimal quantization (real Qt rounds setValue)."""
        win = window(qt)
        s0 = win._collect_settings()
        win._apply_settings(s0)
        assert win._collect_settings() == s0
        # the documented GUI deviation: scanline speed 60 (CLI: 30)
        assert s0["scanline_speed"] == 60.0
        assert s0["crf"] == 18 and s0["encoder"] == "auto"

    def test_reset_restores_defaults_after_edits(self, qt):
        win = window(qt)
        before = win._collect_settings()
        win.scanline_val.setValue(0.91)
        win.pixel_size.setValue(4)
        win.fast_bloom_cb.setChecked(True)
        win.crf_val.setValue(25)
        assert win._collect_settings() != before
        win.on_reset()
        assert win._collect_settings() == before


class TestPreviewInteractions:
    def test_open_renders_first_frame(self, qt, clip_path, monkeypatch):
        win = window(qt)
        monkeypatch.setattr(
            qt.QtWidgets.QFileDialog, "getOpenFileName",
            staticmethod(lambda *a, **k: (clip_path, "")))
        win.on_open()
        assert win.reader is not None and win.t == 0.0
        assert win.video_label.pixmap() is not None
        assert win.video_label.pixmap().width() == 96
        assert "Opened" in win.status.currentMessage()

    def test_open_cancel_is_a_noop(self, qt):
        win = window(qt)
        win.on_open()  # stub dialog returns ("", "")
        assert win.reader is None

    def test_play_toggles_timer_and_ticks_advance(self, qt):
        win = window(qt)
        win.on_play()  # no clip: stays inert
        assert not win.timer.isActive()
        win.reader = FakeReader()
        win.on_play()
        assert win.timer.isActive()
        assert win.timer.interval() == int(1000.0 / 24.0)
        t0 = win.t
        win.on_tick()
        assert win.t == pytest.approx(t0 + 1.0 / 24.0)
        assert win.video_label.pixmap() is not None
        win.on_play()
        assert not win.timer.isActive()

    def test_tick_wraps_at_duration(self, qt):
        win = window(qt)
        win.reader = FakeReader(duration=0.5)
        win.t = 0.49
        win.on_tick()
        assert win.t == 0.0

    def test_slider_change_rerenders_paused_preview(self, qt):
        win = window(qt)
        win.reader = FakeReader()
        win.scanline_val.setValue(0.9)
        assert win.reader.frame_at_calls == 1
        # persistence state resets on paused re-render (reference
        # crt_filter.py:1984 semantics)
        assert win.prev_img is None

    def test_stateful_tick_carries_persistence(self, qt):
        win = window(qt)
        win.reader = FakeReader()
        win.persistence_val.setValue(0.5)
        win.reader.frame_at_calls = 0
        win.on_tick()
        assert win.prev_img is not None  # stateful path carries


class TestPresetActions:
    def test_save_then_load_roundtrip(self, qt, tmp_path, monkeypatch):
        win = window(qt)
        win.reader = FakeReader()
        path = str(tmp_path / "p.json")
        monkeypatch.setattr(
            qt.QtWidgets.QFileDialog, "getSaveFileName",
            staticmethod(lambda *a, **k: (path, "")))
        win.scanline_val.setValue(0.77)
        win.on_save_preset()
        assert "saved" in win.status.currentMessage().lower()
        saved = json.loads((tmp_path / "p.json").read_text())
        # the preset file speaks the REFERENCE schema names
        # (crt_filter.py:2043-2080), not EffectParams field names
        assert saved["scanline"] == 0.77
        assert len(saved) == 34

        win.scanline_val.setValue(0.10)
        win.reader.frame_at_calls = 0
        monkeypatch.setattr(
            qt.QtWidgets.QFileDialog, "getOpenFileName",
            staticmethod(lambda *a, **k: (path, "")))
        win.on_load_preset()
        assert win.scanline_val.value() == 0.77
        # applying N fields renders the preview exactly ONCE (signals
        # blocked for the batch), not once per half-applied field
        assert win.reader.frame_at_calls == 1
        assert "loaded" in win.status.currentMessage().lower()

    def test_load_corrupt_preset_reports_not_raises(self, qt, tmp_path,
                                                    monkeypatch):
        win = window(qt)
        bad = tmp_path / "bad.json"
        bad.write_text("{nope")
        monkeypatch.setattr(
            qt.QtWidgets.QFileDialog, "getOpenFileName",
            staticmethod(lambda *a, **k: (str(bad), "")))
        before = win._collect_settings()
        win.on_load_preset()
        assert qt.QtWidgets.QMessageBox._critical_calls
        assert win._collect_settings() == before

    def test_text_preset_roundtrip_single_render(self, qt, tmp_path,
                                                 monkeypatch):
        win = window(qt)
        path = str(tmp_path / "t.json")
        monkeypatch.setattr(
            qt.QtWidgets.QFileDialog, "getSaveFileName",
            staticmethod(lambda *a, **k: (path, "")))
        win.text_size.setValue(48)
        win.text_x.setValue(12)
        win.on_save_text_preset()
        t = json.loads((tmp_path / "t.json").read_text())
        assert t["size"] == 48 and t["x"] == 12 and len(t) == 7

        win.text_size.setValue(30)
        win.reader = FakeReader()
        monkeypatch.setattr(
            qt.QtWidgets.QFileDialog, "getOpenFileName",
            staticmethod(lambda *a, **k: (path, "")))
        win.on_load_text_preset()
        assert win.text_size.value() == 48
        assert win.reader.frame_at_calls == 1  # one batch render
        assert "loaded" in win.status.currentMessage().lower()

    def test_browse_font_sets_path_and_rerenders(self, qt, monkeypatch):
        win = window(qt)
        win.reader = FakeReader()
        monkeypatch.setattr(
            qt.QtWidgets.QFileDialog, "getOpenFileName",
            staticmethod(lambda *a, **k: ("/tmp/f.ttf", "")))
        win.on_browse_font()
        assert win.text_font_path.text() == "/tmp/f.ttf"
        assert win.reader.frame_at_calls >= 1


class TestExportDialog:
    def test_defaults_keep_source_geometry(self, qt):
        dlg = qt.ExportDialog()
        assert dlg.width_box.value() == 0
        assert dlg.height_box.value() == 0
        assert dlg.fps_box.value() == 0
        assert dlg.width_box.specialValueText() == "keep"
        assert dlg.path_edit.text().endswith("out_crt.mp4")
        assert not dlg.gpu_cb.isChecked()

    def test_accept_reject_drive_exec_result(self, qt):
        dlg = qt.ExportDialog()
        assert dlg.exec() == qt.QtWidgets.QDialog.Rejected
        dlg.accept()
        assert dlg.exec() == qt.QtWidgets.QDialog.Accepted

    def test_browse_updates_path(self, qt, monkeypatch):
        dlg = qt.ExportDialog()
        monkeypatch.setattr(
            qt.QtWidgets.QFileDialog, "getSaveFileName",
            staticmethod(lambda *a, **k: ("/tmp/neat.mp4", "")))
        dlg._browse()
        assert dlg.path_edit.text() == "/tmp/neat.mp4"


class TestRenderFlow:
    def test_render_without_clip_prompts_open(self, qt):
        win = window(qt)
        win.on_render()
        assert "Open a video first" in win.status.currentMessage()
        assert win._render_thread is None

    def test_cancelled_dialog_leaves_window_live(self, qt):
        win = window(qt)
        win.reader = FakeReader()
        win.on_render()  # stub exec() -> Rejected
        assert win.isEnabled() and win._render_thread is None

    def test_full_render_flow(self, qt, monkeypatch):
        win = window(qt)
        win.reader = FakeReader()
        win.on_play()
        assert win.timer.isActive()
        win.gpu_cb.setChecked(True)  # Output tab seeds the dialog

        seen = {}
        captured_dlg = {}

        def fake_exec(dlg):
            captured_dlg["gpu_seeded"] = dlg.gpu_cb.isChecked()
            dlg.width_box.setValue(48)
            return qt.QtWidgets.QDialog.Accepted

        monkeypatch.setattr(qt.QtWidgets.QDialog, "exec", fake_exec)

        def fake_process_video(input_path, output_path, params, *,
                               progress_cb=None, **kw):
            seen.update(input=input_path, output=output_path,
                        params=params, **kw)
            progress_cb(0.5)
            return False  # CPU encoder

        from pythoncrt_tpu_torch import pipeline

        monkeypatch.setattr(pipeline, "process_video", fake_process_video)
        win.on_render()

        # dialog was seeded from the Output tab's HW-encode state
        assert captured_dlg["gpu_seeded"] is True
        # preview stopped for the render (the card serves the export)
        assert not win.timer.isActive()
        # the kwargs reached process_video faithfully
        assert seen["input"] == win.reader.path
        assert seen["width"] == 48 and seen["height"] is None
        assert seen["gpu"] is True and seen["crf"] == 18
        assert seen["device"] == "cpu" and seen["engine_mode"] == "export"
        assert isinstance(seen["params"], EffectParams)
        # the synchronous stub QThread ran the worker to completion:
        # progress hit 50%, then the done-slot re-enabled the window
        assert win.progress.value() == 50
        assert not win.progress.isVisible()
        assert win.isEnabled()
        assert not win._render_thread.isRunning()
        assert "Render done — CPU encoder" in win.status.currentMessage()

    def test_failed_render_reports_failure(self, qt, monkeypatch):
        win = window(qt)
        win.reader = FakeReader()
        monkeypatch.setattr(
            qt.QtWidgets.QDialog, "exec",
            lambda dlg: qt.QtWidgets.QDialog.Accepted)

        from pythoncrt_tpu_torch import pipeline

        def boom(*a, **k):
            raise RuntimeError("decoder exploded")

        monkeypatch.setattr(pipeline, "process_video", boom)
        win.on_render()
        assert win.isEnabled()
        assert "Render failed" in win.status.currentMessage()
        assert "decoder exploded" in win.status.currentMessage()


class TestCloseEvent:
    def test_refuses_close_while_rendering(self, qt):
        win = window(qt)
        win.reader = FakeReader()
        th = qt.QtCore.QThread()
        th.start()
        win._render_thread = th
        ev = qt.QtGui.QCloseEvent()
        win.closeEvent(ev)
        assert not ev.isAccepted()
        assert "in progress" in win.status.currentMessage()
        assert not win.reader.closed

    def test_clean_close_stops_timer_and_reader(self, qt):
        win = window(qt)
        win.reader = FakeReader()
        win.on_play()
        ev = qt.QtGui.QCloseEvent()
        win.closeEvent(ev)
        assert ev.isAccepted()
        assert not win.timer.isActive()
        assert win.reader.closed


class TestRunApp:
    def test_run_app_builds_theme_and_window(self, qt, monkeypatch):
        built = []
        cls = qt.CRTWindow
        monkeypatch.setattr(qt, "CRTWindow",
                            lambda device: built.append(cls(device=device)) or built[-1])
        rc = gui_qt.run_app(device="cpu")
        assert rc == 0
        app = qt.QtWidgets.QApplication.instance()
        assert app is not None
        assert app._style == "Fusion"
        assert app._palette is not None
        assert "QMainWindow" in app._stylesheet
        assert [w.device for w in built] == ["cpu"] and built[0].isVisible()
        assert built[0].windowTitle() == "PythonCRT (CUDA)"


class TestTextQtGate:
    def test_rasterize_text_qt_without_app_takes_pil_path(self, qt):
        """With Qt importable but no QGuiApplication constructed (the
        CLI-render-on-a-Qt-host case), rasterize_text_qt must take the
        PIL fallback — QPainter without an app is a Qt fatal abort, not
        an exception."""
        from pythoncrt_tpu_torch.params import TextParams
        from pythoncrt_tpu_torch.text import rasterize_text, rasterize_text_qt

        assert qt.QtGui.QGuiApplication.instance() is None
        t = TextParams(text="HI", size=14, color="#ff0000", x=2, y=3)
        out = rasterize_text_qt(32, 24, t)
        ref = rasterize_text(32, 24, t)
        assert out.shape == (24, 32, 4) and out.dtype == np.uint8
        assert np.array_equal(out, ref)  # byte-identical PIL fallback


class TestEnginePreview:
    """The window's preview through the port's engine (device "cpu":
    the kernels' plain twins), a preview failure, and the render's
    progress slot."""

    @pytest.fixture()
    def qt_engine(self, qt, monkeypatch):
        monkeypatch.delenv("PCRT_PREVIEW_ENGINE")
        gui_qt._PREVIEW_ENGINES.clear()
        yield qt
        gui_qt._PREVIEW_ENGINES.clear()

    def test_ticks_render_through_the_engine(self, qt_engine, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("the preview rendered through the oracle")

        monkeypatch.setattr(gui_qt.oracle, "apply_effects", refuse)
        win = window(qt_engine)
        win.reader = FakeReader()
        win.persistence_val.setValue(0.5)
        win.on_play()
        for _ in range(3):
            win.on_tick()
        assert win.timer.isActive() and win.prev_img is not None
        assert win.video_label.pixmap().width() == 96
        assert win.t == pytest.approx(3 / 24.0)
        assert len(gui_qt._PREVIEW_ENGINES) == 1  # the persistence slider: one engine
        (key,) = gui_qt._PREVIEW_ENGINES
        assert key[1:] == (96, 64, "cpu")
        assert "Preview failed" not in win.status.currentMessage()

    @pytest.mark.parametrize("where", ["build", "launch"])
    def test_preview_failure_stops_the_timer(self, qt_engine, monkeypatch, where):
        """A failed engine build or launch shows in the status bar, stops
        the timer, shows no frame and does not re-raise in the timer's
        slot; nothing renders through the oracle."""
        from pythoncrt_tpu_torch import engine as eng_mod

        def refuse(*a, **k):
            raise AssertionError("the preview rendered through the oracle")

        def boom(*a, **k):
            raise RuntimeError(f"{where} failed")

        monkeypatch.setattr(gui_qt.oracle, "apply_effects", refuse)
        if where == "build":
            monkeypatch.setattr(eng_mod, "CRTEngine", boom)
        else:
            monkeypatch.setattr(eng_mod.CRTEngine, "process_at", boom)
        win = window(qt_engine)
        win.reader = FakeReader()
        win.on_play()
        assert win.timer.isActive()
        win.on_tick()
        assert not win.timer.isActive()
        assert win.status.currentMessage() == f"Preview failed: {where} failed"
        assert win.video_label.pixmap() is None and win.t == 0.0
        win.scanline_val.setValue(0.9)  # a paused re-render fails the same way
        assert win.status.currentMessage() == f"Preview failed: {where} failed"
        assert win.video_label.pixmap() is None

    def test_cuda_window_without_a_card_reports(self, qt_engine):
        import torch

        if torch.cuda.is_available():
            pytest.skip("this host has CUDA")
        win = qt_engine.CRTWindow()
        assert win.device == "cuda"
        win.reader = FakeReader()
        win.on_play()
        win.on_tick()
        assert not win.timer.isActive()
        assert win.status.currentMessage().startswith("Preview failed: ")

    def test_progress_goes_to_a_window_slot(self, qt, monkeypatch):
        """The worker's progress signal is connected to the window's
        _on_render_progress slot (queued to the GUI thread by Qt), not to
        a lambda that would run on the worker thread."""
        win = window(qt)
        win.reader = FakeReader()
        monkeypatch.setattr(qt.QtWidgets.QDialog, "exec",
                            lambda dlg: qt.QtWidgets.QDialog.Accepted)
        from pythoncrt_tpu_torch import pipeline

        def fake_process_video(input_path, output_path, params, *, progress_cb=None, **kw):
            progress_cb(0.25)
            return False

        monkeypatch.setattr(pipeline, "process_video", fake_process_video)
        win.on_render()
        (handler,) = win._worker.progress._handlers
        assert handler == win._on_render_progress
        assert getattr(handler, "__func__", None) is type(win)._on_render_progress
        assert handler.__name__ != "<lambda>"
        assert win.progress.value() == 25
        win._on_render_progress(0.5)
        assert win.progress.value() == 50
