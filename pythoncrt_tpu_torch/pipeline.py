"""Video render pipeline: decode -> device batches -> encode.

Port of pythoncrt_tpu/pipeline.py (single clip, single device):

  decode thread -> pinned host batch -> H2D -> engine step (kernels)
  -> D2H into a pinned host batch -> encode thread

All device work of the main loop runs on one CUDA stream and returns
without waiting; the loop waits for batch N's copy back only after it
has queued batch N+1, so the device works while the host decodes and
encodes. Host batch buffers come from two small pools and are reused:
an input buffer returns to its pool once the device has copied it, an
output buffer once the encoder has written it.

``render_stream`` is the loop over any reader (``read_into(buf) ->
bool``, ``out_h``, ``out_w``, optional ``frame_shape``, ``close()``) and
writer (``write_frame(frame)``, ``close()``), the protocols of io/video.py;
``process_video`` opens the codec ends around it.
"""

from __future__ import annotations

import contextlib
import math
import os
import queue
import threading
import time
from collections import deque
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import perf
from .engine import CRTEngine, unsupported
from .io import video as vio
from .params import EffectParams
from .text import overlay_for

DEFAULT_BATCH = 16
POOL = 4  # host batch buffers per direction


def _put_or_stop(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Bounded put that rechecks the stop event, so a producer thread
    never stays blocked when the consumer has bailed out."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


def _get_or_stop(q: queue.Queue, stop: threading.Event):
    while not stop.is_set():
        try:
            return q.get(timeout=0.2)
        except queue.Empty:
            continue
    return None


def _feeder(reader, free: queue.Queue, out_q: queue.Queue, stop: threading.Event,
            start_idx: int, err: dict) -> None:
    """Decode thread: fill free host batches frame by frame (read_into
    writes straight into the pinned buffer) and hand them over in order
    as (first frame index, buffer, frames filled). A decoder exception
    is recorded in err["decode"], not turned into a fake end of stream."""
    idx0 = start_idx
    try:
        while not stop.is_set():
            buf = _get_or_stop(free, stop)
            if buf is None:
                break
            arr = buf.numpy()
            got = 0
            with perf.timed("io.decode"):
                while got < arr.shape[0] and reader.read_into(arr[got]):
                    got += 1
            if got == 0 or not _put_or_stop(out_q, (idx0, buf, got), stop):
                break
            idx0 += got
            if got < arr.shape[0]:
                break
    except Exception as e:  # surfaced by the consumer
        err["decode"] = e
    finally:
        _put_or_stop(out_q, None, stop)


def _writer_loop(writer, in_q: queue.Queue, free: queue.Queue, progress,
                 total_frames: int, err: dict) -> None:
    """Encode thread: write each host batch in order, then recycle it.
    Keeps draining after a failure so the producer never blocks."""
    written = 0
    while True:
        item = in_q.get()
        if item is None:
            break
        buf, got = item
        if "encode" not in err:
            try:
                with perf.timed("io.encode"):
                    arr = buf.numpy()
                    for i in range(got):
                        writer.write_frame(arr[i])
                written += got
                if progress is not None and total_frames > 0:
                    progress(min(1.0, written / float(total_frames)))
            except Exception as e:  # encoder died, disk full, raising callback
                err["encode"] = e
        free.put(buf)


def render_stream(reader, writer, engine: CRTEngine, *, batch_size: int = DEFAULT_BATCH,
                  start_idx: int = 0, total_frames: int = 0,
                  progress_cb: Optional[Callable[[float], None]] = None) -> int:
    """Render every frame ``reader`` yields through ``engine`` into
    ``writer`` (which the caller closes). Returns the frames rendered."""
    dev = engine.device
    cuda = dev.type == "cuda"
    fshape = tuple(getattr(reader, "frame_shape", (reader.out_h, reader.out_w, 3)))
    if fshape != engine._frame_shape():
        raise ValueError(f"reader frames {fshape} do not fit the engine's "
                         f"{engine.layout} layout {engine._frame_shape()}")

    def host_batch():
        return torch.empty((batch_size, *fshape), dtype=torch.uint8, pin_memory=cuda)

    in_free: queue.Queue = queue.Queue()
    out_free: queue.Queue = queue.Queue()
    for _ in range(POOL):
        in_free.put(host_batch())
        out_free.put(host_batch())
    decode_q: queue.Queue = queue.Queue(maxsize=POOL)
    encode_q: queue.Queue = queue.Queue()
    stop = threading.Event()
    err: dict = {}
    t_dec = threading.Thread(target=_feeder, daemon=True,
                             args=(reader, in_free, decode_q, stop, start_idx, err))
    t_enc = threading.Thread(target=_writer_loop, daemon=True,
                             args=(writer, encode_q, out_free, progress_cb,
                                   total_frames, err))
    t_dec.start()
    t_enc.start()
    stream = torch.cuda.Stream(dev) if cuda else None
    pending: deque = deque()
    frames = 0
    state = None

    def check_encoder(running: bool = True):
        if "encode" in err:
            raise RuntimeError("encode failed") from err["encode"]
        if running and not t_enc.is_alive():
            raise RuntimeError("encoder thread died")

    def retire():
        ev, buf, out_buf, got = pending.popleft()
        if ev is not None:
            with perf.timed("fx.device_wait"):
                ev.synchronize()
        in_free.put(buf)
        check_encoder()
        encode_q.put((out_buf, got))

    try:
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            while True:
                item = decode_q.get()
                if item is None:
                    break
                idx0, buf, got = item
                while True:
                    check_encoder()
                    try:
                        out_buf = out_free.get(timeout=0.5)
                        break
                    except queue.Empty:
                        continue
                with perf.timed("fx.dispatch"), perf.device_trace("fx.step"):
                    x = buf[:got].to(dev, non_blocking=True)
                    out, state = engine.process(x, np.arange(idx0, idx0 + got), state)
                    out_buf[:got].copy_(out, non_blocking=True)
                    ev = None
                    if cuda:
                        ev = torch.cuda.Event()
                        ev.record(stream)
                pending.append((ev, buf, out_buf, got))
                frames += got
                if len(pending) > 1:
                    retire()
            while pending:
                retire()
    finally:
        stop.set()
        encode_q.put(None)
        t_enc.join(timeout=120)
        t_dec.join(timeout=30)
    check_encoder(running=False)
    if "decode" in err:
        raise RuntimeError("decode failed") from err["decode"]
    return frames


def process_video(
    input_path: str | Path,
    output_path: str | Path,
    params: EffectParams,
    *,
    width: Optional[int] = None,
    height: Optional[int] = None,
    fps: Optional[float] = None,
    crf: int = 18,
    target_bitrate_kbps: int = 0,
    gpu: bool = False,
    nvenc_preset: str = "p4",
    encoder_preference: str = "auto",
    decoder_preference: str = "auto",
    batch_size: int = DEFAULT_BATCH,
    engine_mode: str = "export",
    rng: str = "native",
    seed: int = 0,
    assoc_scan: bool = False,
    precision: str = "exact",
    pipe_format: str = "rgb24",
    device="cuda",
    progress_cb: Optional[Callable[[float], None]] = None,
    report: bool = True,
    profile_dir: Optional[str] = None,
) -> bool:
    """Render ``input_path`` through the effect chain to ``output_path``.

    Arguments as the JAX package's process_video (crt_filter.py:864-912
    semantics: width/height/fps of None keep the source values). When an
    ffmpeg binary pipes both ends, frames travel as planar gbrp and the
    engine runs in that layout (no host repack). Returns whether a
    hardware encoder was used."""
    why = unsupported(params, precision=precision)
    if why:
        raise NotImplementedError(why)
    if pipe_format != "rgb24":
        raise NotImplementedError(f"pipe_format {pipe_format!r} is not ported yet: "
                                  "ROADMAP.md queue 1, pipeline: yuv420p decode")
    input_path, output_path = Path(input_path), Path(output_path)
    info = vio.probe_clip(input_path)
    out_w = int(width) if width else info.width
    out_h = int(height) if height else info.height
    fps_out = float(fps) if fps and fps > 0 else (info.fps or 24.0)
    total_frames = max(1, int(math.ceil(info.duration * fps_out)))

    perf.perf_reset()
    t_start = time.perf_counter()
    planar = vio.find_ffmpeg() is not None
    text_rgba = overlay_for(out_w, out_h, params.text)
    with perf.timed("fx.compile"):
        eng = CRTEngine(params, out_h, out_w, fps_out, engine=engine_mode, rng=rng,
                        seed=seed, text_rgba=text_rgba, precision=precision,
                        assoc_scan=assoc_scan,
                        layout="planar" if planar else "nhwc",
                        channel_order="gbr" if planar else "rgb", device=device)
        if eng.device.type == "cuda":
            from .kernels import _build

            _build.library()  # nvcc at first use, charged here
    audio_path = vio.extract_audio(input_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    writer = reader = None
    frames = 0
    try:
        writer, used_gpu = vio.open_writer(
            str(output_path), out_w, out_h, fps_out,
            encoder_preference=encoder_preference, gpu=gpu, crf=crf,
            bitrate_kbps=target_bitrate_kbps, nvenc_preset=nvenc_preset,
            audio_path=audio_path, pix_fmt="gbrp" if planar else "rgb24")
        reader = vio.open_reader(str(input_path), out_w, out_h, fps_out,
                                 decoder_preference, "gbrp" if planar else "rgb24")
        prof = contextlib.nullcontext()
        if profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if eng.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
        with prof:
            frames = render_stream(reader, writer, eng, batch_size=batch_size,
                                   total_frames=total_frames, progress_cb=progress_cb)
        if profile_dir:
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    finally:
        if reader is not None:
            reader.close()
        if writer is not None:
            writer.close()
        if audio_path:
            with contextlib.suppress(OSError):
                os.unlink(audio_path)
    if report:
        perf.perf_report(total_frames=frames,
                         total_seconds=time.perf_counter() - t_start)
    if progress_cb is not None:
        progress_cb(1.0)
    return used_gpu
