"""Video render pipeline: decode -> device batches -> encode.

Port of pythoncrt_tpu/pipeline.py (single clip):

  decode thread -> pinned host batch -> H2D -> engine step (kernels)
  -> D2H into a pinned host batch -> encode thread

All device work of the main loop runs on one CUDA stream and returns
without waiting; the loop waits for batch N's copy back only after it
has queued batch N+1, so the device works while the host decodes and
encodes. Host batch buffers come from two small pools and are reused:
an input buffer returns to its pool once the device has copied it, an
output buffer once the encoder has written it.

``render_stream`` is the loop over any reader (``read_into(buf) ->
bool``, or ``iter_batches(B)`` as io/video.py's ChunkedParallelReader
yields them; ``out_h``, ``out_w``, optional ``frame_shape``,
``close()``) and writer (``write_frame(frame)``, ``close()``), the
protocols of io/video.py; ``process_video`` opens the codec ends around
it. With ``--segment-frames`` the encode thread writes segment files
and journals each one with the persistence carry after its last batch
(segments.py), and a later call resumes there: the reader seeks to the
first frame not rendered and the stream continues from the snapshot,
bit for bit.

With ``sharding="auto"`` and more than one visible card, each full batch
runs through a ``ShardedCRTEngine`` over the cards (``frame_runner``),
the frame axis split across them with the persistence carry crossing the
shards; the stream's short tail runs through the single-device engine.

``steps_per_call`` n above 1 (``--steps-per-call``; 0 is the JAX
package's auto rule, ``resolve_steps_per_call``) makes every host buffer
a super-batch of n batches: the decoder fills n * B frames, a full one
goes to the device in one copy and through ``process_stack`` (n steps
enqueued back to back), and comes back in one copy with one event; a
short one, the stream's tail, is sliced into plain batches. The pools
shrink to max(2, POOL // n) buffers per direction (``host_pool``), as
the JAX package bounds its queue of decoded super-batches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import perf
from .engine import CRTEngine
from .kernels.rng import NATIVE_STREAM
from .io import video as vio
from .params import EffectParams
from .segments import SegmentStore
from .text import overlay_for

DEFAULT_BATCH = 16
POOL = 4  # host batch buffers per direction (of super-batches: host_pool)


def host_pool(batch_size: int, steps_per_call: int) -> tuple[int, int]:
    """(frames per host buffer, buffers per direction) of a render at
    ``steps_per_call`` n: super-batches of n * B frames, max(2, POOL // n)
    of them (the JAX package's bound on decoded super-batches in flight,
    pythoncrt_tpu/pipeline.py:395), so n = 1 keeps POOL batches. The
    render pins twice that many buffers: one pool per direction."""
    return steps_per_call * batch_size, max(2, POOL // steps_per_call)


def resolve_steps_per_call(out_h: int, out_w: int, segmented: bool, requested: int) -> int:
    """The steps per call of a single-clip render (the JAX package's rule,
    pythoncrt_tpu/pipeline.py:306-322): ``requested`` above 0 is kept;
    0 (auto) gives 8 at 1920x1080 pixels or fewer and 4 above. Under
    ``--segment-frames`` auto gives 1, and an explicit request above 1 is
    forced to 1 with a notice: the journal snapshots the carry per
    batch."""
    spc = int(requested)
    if spc <= 0:
        return 1 if segmented else (8 if out_h * out_w <= 1920 * 1080 else 4)
    if spc > 1 and segmented:
        print("steps-per-call > 1 is forced to 1 under --segment-frames "
              "(the journal snapshots the carry per batch)", flush=True)
        return 1
    return spc


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
    """Decode thread: fill free host batches and hand them over in order
    as (first frame index, buffer, frames filled). A sequential reader's
    read_into writes straight into the pinned buffer; a parallel reader's
    batches (``iter_batches``, ChunkedParallelReader) are copied into it,
    one host copy per batch, timed with the wait under io.decode. A
    decoder exception is recorded in err["decode"], not turned into a
    fake end of stream."""
    idx0 = start_idx
    batches = None
    try:
        while not stop.is_set():
            buf = _get_or_stop(free, stop)
            if buf is None:
                break
            arr = buf.numpy()
            got = 0
            with perf.timed("io.decode"):
                if hasattr(reader, "iter_batches"):
                    if batches is None:
                        batches = reader.iter_batches(arr.shape[0])
                    item = next(batches, None)
                    if item is not None:
                        idx0, frames = item
                        got = frames.shape[0]
                        arr[:got] = frames
                else:
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


@dataclass
class SegmentRun:
    """A segmented render's side of the encode thread (``--segment-frames``):
    the store, the batch-aligned segment length, the first segment to
    write and the frames already journaled, the segment writers' size,
    rate and codec settings. ``box`` receives "segments" (the segments
    committed) and "used_gpu"."""
    store: SegmentStore
    length: int
    first: int
    skip: int
    w: int
    h: int
    fps: float
    enc_kwargs: dict
    box: dict = field(default_factory=dict)


def _segment_writer_loop(seg: SegmentRun, in_q: queue.Queue, free: queue.Queue, progress,
                         total_frames: int, err: dict) -> None:
    """Encode thread, segment mode: a fresh segment writer every
    seg.length frames; a completed segment commits (file close, then the
    carry snapshot, then the journal line) before the next opens. Items
    are (buffer, frames, snapshot or None); the sentinel ("eof",) commits
    the partial tail, ("abort",) leaves it unjournaled for the resume to
    render again."""
    index, in_seg, written = seg.first, 0, seg.skip
    cur = None

    def close_seg(mark: bool, state=None) -> None:
        nonlocal cur, index, in_seg
        if cur is None:
            return
        cur.close()
        if mark:
            seg.store.mark_done(index, in_seg, state)
            index += 1
        cur, in_seg = None, 0

    while True:
        item = in_q.get()
        if item is None or isinstance(item[0], str):
            try:
                close_seg(mark=item is not None and item[0] == "eof" and "encode" not in err)
            except Exception as e:
                err.setdefault("encode", e)
            break
        buf, got, snap = item
        if "encode" not in err:
            try:
                with perf.timed("io.encode"):
                    arr = buf.numpy()
                    for i in range(got):
                        if cur is None:
                            cur, gpu = vio.open_writer(str(seg.store.seg_path(index)), seg.w,
                                                       seg.h, seg.fps, **seg.enc_kwargs)
                            seg.box.setdefault("used_gpu", gpu)
                        cur.write_frame(arr[i])
                        in_seg += 1
                        written += 1
                    # the length is batch-aligned: boundaries land on batch ends
                    if in_seg >= seg.length:
                        close_seg(True, None if snap is None else snap.numpy())
                if progress is not None and total_frames > 0:
                    progress(min(1.0, written / float(total_frames)))
            except Exception as e:
                err["encode"] = e
        free.put(buf)
    seg.box["segments"] = index


def render_stream(reader, writer, engine: CRTEngine, *, batch_size: int = DEFAULT_BATCH,
                  steps_per_call: int = 1, start_idx: int = 0, total_frames: int = 0,
                  progress_cb: Optional[Callable[[float], None]] = None, state=None,
                  segments: Optional[SegmentRun] = None, runner=None,
                  _fail_after_frames: int = 0) -> int:
    """Render every frame ``reader`` yields through ``engine`` into
    ``writer`` (which the caller closes). Returns the frames rendered.

    ``runner`` (a ``ShardedCRTEngine`` around ``engine``, see
    ``frame_runner``) takes every full batch; a short batch, the stream's
    tail, goes through ``engine``, as the JAX package's render does
    (pythoncrt_tpu/pipeline.py:484-486): a sharded batch must divide by
    the mesh. Both return their output and state on the engine's device.
    ``steps_per_call`` n above 1 sends every full super-batch of n * B
    frames through ``runner.process_stack`` as (n, B, ...) and slices a
    short one into batches (JAX pipeline.py:456-495); it needs
    ``segments`` None.

    ``start_idx`` is the absolute index of the reader's first frame and
    ``state`` the persistence carry before it (a segment resume: the
    stream continues bit for bit). With ``segments`` the encode thread
    writes segment files and journals them (``writer`` is unused), and
    each batch that closes a segment carries a host copy of the state
    after it, made on the stream before the next step runs.
    ``_fail_after_frames`` is a test hook: the render fails once that
    many frames were dispatched."""
    runner = engine if runner is None else runner
    dev = engine.device
    cuda = dev.type == "cuda"
    spc = int(steps_per_call)
    if spc < 1 or (spc > 1 and segments is not None):
        raise ValueError(f"steps_per_call must be 1, or above 1 without segments, got {spc}")
    fshape = tuple(getattr(reader, "frame_shape", (reader.out_h, reader.out_w, 3)))
    if fshape != engine._frame_shape():
        raise ValueError(f"reader frames {fshape} do not fit the engine's "
                         f"{engine.layout} layout {engine._frame_shape()}")
    feed, pool = host_pool(batch_size, spc)

    def host_batch():
        return torch.empty((feed, *fshape), dtype=torch.uint8, pin_memory=cuda)

    in_free: queue.Queue = queue.Queue()
    out_free: queue.Queue = queue.Queue()
    for _ in range(pool):
        in_free.put(host_batch())
        out_free.put(host_batch())
    decode_q: queue.Queue = queue.Queue(maxsize=pool)
    encode_q: queue.Queue = queue.Queue()
    stop = threading.Event()
    err: dict = {}
    t_dec = threading.Thread(target=_feeder, daemon=True,
                             args=(reader, in_free, decode_q, stop, start_idx, err))
    loop, sink = (_writer_loop, writer) if segments is None else (_segment_writer_loop, segments)
    t_enc = threading.Thread(target=loop, daemon=True,
                             args=(sink, encode_q, out_free, progress_cb, total_frames, err))
    t_dec.start()
    t_enc.start()
    stream = torch.cuda.Stream(dev) if cuda else None
    snapshots = segments is not None and engine.params.persistence_on
    pending: deque = deque()
    frames = 0
    clean = False

    def check_encoder(running: bool = True):
        if "encode" in err:
            raise RuntimeError("encode failed") from err["encode"]
        if running and not t_enc.is_alive():
            raise RuntimeError("encoder thread died")

    def retire():
        ev, buf, out_buf, got, snap = pending.popleft()
        if ev is not None:
            with perf.timed("fx.device_wait"):
                ev.synchronize()
        in_free.put(buf)
        check_encoder()
        encode_q.put((out_buf, got) if segments is None else (out_buf, got, snap))

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
                with perf.timed("fx.dispatch"):
                    snap = None
                    if spc > 1 and got == feed:
                        # a full super-batch: one copy each way, n steps
                        # enqueued back to back
                        x = buf.view(spc, batch_size, *fshape).to(dev, non_blocking=True)
                        idx = np.arange(idx0, idx0 + feed).reshape(spc, batch_size)
                        out, state = runner.process_stack(x, idx, state)
                        out_buf.view(spc, batch_size, *fshape).copy_(out, non_blocking=True)
                    else:
                        # plain batches: one per buffer at steps per call 1,
                        # else a short super-batch (the stream's tail) sliced
                        for off in range(0, got, batch_size):
                            n_b = min(batch_size, got - off)
                            x = buf[off:off + n_b].to(dev, non_blocking=True)
                            step = runner if n_b == batch_size else engine
                            out, state = step.process(x, np.arange(idx0 + off, idx0 + off + n_b),
                                                      state)
                            out_buf[off:off + n_b].copy_(out, non_blocking=True)
                        if snapshots and (idx0 + got) % segments.length == 0:
                            # the carry after the batch that closes a segment,
                            # copied before the next step can replace it
                            snap = torch.empty(state.shape, dtype=state.dtype, pin_memory=cuda)
                            snap.copy_(state, non_blocking=True)
                    ev = None
                    if cuda:
                        ev = torch.cuda.Event()
                        ev.record(stream)
                pending.append((ev, buf, out_buf, got, snap))
                frames += got
                if len(pending) > 1:
                    retire()
                if _fail_after_frames and frames >= _fail_after_frames:
                    raise RuntimeError("injected failure (test hook)")
            while pending:
                retire()
            clean = True
    finally:
        stop.set()
        if segments is None:
            encode_q.put(None)
        else:
            encode_q.put(("eof",) if clean else ("abort",))
        t_enc.join(timeout=120)
        t_dec.join(timeout=30)
    check_encoder(running=False)
    if "decode" in err:
        raise RuntimeError("decode failed") from err["decode"]
    return frames


def frame_runner(engine: CRTEngine, sharding: str, devices: int, batch_size: int):
    """The step that takes a render's full batches (JAX pipeline.py:270-301).
    ``sharding`` "auto": a ``ShardedCRTEngine`` over the first n visible
    cards, n the visible count capped by ``devices`` (0: no cap), when n
    is above 1 and divides ``batch_size``, and the engine's device names
    the CUDA type rather than one card or the CPU (``may_shard``: a user
    who named one device gets that device); else the engine itself.
    "none" is the engine itself."""
    if sharding not in ("auto", "none"):
        raise ValueError(f"sharding must be 'auto' or 'none', got {sharding!r}")
    from . import parallel

    if sharding == "none" or not parallel.may_shard(engine.device):
        return engine
    ndev = torch.cuda.device_count()
    if devices > 0:
        ndev = min(ndev, devices)
    if ndev > 1 and batch_size % ndev == 0:
        return parallel.ShardedCRTEngine(engine, parallel.make_mesh(ndev))
    return engine


def planar_pipe_gate(pipe_format: str) -> bool:
    """Whether ffmpeg pipes both ends as planar gbrp and the engine runs
    planar (pythoncrt_tpu/pipeline.py planar_pipe_gate): an rgb24 request
    with an ffmpeg binary present. process_video and
    multiclip.process_videos take the same gate, so the batch path renders
    in the single-clip path's layout. yuv420p runs NHWC."""
    return pipe_format == "rgb24" and vio.find_ffmpeg() is not None


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
    sharding: str = "auto",
    devices: int = 0,
    decode_workers: int = 1,
    segment_frames: int = 0,
    steps_per_call: int = 0,
    device="cuda",
    progress_cb: Optional[Callable[[float], None]] = None,
    report: bool = True,
    profile_dir: Optional[str] = None,
    _fail_after_frames: int = 0,
) -> bool:
    """Render ``input_path`` through the effect chain to ``output_path``.

    Arguments as the JAX package's process_video (crt_filter.py:864-912
    semantics: width/height/fps of None keep the source values). When an
    ffmpeg binary pipes both ends, frames travel as planar gbrp and the
    engine runs in that layout (no host repack; planar_pipe_gate).
    ``sharding`` "auto" splits each full batch's frames across the visible
    cards (at most ``devices`` of them, 0 for all) when more than one is
    visible, the batch size divides by their number and ``device`` is
    "cuda" (frame_runner); "none" renders on one device.
    ``pipe_format`` "yuv420p" decodes a half-size pipe and converts on
    the host (NHWC; without an ffmpeg binary the OpenCV tier decodes).
    ``decode_workers`` above 1 decodes seek-positioned chunks in parallel
    (io.video.ChunkedParallelReader), in units of a super-batch.
    ``segment_frames`` above 0 writes batch-aligned segments with a resume
    journal (segments.py) and assembles them at the end; the same call
    after a crash resumes at the first unfinished segment.
    ``steps_per_call`` n runs n batches per device call (render_stream;
    0: auto, resolve_steps_per_call). ``_fail_after_frames`` is a test
    hook that injects a crash. Returns whether a hardware encoder was
    used."""
    if pipe_format not in ("rgb24", "yuv420p"):
        raise ValueError(f"pipe_format must be 'rgb24' or 'yuv420p', got {pipe_format!r}")
    input_path, output_path = Path(input_path), Path(output_path)
    info = vio.probe_clip(input_path)
    out_w = int(width) if width else info.width
    out_h = int(height) if height else info.height
    fps_out = float(fps) if fps and fps > 0 else (info.fps or 24.0)
    total_frames = max(1, int(math.ceil(info.duration * fps_out)))

    perf.perf_reset()
    t_start = time.perf_counter()
    planar = planar_pipe_gate(pipe_format)
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
        runner = frame_runner(eng, sharding, devices, batch_size)
    pipe = "gbrp" if planar else pipe_format
    out_fmt = "gbrp" if planar else "rgb24"
    spc = resolve_steps_per_call(out_h, out_w, segment_frames > 0, steps_per_call)
    enc = dict(encoder_preference=encoder_preference, gpu=gpu, crf=crf,
               bitrate_kbps=target_bitrate_kbps, nvenc_preset=nvenc_preset)
    audio_path = vio.extract_audio(input_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    writer = reader = seg = state = None
    used_gpu = False
    skip = frames = 0
    try:
        if segment_frames > 0:
            # batch-aligned: boundaries land on batch ends, so the carry
            # snapshot travels with the batch that closes a segment
            seg_len = max(batch_size, -(-int(segment_frames) // batch_size) * batch_size)
            # the JAX package's signature (the carry is in the engine's
            # layout), the package that wrote the journal and its native
            # stream: a journal of the JAX package, or of a port whose
            # native rng drew another stream, starts afresh
            store = SegmentStore(output_path, {
                "impl": "pythoncrt_tpu_torch", "native_stream": NATIVE_STREAM,
                "w": out_w, "h": out_h, "fps": fps_out,
                "seg": seg_len, "engine": engine_mode, "rng": rng, "seed": seed,
                "precision": precision, "layout": eng.layout,
                "params": dataclasses.asdict(params.clamped())})
            first, skip, snap = store.resume()
            store.begin(first)
            state = None if snap is None else torch.from_numpy(snap)
            # audio is muxed at the merge
            seg = SegmentRun(store, seg_len, first, skip, out_w, out_h, fps_out,
                             dict(enc, audio_path=None, pix_fmt=out_fmt))
        else:
            writer, used_gpu = vio.open_writer(str(output_path), out_w, out_h, fps_out,
                                               audio_path=audio_path, pix_fmt=out_fmt, **enc)
        # opened at the resume point: the decoder seeks to the first
        # frame not yet rendered; its batches are the super-batches
        if decode_workers > 1 and info.duration > 0:
            reader = vio.ChunkedParallelReader(
                str(input_path), out_w, out_h, fps_out, total_frames, spc * batch_size,
                workers=decode_workers, decoder_preference=decoder_preference,
                pipe_format=pipe, start_frame=skip)
        else:
            reader = vio.open_reader(str(input_path), out_w, out_h, fps_out,
                                     decoder_preference, pipe, start_frame=skip)
        prof = contextlib.nullcontext()
        if profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if eng.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
        with prof:
            frames = render_stream(reader, writer, eng, batch_size=batch_size,
                                   steps_per_call=spc, start_idx=skip,
                                   total_frames=total_frames, progress_cb=progress_cb,
                                   state=state, segments=seg, runner=runner,
                                   _fail_after_frames=_fail_after_frames)
        if profile_dir:
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        if seg is not None:
            with perf.timed("io.merge"):
                seg.store.merge(seg.box.get("segments", seg.first), out_w, out_h, fps_out,
                                audio_path=audio_path, enc_kwargs=enc)
            used_gpu = bool(seg.box.get("used_gpu", False))
    finally:
        if reader is not None:
            reader.close()
        if writer is not None:
            writer.close()
        if audio_path:
            with contextlib.suppress(OSError):
                os.unlink(audio_path)
    if report:
        # the frames rendered by this call (a resume skips the journaled ones)
        perf.perf_report(total_frames=frames,
                         total_seconds=time.perf_counter() - t_start)
    if progress_cb is not None:
        progress_cb(1.0)
    return used_gpu
