"""Multi-clip batch render: N decoders -> one lockstep engine step -> N
encoders.

Port of pythoncrt_tpu/multiclip.py (BASELINE.json config 5 as a render):
each step consumes one batch of up to B frames from every clip and runs
them as one flat clip-major batch through ``MultiClipEngine``
(parallel/mesh.py), whose persistence kernel keeps each clip's carry.
With several visible cards the clip axis is sharded across them
(``best_mesh_size`` of them, capped by ``devices``): each card takes whole
clips, and no data crosses cards but the gather of the outputs.

Host pipeline, on the single-clip render's pieces (pipeline.py), with
``steps_per_call`` n (0: ``auto_steps_per_call``, the JAX package's
host-RAM rule) batches per device call:

  N decode threads (``_feeder``, each filling its clip's pool of pinned
  host super-batches of n * B frames)
      -> per-clip queues of max(2, 4 // n) super-batches
      -> collector thread (``_collector``): a ("stack", ...) item when
         every live clip delivered a full super-batch, else one
         ("batch", ...) item per batch of the super-batches (the ragged
         tails); no copy: the buffers travel as they are
      -> main loop: each clip's frames copied to its slot of one device
         (n, C, B, ...) stack or (C, B, ...) batch, ``process_stack`` (n
         steps enqueued back to back) or ``process``, each clip's frames
         copied back into a pinned buffer of its pool (one CUDA stream, no
         wait: the loop waits for call N's copy back only after queuing
         call N+1)
      -> N encode threads (``_writer_loop``, which recycle the buffers)

Clips may have different lengths: a finished clip's slot pads with zeros
(its writer stops at the real frame count); its buffers stay in its own
pool and are dropped with it. Outputs do not depend on n: every draw is
keyed by frame index and each clip's carry runs over its own frames in
order. Per-clip decode, encode, open and probe failures mark that clip
failed without ending the others; batch.render_batch adds journal resume
and per-clip retry on top and is the CLI surface (--batch-manifest).
"""

from __future__ import annotations

import contextlib
import math
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import perf
from .engine import CRTEngine
from .io import video as vio
from .params import EffectParams
from .pipeline import _feeder, _get_or_stop, _put_or_stop, _writer_loop, planar_pipe_gate
from .text import overlay_for

OUT_POOL = 3  # pinned output batches per clip


@dataclass
class ClipRenderResult:
    input_path: str
    output_path: str
    ok: bool
    frames: int
    used_gpu: bool = False
    error: str = ""


class _AggregateProgress:
    """Fan-in for per-clip writer progress -> one overall callback."""

    def __init__(self, totals: Sequence[int], cb: Optional[Callable]):
        self._totals = list(totals)
        self._done = [0.0] * len(totals)
        self._cb = cb
        self._lock = threading.Lock()

    def for_clip(self, i: int):
        if self._cb is None:
            return None

        def update(frac: float) -> None:
            with self._lock:
                self._done[i] = frac * self._totals[i]
                total = sum(self._totals)
                cur = sum(self._done)
            self._cb(min(1.0, cur / total) if total else 1.0)

        return update


def best_mesh_size(n_clips: int, devices: int = 0) -> int:
    """The largest divisor of n_clips that fits the visible CUDA device
    count, capped by ``devices`` when above 0 (MultiClipEngine needs
    C % ndev == 0)."""
    ndev = torch.cuda.device_count()
    if devices > 0:
        ndev = min(ndev, devices)
    best = 1
    for k in range(1, min(ndev, n_clips) + 1):
        if n_clips % k == 0:
            best = k
    return best


def _resolve_output_rate(infos, live, fps) -> float:
    """Common output rate for a lockstep batch. The rounding is only
    for the agreement check across sources; the returned rate is the
    exact first source rate, like process_video uses: fps_out drives the
    reader resample rate and the glitch-phase seeds (idx/fps), so 29.97
    vs the exact 30000/1001 would make a grouped render differ from its
    sequential retry."""
    if fps and fps > 0:
        return float(fps)
    rates = {round(infos[i].fps or 24.0, 4) for i in live}
    if len(rates) != 1:
        raise ValueError(
            f"source frame rates differ ({sorted(rates)}); pass an "
            "explicit fps")
    return float(infos[live[0]].fps or 24.0)


def auto_steps_per_call(h: int, w: int, clips: int, batch: int) -> int:
    """The JAX package's auto steps-per-call rule for lockstep renders:
    the host-RAM budget of its single-clip render (8 batches of 32 at
    <=1080p), scaled by the clip-major device batch, keeping about
    spc * C * B frames in flight."""
    budget = 256 if h * w <= 1920 * 1080 else 64
    return max(1, min(8, budget // max(1, clips * batch)))


def _collector(queues, step_q: queue.Queue, stop: threading.Event, err: dict,
               spc: int, batch: int) -> None:
    """Assemble the device calls from the per-clip queues of super-batches
    (JAX multiclip.py:130-200): ("stack", items, idx0s) when every live
    clip delivered a full super-batch of spc * batch frames, else, over
    the ragged tails, one ("batch", items, idx0s) per batch. items[i] is
    clip i's (buffer, first frame in it, frames, whether the buffer is
    done after this call), or None where clip i has no frames (its slot
    pads); idx0s[i] the absolute index of clip i's first frame there. Runs
    on its own thread so a slow decoder does not hold the device loop."""
    c = len(queues)
    feed = spc * batch
    active = [True] * c
    next_idx = [0] * c
    try:
        while not stop.is_set() and any(active):
            got = [None] * c
            for i in range(c):
                if not active[i]:
                    continue
                # stop-aware get: a feeder that bailed on `stop` may never
                # deliver its end-of-stream sentinel
                item = _get_or_stop(queues[i], stop)
                if item is None:
                    if stop.is_set():
                        return
                    active[i] = False
                    continue
                got[i] = item
                next_idx[i] = item[0]
            live = [g for g in got if g is not None]
            if not live:
                break
            idx0s = np.array(next_idx, np.int64)
            if spc > 1 and all(g[2] == feed for g in live):
                items = [None if g is None else (g[1], 0, feed, True) for g in got]
                if not _put_or_stop(step_q, ("stack", items, idx0s), stop):
                    return
                continue
            for lo in range(0, max(g[2] for g in live), batch):
                items = [None if g is None or g[2] <= lo else
                         (g[1], lo, min(batch, g[2] - lo), lo + batch >= g[2]) for g in got]
                if not _put_or_stop(step_q, ("batch", items, idx0s + lo), stop):
                    return
    except Exception as e:
        err["collect"] = e
    finally:
        _put_or_stop(step_q, None, stop)


def process_videos(
    inputs: Sequence[str | Path],
    outputs: Sequence[str | Path],
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
    batch_size: int = 8,
    engine_mode: str = "export",
    rng: str = "native",
    seed: int = 0,
    precision: str = "exact",
    pipe_format: str = "rgb24",
    devices: int = 0,
    steps_per_call: int = 0,
    device="cuda",
    progress_cb: Optional[Callable[[float], None]] = None,
    report: bool = True,
) -> list[ClipRenderResult]:
    """Render N clips in lockstep through one engine.

    All clips share the effect params and the output (width, height,
    fps): that is what lets one step serve the whole batch. With no
    explicit size/fps every source must agree; otherwise pass them (or
    render heterogeneous jobs through batch.render_batch, which groups by
    signature). Per-frame math is that of N separate process_video runs:
    effects are frame-local, rng streams are keyed by frame index, and
    each clip's persistence carry has its own state slot.

    Returns one ClipRenderResult per clip, in input order. A clip whose
    probe, decoder or encoder fails is marked failed without ending the
    others. ``devices`` caps the cards the clip axis is sharded across
    (0: every visible card; best_mesh_size) when ``device`` is "cuda";
    a device that names one card, or the CPU, renders there alone.
    ``steps_per_call`` n runs n batches of every clip per device call
    (0: auto_steps_per_call); it does not change the output."""
    if pipe_format not in ("rgb24", "yuv420p"):
        raise ValueError(f"pipe_format must be 'rgb24' or 'yuv420p', got {pipe_format!r}")
    inputs = [Path(p) for p in inputs]
    outputs = [Path(p) for p in outputs]
    if len(inputs) != len(outputs):
        raise ValueError("inputs and outputs must pair up")
    if not inputs:
        return []
    c = len(inputs)

    results = [ClipRenderResult(str(i), str(o), ok=True, frames=0)
               for i, o in zip(inputs, outputs)]
    infos: list = []
    for i, p in enumerate(inputs):
        try:
            infos.append(vio.probe_clip(p))
        except Exception as e:
            # a missing or corrupt clip fails alone; its slot pads
            infos.append(None)
            results[i].ok = False
            results[i].error = f"probe: {e}"
    live = [i for i, inf in enumerate(infos) if inf is not None]
    if not live:
        return results
    if width and height:
        out_w, out_h = int(width), int(height)
    else:
        sizes = {(infos[i].width, infos[i].height) for i in live}
        if len(sizes) != 1:
            raise ValueError(
                f"source sizes differ ({sorted(sizes)}); pass explicit "
                "width/height to render them at a common size")
        (out_w, out_h), = sizes
        out_w = int(width) if width else out_w
        out_h = int(height) if height else out_h
    fps_out = _resolve_output_rate(infos, live, fps)
    totals = [max(1, int(math.ceil(inf.duration * fps_out))) if inf else 0 for inf in infos]

    perf.perf_reset()
    t_start = time.perf_counter()
    planar = planar_pipe_gate(pipe_format)  # the single-clip render's gate and layout
    text_rgba = overlay_for(out_w, out_h, params.text)
    with perf.timed("fx.compile"):
        from .parallel import CLIP_AXIS, MultiClipEngine, make_mesh, may_shard

        eng = CRTEngine(params, out_h, out_w, fps_out, engine=engine_mode, rng=rng,
                        seed=seed, text_rgba=text_rgba, precision=precision,
                        layout="planar" if planar else "nhwc",
                        channel_order="gbr" if planar else "rgb", device=device)
        if eng.device.type == "cuda":
            from .kernels import _build

            _build.library()  # nvcc at first use, charged here
        ndev = best_mesh_size(c, devices) if may_shard(eng.device) else 1
        mc = MultiClipEngine(eng, make_mesh(ndev, axis=CLIP_AXIS) if ndev > 1 else None)
    dev, cuda = eng.device, eng.device.type == "cuda"
    fshape = eng._frame_shape()
    pipe = "gbrp" if planar else pipe_format
    pix_fmt = "gbrp" if planar else "rgb24"
    spc = int(steps_per_call)
    if spc <= 0:
        spc = auto_steps_per_call(out_h, out_w, c, batch_size)
    feed = spc * batch_size
    depth = max(2, 4 // spc)  # decoded super-batches queued per clip (JAX multiclip.py:379)

    def host_batch():
        return torch.empty((feed, *fshape), dtype=torch.uint8, pin_memory=cuda)

    audio_paths = [vio.extract_audio(p) if infos[i] is not None else None
                   for i, p in enumerate(inputs)]
    readers: list = [None] * c
    writers: list = [None] * c
    feed_qs = [queue.Queue(maxsize=depth) for _ in range(c)]
    in_free = [queue.Queue() for _ in range(c)]
    out_free = [queue.Queue() for _ in range(c)]
    enc_qs = [queue.Queue() for _ in range(c)]
    feed_errs = [dict() for _ in range(c)]
    enc_errs = [dict() for _ in range(c)]
    stop = threading.Event()
    agg = _AggregateProgress(totals, progress_cb)
    threads: list[threading.Thread] = []
    enc_threads: list[threading.Thread] = []
    step_q: queue.Queue = queue.Queue(maxsize=2)
    coll_err: dict = {}

    try:
        for i, (inp, outp) in enumerate(zip(inputs, outputs)):
            if infos[i] is None:  # dead at probe: an immediate end of stream
                feed_qs[i].put(None)
                continue
            try:
                # an unwritable output path fails this clip, not the batch
                outp.parent.mkdir(parents=True, exist_ok=True)
                readers[i] = vio.open_reader(str(inp), out_w, out_h, fps_out,
                                             decoder_preference, pipe)
            except Exception as e:
                results[i].ok = False
                results[i].error = f"open reader: {e}"
            if readers[i] is not None:
                # no encoder for a clip whose reader failed: that would
                # leave an empty output file next to an ok=False result
                try:
                    writers[i], results[i].used_gpu = vio.open_writer(
                        str(outp), out_w, out_h, fps_out,
                        encoder_preference=encoder_preference, gpu=gpu, crf=crf,
                        bitrate_kbps=target_bitrate_kbps, nvenc_preset=nvenc_preset,
                        audio_path=audio_paths[i], pix_fmt=pix_fmt)
                except Exception as e:
                    results[i].ok = False
                    results[i].error = f"open writer: {e}"
            if readers[i] is None or writers[i] is None:
                feed_qs[i].put(None)  # dead clip: an immediate end of stream
                continue
            for _ in range(depth + 2):
                in_free[i].put(host_batch())
            for _ in range(OUT_POOL):
                out_free[i].put(host_batch())
            t = threading.Thread(target=_feeder, daemon=True,
                                 args=(readers[i], in_free[i], feed_qs[i], stop, 0,
                                       feed_errs[i]))
            threads.append(t)
            t.start()
            t = threading.Thread(target=_writer_loop, daemon=True,
                                 args=(writers[i], enc_qs[i], out_free[i], agg.for_clip(i),
                                       totals[i], enc_errs[i]))
            enc_threads.append(t)
            t.start()

        t_coll = threading.Thread(target=_collector, daemon=True,
                                  args=(feed_qs, step_q, stop, coll_err, spc, batch_size))
        threads.append(t_coll)
        t_coll.start()

        stream = torch.cuda.Stream(dev) if cuda else None
        pending: deque = deque()
        states = None

        def out_buffer(i: int):
            while True:
                try:
                    return out_free[i].get(timeout=0.5)
                except queue.Empty:
                    if "encode" in enc_errs[i]:
                        return None

        def retire():
            ev, ins, outs = pending.popleft()
            if ev is not None:
                with perf.timed("fx.device_wait"):
                    ev.synchronize()
            for i, buf in ins:
                in_free[i].put(buf)
            for i, buf, got in outs:
                enc_qs[i].put((buf, got))
                results[i].frames += got

        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            while True:
                item = step_q.get()
                if item is None:
                    break
                kind, items, idx0s = item
                n = spc if kind == "stack" else 1
                with perf.timed("fx.dispatch"):
                    # each clip's frames go to their slot, batch by batch
                    x = torch.empty((n, c, batch_size, *fshape), dtype=torch.uint8, device=dev)
                    ins = []
                    for i, it in enumerate(items):
                        if it is None:  # a finished clip's slot pads with zeros
                            x[:, i].zero_()
                            continue
                        buf, lo, got, done = it
                        for s in range(n):
                            b0, b1 = s * batch_size, min(got, (s + 1) * batch_size)
                            x[s, i, :b1 - b0].copy_(buf[lo + b0:lo + b1], non_blocking=True)
                        if got < batch_size:  # a ragged tail (n is 1)
                            x[0, i, got:].zero_()
                        if done:
                            ins.append((i, buf))
                    idx = (idx0s[None, :, None]
                           + np.arange(n * batch_size).reshape(n, 1, batch_size))
                    if kind == "stack":
                        out, states = mc.process_stack(x, idx, states)
                    else:
                        out, states = mc.process(x[0], idx[0], states)
                        out = out[None]
                    outs = []
                    for i, it in enumerate(items):
                        if it is None or "encode" in enc_errs[i]:
                            continue
                        out_buf = out_buffer(i)
                        if out_buf is not None:
                            got = it[2]
                            for s in range(n):
                                b0, b1 = s * batch_size, min(got, (s + 1) * batch_size)
                                out_buf[b0:b1].copy_(out[s, i, :b1 - b0], non_blocking=True)
                            outs.append((i, out_buf, got))
                    ev = None
                    if cuda:
                        ev = torch.cuda.Event()
                        ev.record(stream)
                pending.append((ev, ins, outs))
                if len(pending) > 1:
                    retire()
            while pending:
                retire()
    finally:
        stop.set()
        for q in enc_qs:
            q.put(None)
        for t in enc_threads:
            t.join(timeout=120)
        for t in threads:
            t.join(timeout=30)
        for i in range(c):
            if readers[i] is not None:
                with contextlib.suppress(Exception):
                    readers[i].close()
            if writers[i] is not None:
                try:
                    writers[i].close()
                except Exception as e:
                    enc_errs[i].setdefault("encode", e)
        for ap in audio_paths:
            if ap:
                with contextlib.suppress(OSError):
                    os.unlink(ap)

    if "collect" in coll_err:
        raise RuntimeError("collector failed") from coll_err["collect"]
    for i in range(c):
        for key, errs in (("decode", feed_errs[i]), ("encode", enc_errs[i])):
            if key in errs:
                results[i].ok = False
                results[i].error = ((results[i].error + "; " if results[i].error else "")
                                    + f"{key}: {errs[key]}")

    if report:
        perf.perf_report(total_frames=sum(r.frames for r in results),
                         total_seconds=time.perf_counter() - t_start)
    if progress_cb is not None:
        progress_cb(1.0)
    return results
