"""Host media I/O: decode, encode, codec selection, clip probes.

The codecs stay on the host, as in the reference, which delegates to
ffmpeg and OpenCV (crt_filter.py:469-529 raw reader, :938-1014 codec
selection). Two backends, probed at run time with tier-by-tier fallback
(the reference's probe-and-fallback, :141-204, :1024-1032):

1. An ffmpeg executable (FFMPEG_BINARY, imageio-ffmpeg, or PATH):
   rawvideo pipes in rgb24 or planar gbrp, x264/NVENC/AMF parameter
   mapping, audio extract and mux.
2. OpenCV's VideoCapture/VideoWriter: video only; audio degrades to a
   mute output like the reference's audio-failure path
   (crt_filter.py:934-935).

The port's own copy of the parts of pythoncrt_tpu/io/video.py its
pipeline calls: the readers with their start-frame seeks (segment
resume) and the yuv420p pipe, the parallel chunked reader
(--decode-workers), the writers, the probes and the audio passthrough.
"""

from __future__ import annotations

import contextlib
import os
import queue
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from .. import perf

# Failed fourcc probes make libav log ERROR lines through OpenCV's FFMPEG
# backend; quiet them unless the user already configured a level.
os.environ.setdefault("OPENCV_FFMPEG_LOGLEVEL", "-8")


# --------------------------------------------------------------------------
# ffmpeg binary discovery + capability probes
# --------------------------------------------------------------------------

def find_ffmpeg() -> Optional[str]:
    cand = os.environ.get("FFMPEG_BINARY")
    if cand and os.path.isfile(cand):
        return cand
    try:
        import imageio_ffmpeg

        return imageio_ffmpeg.get_ffmpeg_exe()
    except Exception:  # not installed, or its bundled binary is missing
        pass
    return shutil.which("ffmpeg")


_PROBE_CACHE: dict[tuple, bool] = {}


def _probe_encoder(codec: str) -> bool:
    """Tiny lavfi test encode to the null muxer; exit 0 means usable (the
    reference's run-time probe, crt_filter.py:141-204). Memoized per
    (codec, binary)."""
    exe = find_ffmpeg()
    if not exe:
        return False
    key = (codec, exe)
    if key not in _PROBE_CACHE:
        cmd = [exe, "-hide_banner", "-loglevel", "error",
               "-f", "lavfi", "-i", "color=c=black:s=16x16:d=0.05",
               "-c:v", codec, "-f", "null", "-"]
        try:
            _PROBE_CACHE[key] = subprocess.run(cmd, capture_output=True).returncode == 0
        except OSError:
            _PROBE_CACHE[key] = False
    return _PROBE_CACHE[key]


def can_use_nvenc() -> bool:
    return _probe_encoder("h264_nvenc")


def can_use_amf() -> bool:
    return _probe_encoder("h264_amf")


def normalize_nvenc_preset(preset: str) -> str:
    """Map p1..p7 to legacy NVENC preset tokens; pass legacy names through;
    fall back to 'medium' (crt_filter.py:103-138)."""
    p = (preset or "").strip().lower()
    legacy = {
        "default", "slow", "medium", "fast", "hp", "hq", "bd",
        "ll", "llhq", "llhp", "lossless", "losslesshp",
    }
    if p in legacy:
        return p
    return {
        "p1": "hp", "p2": "fast", "p3": "medium", "p4": "default",
        "p5": "hq", "p6": "bd", "p7": "slow",
    }.get(p, "medium")


def map_decoder_to_hwaccel(pref: str) -> Optional[str]:
    """Decoder preference -> ffmpeg -hwaccel token (crt_filter.py:517-529)."""
    p = (pref or "auto").strip().lower()
    return {"nvidia": "cuda", "amd": "dxva2", "intel": "d3d11va"}.get(p)


def select_encoder(preference: str = "auto", gpu: bool = False) -> str:
    """Codec choice with probe-verified hardware fallback to libx264
    (crt_filter.py:938-953)."""
    pref = (preference or "auto").strip().lower()
    if pref == "nvidia":
        return "h264_nvenc" if _probe_encoder("h264_nvenc") else "libx264"
    if pref == "amd":
        return "h264_amf" if _probe_encoder("h264_amf") else "libx264"
    if pref == "cpu":
        return "libx264"
    if gpu and _probe_encoder("h264_nvenc"):
        return "h264_nvenc"
    if gpu and _probe_encoder("h264_amf"):
        return "h264_amf"
    return "libx264"


def encoder_ffparams(codec: str, crf: int, bitrate_kbps: int,
                     nvenc_preset: str = "p4") -> list[str]:
    """Per-codec ffmpeg parameter block (crt_filter.py:956-1002)."""
    kbps = int(max(0, bitrate_kbps or 0))
    rate = ["-b:v", f"{kbps}k", "-maxrate", f"{kbps}k", "-bufsize", f"{kbps * 2}k"]
    if codec == "h264_nvenc":
        nv = normalize_nvenc_preset(nvenc_preset)
        if kbps > 0:
            return rate + ["-rc", "vbr", "-preset", nv, "-pix_fmt", "yuv420p"]
        return ["-cq", str(crf), "-preset", nv, "-pix_fmt", "yuv420p"]
    if codec == "h264_amf":
        return (rate if kbps > 0 else []) + ["-pix_fmt", "yuv420p"]
    if kbps > 0:
        return rate + ["-pix_fmt", "yuv420p"]
    return ["-crf", str(crf), "-pix_fmt", "yuv420p", "-preset", "medium"]


# --------------------------------------------------------------------------
# Probing clips
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ClipInfo:
    width: int
    height: int
    fps: float
    frame_count: int

    @property
    def duration(self) -> float:
        return self.frame_count / self.fps if self.fps > 0 else 0.0


def probe_clip(path: str | Path) -> ClipInfo:
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    try:
        return ClipInfo(
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=float(cap.get(cv2.CAP_PROP_FPS) or 24.0),
            frame_count=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        )
    finally:
        cap.release()


# --------------------------------------------------------------------------
# Readers
# --------------------------------------------------------------------------

class FFmpegRawReader:
    """ffmpeg-subprocess decoder over a rawvideo stdout pipe, with
    optional -hwaccel and fps/scale conversion (the reference's
    FFmpegRawReader, crt_filter.py:469-514).

    pipe_format "rgb24" yields (H, W, 3) RGB frames; "gbrp" yields planar
    (3, H, W) frames in ffmpeg's G, B, R plane order, which the engine's
    planar layout takes untouched (CRTEngine(layout="planar",
    channel_order="gbr")). Both are 3 bytes per pixel; the caller's
    read_into buffer decides the shape. "yuv420p" halves the pipe's bytes
    (1.5 per pixel) and converts to (H, W, 3) RGB on the host with the
    native BT.601 converter (the bytes differ slightly from ffmpeg's own
    rgb24). Reads use the native GIL-released exact-read loop when it
    builds (native/).

    start_frame: first output frame to yield. With the output rate equal
    to the source's, an accurate input seek (-ss) starts the decode
    there; with a resampling -r the frames before it are decoded and
    dropped (an input seek would rebase the -r grid). src_fps: the
    source's rate when the caller has probed it already."""

    def __init__(self, src: str, out_w: int, out_h: int, fps: float,
                 hwaccel: Optional[str] = None, pipe_format: str = "rgb24",
                 start_frame: int = 0, src_fps: Optional[float] = None) -> None:
        exe = find_ffmpeg()
        if not exe:
            raise RuntimeError("no ffmpeg binary available")
        if pipe_format not in ("rgb24", "yuv420p", "gbrp"):
            raise ValueError(f"unsupported pipe_format {pipe_format!r}")
        self.out_w, self.out_h = int(out_w), int(out_h)
        self.pipe_format = pipe_format
        self.frame_shape = ((3, self.out_h, self.out_w) if pipe_format == "gbrp"
                            else (self.out_h, self.out_w, 3))
        self._yuv_buf: Optional[bytearray] = None
        cmd = [exe, "-hide_banner", "-loglevel", "error"]
        if hwaccel and hwaccel != "auto":
            cmd += ["-hwaccel", hwaccel]
        self._skip = 0
        if start_frame > 0:
            if src_fps is None:
                try:
                    src_fps = probe_clip(src).fps
                except (OSError, RuntimeError):
                    src_fps = 0.0
            if abs(src_fps - float(fps)) < 1e-3:
                # half a frame early: rounding the timestamp up past frame
                # k's pts would make the accurate seek drop frame k
                ts = max(0.0, (start_frame - 0.5) / float(fps))
                cmd += ["-ss", f"{ts:.6f}"]
            else:
                self._skip = int(start_frame)
        cmd += ["-i", str(src), "-vf", f"scale={self.out_w}:{self.out_h}",
                "-r", str(fps), "-f", "rawvideo", "-pix_fmt", pipe_format, "-"]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL)
        self._primed: Optional[np.ndarray] = None

    def _prime(self) -> bool:
        """Decode one frame ahead (open_reader's hwaccel probe: a bad
        -hwaccel fails only at the first read); the frame is handed to
        the first read_into call."""
        buf = np.empty(self.frame_shape, np.uint8)
        ok = self.read_into(buf)
        if ok:
            self._primed = buf
        return ok

    def read_into(self, out: np.ndarray) -> bool:
        """Decode the next frame into ``out`` (uint8, C-contiguous, the
        size of one frame). Returns False at the end of the stream."""
        if self._primed is not None:
            out[...] = self._primed
            self._primed = None
            return True
        if self._skip > 0:
            junk = np.empty(self.frame_shape, np.uint8)
            while self._skip > 0:
                self._skip -= 1
                if not self._read_one(junk):
                    return False
        return self._read_one(out)

    def _read_one(self, out: np.ndarray) -> bool:
        from .. import native

        w, h = self.out_w, self.out_h
        if self.pipe_format == "yuv420p":
            nbytes = w * h * 3 // 2
            if self._yuv_buf is None:
                self._yuv_buf = bytearray(nbytes)
            if native.readinto_exact(self.proc.stdout, memoryview(self._yuv_buf)) < nbytes:
                return self._eof_or_raise()
            out[...] = native.yuv420p_to_rgb24(bytes(self._yuv_buf), w, h)
            return True
        if native.readinto_exact(self.proc.stdout, memoryview(out).cast("B")) == w * h * 3:
            return True
        return self._eof_or_raise()

    def _eof_or_raise(self) -> bool:
        """A short read is a clean end only if the decoder exited 0; a
        nonzero exit (unsupported -hwaccel, corrupt input) raises rather
        than pass a truncated render off as a success."""
        try:
            rc = self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            raise RuntimeError("ffmpeg decoder closed its output pipe but did not exit")
        if rc != 0:
            raise RuntimeError(f"ffmpeg decoder exited with code {rc}")
        return False

    def close(self) -> None:
        """Stop and reap the decoder child (ChunkedParallelReader opens one
        per chunk: an unreaped child per chunk would pile up)."""
        if self.proc.stdout:
            self.proc.stdout.close()
        self.proc.terminate()
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=5)


class CV2Reader:
    """OpenCV decoder with nearest-timestamp fps resampling and on-read
    resize; yields (H, W, 3) RGB uint8 frames from output frame
    ``start_frame`` on."""

    def __init__(self, src: str, out_w: int, out_h: int, fps: float,
                 start_frame: int = 0) -> None:
        import cv2

        self._cv2 = cv2
        self.cap = cv2.VideoCapture(str(src))
        if not self.cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {src}")
        self.out_w, self.out_h = int(out_w), int(out_h)
        self.src_fps = float(self.cap.get(cv2.CAP_PROP_FPS) or fps)
        self.out_fps = float(fps)
        self._src_i = -1
        self._out_i = int(start_frame)
        self._frame = None
        want0 = int(round(self._out_i * (self.src_fps / self.out_fps)))
        if want0 > 0 and self.cap.set(cv2.CAP_PROP_POS_FRAMES, want0):
            # a positioned read (O(remaining) resume), checked: a landing
            # short of the source frame decodes forward to it; a landing
            # past it, or none, reopens and decodes from frame 0
            pos = int(self.cap.get(cv2.CAP_PROP_POS_FRAMES))
            if 0 <= pos <= want0:
                self._src_i = pos - 1
            else:
                self.cap.release()
                self.cap = cv2.VideoCapture(str(src))
                if not self.cap.isOpened():
                    raise FileNotFoundError(f"cannot open video: {src}")

    def read_into(self, out: np.ndarray) -> bool:
        """Decode the next output frame into ``out`` ((H, W, 3) uint8);
        the BGR->RGB convert (and resize, if any) write straight into the
        caller's batch buffer. Returns False at the end of the stream."""
        cv2 = self._cv2
        want = int(round(self._out_i * (self.src_fps / self.out_fps)))
        while self._src_i < want:
            ok, bgr = self.cap.read()
            if not ok:
                return False
            self._src_i += 1
            self._frame = bgr
        f = self._frame
        if f.shape[1] != self.out_w or f.shape[0] != self.out_h:
            f = cv2.resize(f, (self.out_w, self.out_h), interpolation=cv2.INTER_LINEAR)
        cv2.cvtColor(f, cv2.COLOR_BGR2RGB, dst=out)
        self._out_i += 1
        return True

    def close(self) -> None:
        self.cap.release()


class ChunkedParallelReader:
    """N seek-positioned decode workers over interleaved chunks of the
    frame range, handing over whole batches in stream order
    (pythoncrt_tpu/io/video.py ChunkedParallelReader, ``--decode-workers``).

    Worker w decodes chunks w, w + N, w + 2N, ... (a chunk is
    ``chunk_batches`` batches, fewer where a chunk would pass 256 MB),
    each through its own reader opened at the chunk's first frame, and
    ``iter_batches`` yields (absolute frame index, (<= B, *frame_shape)
    uint8 view) strictly in order. ``total_frames`` is an estimate: the
    last chunk reads on to the true end. An output rate that resamples
    the source degrades to one sequential reader (a seek would rebase the
    -r grid, and decode-and-discard per chunk would cost the whole prefix
    per chunk)."""

    def __init__(self, src: str, out_w: int, out_h: int, fps: float,
                 total_frames: int, batch_size: int, *, workers: int = 2,
                 chunk_batches: int = 4, decoder_preference: str = "auto",
                 pipe_format: str = "rgb24", start_frame: int = 0) -> None:
        self.src, self.out_w, self.out_h, self.fps = str(src), int(out_w), int(out_h), float(fps)
        self.pref, self.pipe_format = decoder_preference, pipe_format
        self.frame_shape = ((3, self.out_h, self.out_w) if pipe_format == "gbrp"
                            else (self.out_h, self.out_w, 3))
        self.batch = int(batch_size)
        # each worker holds up to 3 chunks (queue of 2 + in flight)
        frame_bytes = self.out_h * self.out_w * 3
        cb = max(1, int(chunk_batches))
        while cb > 1 and cb * self.batch * frame_bytes > 256 << 20:
            cb -= 1
        self.chunk = self.batch * cb
        self.start = int(start_frame)
        # a resume may have journaled more frames than a re-probe
        # estimates: start past the total is a clean empty stream
        self.total = max(int(total_frames), self.start)
        self.n_chunks = max(1, -(-(self.total - self.start) // self.chunk))
        try:
            src_fps = probe_clip(src).fps
        except (OSError, RuntimeError):
            src_fps = float(fps)
        self._src_fps = float(src_fps)
        self._sequential = abs(src_fps - float(fps)) > 1e-3
        self.workers = 1 if self._sequential else max(1, min(int(workers), self.n_chunks))
        self._qs = [queue.Queue(maxsize=2) for _ in range(self.workers)]
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._worker, args=(w,), daemon=True)
                         for w in range(self.workers)]
        for t in self._threads:
            t.start()

    def _put(self, q: queue.Queue, item) -> bool:
        """Blocking put that gives up once the consumer stopped."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _read(self, rdr, n: int) -> np.ndarray:
        """Up to n frames of ``rdr`` into a new array (fewer at the end)."""
        buf = np.empty((n, *self.frame_shape), np.uint8)
        got = 0
        while got < n and not self._stop.is_set() and rdr.read_into(buf[got]):
            got += 1
        return buf[:got]

    def _worker(self, wid: int) -> None:
        q = self._qs[wid]
        seq = None
        try:
            if self._sequential:
                seq = open_reader(self.src, self.out_w, self.out_h, self.fps, self.pref,
                                  self.pipe_format, start_frame=self.start)
            for ci in range(wid, self.n_chunks, self.workers):
                if self._stop.is_set():
                    break
                f0 = self.start + ci * self.chunk
                f1 = min(f0 + self.chunk, self.total)
                rdr = seq or open_reader(self.src, self.out_w, self.out_h, self.fps,
                                         self.pref, self.pipe_format, start_frame=f0,
                                         src_fps=self._src_fps)
                try:
                    frames = self._read(rdr, f1 - f0)
                    if not self._put(q, (ci, f0, frames)) or len(frames) < f1 - f0:
                        break  # consumer gone, or the stream ended early
                    if ci == self.n_chunks - 1:
                        # past the estimate: chunk-sized continuation items
                        # until the true end
                        ext = self.n_chunks
                        while not self._stop.is_set():
                            more = self._read(rdr, self.chunk)
                            ef0 = self.total + (ext - self.n_chunks) * self.chunk
                            if len(more) and not self._put(q, (ext, ef0, more)):
                                break
                            if len(more) < self.chunk:
                                break
                            ext += 1
                finally:
                    if rdr is not seq:
                        rdr.close()
        except Exception as e:  # re-raised by iter_batches, never a fake end
            self._err = e
        finally:
            if seq is not None:
                with contextlib.suppress(Exception):
                    seq.close()
            self._put(q, None)

    def iter_batches(self, batch_size: int):
        """Yield (absolute frame index, (<= batch_size, *frame_shape)
        uint8 view) in stream order."""
        if batch_size != self.batch:
            raise ValueError(f"iter_batches({batch_size}) on a reader of batch {self.batch}")
        ci = 0
        while True:
            # continuation items come from the worker of the last chunk
            item = self._qs[min(ci, self.n_chunks - 1) % self.workers].get()
            if item is None:
                if self._err is not None:
                    raise RuntimeError("parallel decode worker failed") from self._err
                return
            got_ci, f0, frames = item
            if got_ci != ci:
                raise RuntimeError(f"parallel decode: chunk {got_ci} arrived for {ci}")
            for b0 in range(0, frames.shape[0], self.batch):
                yield f0 + b0, frames[b0:b0 + self.batch]
            expect = self.chunk if ci >= self.n_chunks else min(self.chunk, self.total - f0)
            if frames.shape[0] < expect:
                return  # early end, or the last continuation
            ci += 1

    def close(self) -> None:
        self._stop.set()
        for q in self._qs:
            with contextlib.suppress(queue.Empty):
                while True:
                    q.get_nowait()
        for t in self._threads:
            t.join(timeout=10)


def open_reader(src: str, out_w: int, out_h: int, fps: float,
                decoder_preference: str = "auto", pipe_format: str = "rgb24",
                start_frame: int = 0, src_fps: Optional[float] = None):
    """Tier-by-tier reader selection: hwaccel ffmpeg -> plain ffmpeg ->
    OpenCV (the reference's fallback chain, crt_filter.py:1024-1036).
    Without an ffmpeg binary, "rgb24" and "yuv420p" both take the OpenCV
    tier (RGB frames); "gbrp" needs the binary. start_frame: the first
    output frame to yield (a decoder-side seek)."""
    accel = map_decoder_to_hwaccel(decoder_preference)
    if find_ffmpeg():
        try:
            rd = FFmpegRawReader(src, out_w, out_h, fps, accel, pipe_format, start_frame,
                                 src_fps)
            if accel:
                # an unsupported -hwaccel exits nonzero only once decoding
                # starts: prime one frame and fall to plain ffmpeg on failure
                try:
                    rd._prime()
                except RuntimeError:
                    rd.close()
                    rd = FFmpegRawReader(src, out_w, out_h, fps, None, pipe_format,
                                         start_frame, src_fps)
            return rd
        except (OSError, RuntimeError):
            if pipe_format == "gbrp":
                raise  # planar frames need the ffmpeg pipe; no cv2 shape
    elif pipe_format == "gbrp":
        raise RuntimeError("pipe_format 'gbrp' requires an ffmpeg binary")
    return CV2Reader(src, out_w, out_h, fps, start_frame)


# --------------------------------------------------------------------------
# Writers
# --------------------------------------------------------------------------

class FFmpegRawWriter:
    """ffmpeg-subprocess encoder over a rawvideo stdin pipe (the
    FFMPEG_VideoWriter role, crt_filter.py:1014). pix_fmt "rgb24" takes
    (H, W, 3) frames; "gbrp" takes planar (3, H, W) frames in G, B, R
    plane order, the engine's planar output."""

    def __init__(self, dst: str, w: int, h: int, fps: float, codec: str,
                 ffparams: list[str], audio_path: Optional[str] = None,
                 pix_fmt: str = "rgb24") -> None:
        exe = find_ffmpeg()
        if not exe:
            raise RuntimeError("no ffmpeg binary available")
        if pix_fmt not in ("rgb24", "gbrp"):
            raise ValueError(f"unsupported pix_fmt {pix_fmt!r}")
        cmd = [exe, "-hide_banner", "-loglevel", "error", "-y",
               "-f", "rawvideo", "-pix_fmt", pix_fmt, "-s", f"{w}x{h}",
               "-r", str(fps), "-i", "-"]
        if audio_path:
            cmd += ["-i", audio_path, "-c:a", "aac", "-shortest"]
        cmd += ["-c:v", codec] + list(ffparams) + [str(dst)]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL)

    def write_frame(self, frame_u8: np.ndarray) -> None:
        a = frame_u8 if frame_u8.flags["C_CONTIGUOUS"] else np.ascontiguousarray(frame_u8)
        self.proc.stdin.write(a.data)

    def close(self) -> None:
        """Flush and reap the encoder; a nonzero exit (or a hang) raises,
        so a failed encode is never reported as a success."""
        try:
            self.proc.stdin.close()
        except BrokenPipeError:
            pass  # the child already died; its exit code tells the story
        try:
            rc = self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise RuntimeError("ffmpeg encoder did not exit within 60s")
        if rc != 0:
            raise RuntimeError(f"ffmpeg encoder exited with code {rc}")


class CV2Writer:
    """OpenCV encoder fallback (avc1, mp4v or MJPG), RGB in, video only."""

    def __init__(self, dst: str, w: int, h: int, fps: float) -> None:
        import cv2

        self._cv2 = cv2
        self.writer = None
        # silence the failed fourcc probes (builds without cv2.utils.logging
        # just log them)
        log = getattr(getattr(cv2, "utils", None), "logging", None)
        prev_level = log.getLogLevel() if log else None
        if log:
            log.setLogLevel(log.LOG_LEVEL_SILENT)
        try:
            for fourcc in ("avc1", "mp4v", "MJPG"):
                wtr = cv2.VideoWriter(str(dst), cv2.VideoWriter_fourcc(*fourcc),
                                      float(fps), (int(w), int(h)))
                if wtr.isOpened():
                    self.writer = wtr
                    break
        finally:
            if log:
                log.setLogLevel(prev_level)
        if self.writer is None:
            raise RuntimeError(f"cv2.VideoWriter could not open {dst}")

    def write_frame(self, rgb_u8: np.ndarray) -> None:
        self.writer.write(self._cv2.cvtColor(rgb_u8, self._cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        self.writer.release()


def open_writer(dst: str, w: int, h: int, fps: float, *,
                encoder_preference: str = "auto", gpu: bool = False, crf: int = 18,
                bitrate_kbps: int = 0, nvenc_preset: str = "p4",
                audio_path: Optional[str] = None,
                pix_fmt: str = "rgb24") -> tuple[object, bool]:
    """Returns (writer, used_gpu). pix_fmt "gbrp" (planar frames) needs
    the ffmpeg pipe: there is no cv2 fallback for it."""
    if find_ffmpeg():
        codec = select_encoder(encoder_preference, gpu)
        params = encoder_ffparams(codec, crf, bitrate_kbps, nvenc_preset)
        try:
            return (FFmpegRawWriter(dst, w, h, fps, codec, params, audio_path,
                                    pix_fmt=pix_fmt),
                    codec in ("h264_nvenc", "h264_amf"))
        except (OSError, RuntimeError):
            if pix_fmt != "rgb24":
                raise
    elif pix_fmt != "rgb24":
        raise RuntimeError(f"pix_fmt {pix_fmt!r} requires an ffmpeg binary")
    return CV2Writer(dst, w, h, fps), False


# --------------------------------------------------------------------------
# Audio passthrough (ffmpeg only; degrades to mute like the reference)
# --------------------------------------------------------------------------

def extract_audio(src: str | Path) -> Optional[str]:
    """Extract the audio track to a temporary AAC file (crt_filter.py:926-935);
    returns None (mute output) without ffmpeg or without an audio track."""
    exe = find_ffmpeg()
    if not exe:
        return None
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".aac")
    os.close(fd)
    try:
        with perf.timed("io.audio_extract"):
            res = subprocess.run(
                [exe, "-hide_banner", "-loglevel", "error", "-y", "-i", str(src),
                 "-vn", "-c:a", "aac", "-b:a", "128k", "-ar", "44100", path],
                capture_output=True)
        if res.returncode == 0 and os.path.getsize(path) > 0:
            return path
    except OSError:
        pass
    try:
        os.unlink(path)
    except OSError:
        pass
    return None
