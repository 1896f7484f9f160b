"""Intra-render segment checkpointing and resume (``--segment-frames``).

The port's copy of pythoncrt_tpu/segments.py. The render is written as
fixed-length segment files with a sidecar journal beside the output, and
a re-run with the same arguments resumes from the first unfinished
segment instead of frame 0 (the reference leaves a partial file and
starts over).

Correctness: the persistence carry (the only cross-frame state,
crt_filter.py:1092) is snapshotted as f32 at every completed segment
boundary, so the resumed device stream is bit-identical to an
uninterrupted one (per-frame rng is keyed by absolute frame index and
needs no state). Only the final container assembly differs: with an
ffmpeg binary the segments are stream-copied (lossless concat); without
one the merge re-encodes through OpenCV (a second generation, this
host's codec fallback tier).

Crash safety: a segment's state snapshot is written before its journal
line (the journal append is the commit point); snapshots are kept per
segment so a crash between the two leaves a consistent prefix. The
render's signature (pipeline.process_video) names the package that
wrote the journal, so a journal of the other package starts afresh.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from .io import video as vio


class SegmentStore:
    """Directory of segment files + JSONL journal beside the output."""

    def __init__(self, output_path: str | Path, sig: dict) -> None:
        self.output_path = Path(output_path)
        self.dir = Path(str(output_path) + ".segments")
        self.journal = self.dir / "journal.jsonl"
        self.sig = dict(sig)

    def seg_path(self, i: int) -> Path:
        return self.dir / f"seg-{i:05d}.mp4"

    def _state_path(self, i: int) -> Path:
        return self.dir / f"state-{i:05d}.npy"

    # -- resume ---------------------------------------------------------

    def resume(self) -> tuple[int, int, Optional[np.ndarray]]:
        """Longest valid completed segment prefix.

        Returns (next_segment_index, frames_to_skip, carry_state). A
        journal whose signature line doesn't match the current render
        arguments (size/fps/params/segment length) is discarded — a
        changed configuration must re-render from scratch.
        """
        if not self.journal.exists():
            self._reset()
            return 0, 0, None
        lines = self.journal.read_text().splitlines()
        if not lines:
            self._reset()
            return 0, 0, None
        try:
            head = json.loads(lines[0])
        except ValueError:
            head = None
        if not head or head.get("sig") != self.sig:
            self._reset()
            return 0, 0, None
        done_frames, next_seg = 0, 0
        for line in lines[1:]:
            try:
                d = json.loads(line)
            except ValueError:
                break
            if d.get("seg") != next_seg or not self.seg_path(next_seg).exists():
                break
            done_frames += int(d["frames"])
            next_seg += 1
        state = None
        if next_seg > 0:
            sp = self._state_path(next_seg - 1)
            if sp.exists():
                try:
                    state = np.load(sp)
                except Exception:
                    # truncated/corrupt snapshot (out-of-band damage):
                    # the journal prefix is unusable — re-render from
                    # scratch rather than crash or resume a wrong carry
                    self._reset()
                    return 0, 0, None
            elif float(self.sig.get("params", {})
                       .get("persistence", 0.0)) > 0.0:
                # the render carries state but its snapshot is gone
                # (e.g. disk cleanup): silently restarting the stream
                # head would diverge from an uninterrupted render
                self._reset()
                return 0, 0, None
            # no snapshot + persistence off => render had no carry;
            # None is correct then.
        return next_seg, done_frames, state

    def _reset(self) -> None:
        if self.dir.exists():
            shutil.rmtree(self.dir, ignore_errors=True)
        self.dir.mkdir(parents=True, exist_ok=True)
        with open(self.journal, "w", encoding="utf-8") as f:
            f.write(json.dumps({"sig": self.sig}) + "\n")

    def begin(self, next_seg: int) -> None:
        """Truncate the journal to the validated prefix (drops trailing
        garbage from a crash) — call once before rendering resumes."""
        if not self.journal.exists():
            self._reset()
            return
        lines = self.journal.read_text().splitlines()
        keep = lines[: 1 + next_seg]
        self.journal.write_text("\n".join(keep) + "\n")

    # -- completion -----------------------------------------------------

    def mark_done(self, i: int, frames: int, state: Optional[np.ndarray]) -> None:
        if state is not None:
            np.save(self._state_path(i), state)
        with open(self.journal, "a", encoding="utf-8") as f:
            f.write(json.dumps({"seg": i, "frames": int(frames)}) + "\n")
        old = self._state_path(i - 2)
        if old.exists():
            try:
                os.unlink(old)
            except OSError:
                pass

    # -- final assembly --------------------------------------------------

    def merge(
        self,
        n_segments: int,
        w: int,
        h: int,
        fps: float,
        audio_path: Optional[str] = None,
        keep_segments: bool = False,
        enc_kwargs: Optional[dict] = None,
    ) -> None:
        """Assemble segments into the final output: ffmpeg concat
        stream-copy when a binary exists (lossless), else a re-encode
        pass (this host's fallback encoder tier). enc_kwargs carries the
        user's codec settings (crf/bitrate/encoder/nvenc) into the
        re-encode pass so the fallback honors them."""
        paths = [self.seg_path(i) for i in range(n_segments)]
        exe = vio.find_ffmpeg()
        merged = False
        if exe:
            lst = self.dir / "concat.txt"
            # concat-demuxer quoting: a literal ' inside file '...'
            # must be written as '\'' or paths with apostrophes break
            # the lossless copy (silently falling to the re-encode)
            q = "'\\''"
            lst.write_text("".join(
                "file '" + str(p.resolve()).replace("'", q) + "'\n"
                for p in paths))
            cmd = [exe, "-hide_banner", "-loglevel", "error", "-y",
                   "-f", "concat", "-safe", "0", "-i", str(lst)]
            if audio_path:
                cmd += ["-i", audio_path, "-c:a", "aac", "-shortest"]
            cmd += ["-c:v", "copy", str(self.output_path)]
            merged = subprocess.run(cmd, capture_output=True).returncode == 0
        if not merged:
            import cv2

            writer, _ = vio.open_writer(
                str(self.output_path), w, h, fps, audio_path=audio_path,
                **(enc_kwargs or {})
            )
            try:
                for p in paths:
                    cap = cv2.VideoCapture(str(p))
                    try:
                        # raw per-frame read — NO fps resampling, every
                        # encoded frame passes through exactly once
                        while True:
                            ok, bgr = cap.read()
                            if not ok:
                                break
                            writer.write_frame(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
                    finally:
                        cap.release()
            finally:
                writer.close()
        if not keep_segments:
            shutil.rmtree(self.dir, ignore_errors=True)
