"""Batch multi-clip rendering with per-clip fault tolerance and resume.

Port of pythoncrt_tpu/batch.py: a failed clip does not end the batch
(it retries alone on the sequential path), and an append-only journal of
finished renders lets a re-run skip what is done. The journal keys on
(input, output, signature), where the signature hashes the params,
geometry and render kwargs as the JAX package does; the torch ``device``
kwarg is left out of it (the card's kernels equal their CPU twins), so a
journal written by either package's CLI is read by the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

from .params import EffectParams


@dataclass
class ClipJob:
    input_path: str
    output_path: str
    params: EffectParams
    width: Optional[int] = None
    height: Optional[int] = None
    fps: Optional[float] = None
    kwargs: dict = field(default_factory=dict)


@dataclass
class ClipResult:
    job: ClipJob
    ok: bool
    seconds: float
    error: str = ""
    skipped: bool = False  # already complete per journal


class RenderJournal:
    """Append-only JSONL journal of completed renders keyed by (input,
    output, params signature). A params, preset or geometry change makes
    a new signature, so a re-run with other flags re-renders instead of
    keeping stale outputs."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self._done: set[tuple[str, str, str]] = set()
        if self.path.exists():
            for line in self.path.read_text().splitlines():
                try:
                    d = json.loads(line)
                    # a corrupt line may still parse as JSON (null, a
                    # number): anything but an object is skipped
                    if isinstance(d, dict) and d.get("status") == "done":
                        self._done.add((d["input"], d["output"], d.get("sig", "")))
                except (ValueError, KeyError):
                    continue

    def _key(self, job: ClipJob) -> tuple[str, str, str]:
        return (str(job.input_path), str(job.output_path), _job_sig(job))

    def is_done(self, job: ClipJob) -> bool:
        return self._key(job) in self._done

    def mark_done(self, job: ClipJob, seconds: float) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        key = self._key(job)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps({
                "status": "done",
                "input": key[0],
                "output": key[1],
                "sig": key[2],
                "seconds": round(seconds, 3),
            }) + "\n")
        self._done.add(key)


# process_video kwargs that the lockstep group path also accepts; a job
# carrying anything else (assoc_scan, profile_dir, ...) renders through
# the per-clip sequential path instead
MULTI_CLIP_KWARGS = frozenset({
    "crf", "target_bitrate_kbps", "gpu", "nvenc_preset",
    "encoder_preference", "decoder_preference", "batch_size",
    "engine_mode", "rng", "seed", "precision", "pipe_format",
    "devices", "steps_per_call", "device",
})


def _group_key(job: ClipJob) -> str:
    """Signature under which jobs can share one lockstep step: identical
    params, output geometry and render kwargs (the JAX package's, with
    ``device`` left out; render_batch groups by device on top)."""
    return json.dumps(
        {
            "p": dataclasses.asdict(job.params.clamped()),
            "w": job.width, "h": job.height, "fps": job.fps,
            "kw": {k: v for k, v in job.kwargs.items() if k != "device"},
        },
        sort_keys=True, default=str,
    )


def _job_sig(job: ClipJob) -> str:
    """Short hash of _group_key for journal lines."""
    return hashlib.sha1(_group_key(job).encode()).hexdigest()[:12]


def render_batch(
    jobs: Sequence[ClipJob],
    *,
    journal: Optional[str | Path] = None,
    max_retries: int = 1,
    progress_cb=None,
    process_fn=None,
    sharded: bool = True,
    process_videos_fn=None,
) -> list[ClipResult]:
    """Render a batch of clips with per-clip retry and journal resume.

    sharded=True (default) groups jobs that share (params, size, fps,
    kwargs, device) and renders each group in lockstep
    (multiclip.process_videos: N decoders -> MultiClipEngine -> N
    encoders). Heterogeneous jobs, groups of one and clips that fail
    inside a group render on the sequential per-clip path (with its
    retries), so one bad clip never ends the batch. Injecting process_fn
    (tests) disables grouping unless process_videos_fn is also injected."""
    injected = process_fn is not None
    if process_fn is None:
        from .pipeline import process_video as process_fn  # noqa: F811
    if sharded and process_videos_fn is None and not injected:
        from .multiclip import process_videos as process_videos_fn  # noqa: F811

    jr = RenderJournal(journal) if journal else None
    n = len(jobs)
    results: list[Optional[ClipResult]] = [None] * n
    done_ct = 0

    def bump() -> None:
        nonlocal done_ct
        done_ct += 1
        if progress_cb is not None:
            progress_cb(done_ct / n)

    pending: list[int] = []
    for i, job in enumerate(jobs):
        if jr is not None and jr.is_done(job):
            results[i] = ClipResult(job, ok=True, seconds=0.0, skipped=True)
            bump()
        else:
            pending.append(i)

    def group_of(job: ClipJob) -> tuple[str, str]:
        return _group_key(job), str(job.kwargs.get("device"))

    seq = list(pending)
    if sharded and process_videos_fn is not None and len(pending) > 1:
        groups: dict[tuple[str, str], list[int]] = {}
        for i in pending:
            if set(jobs[i].kwargs) <= MULTI_CLIP_KWARGS:
                groups.setdefault(group_of(jobs[i]), []).append(i)
        seq = []
        handled: set[int] = set()
        for i in pending:
            if i in handled:
                continue
            grp = (groups.get(group_of(jobs[i]), [i])
                   if set(jobs[i].kwargs) <= MULTI_CLIP_KWARGS else [i])
            handled.update(grp)
            if len(grp) < 2:
                seq.append(i)
                continue
            t0 = time.perf_counter()
            try:
                j0 = jobs[grp[0]]
                rs = process_videos_fn(
                    [jobs[g].input_path for g in grp],
                    [jobs[g].output_path for g in grp],
                    j0.params, width=j0.width, height=j0.height,
                    fps=j0.fps, report=False, **j0.kwargs,
                )
            except Exception:
                # a group-level failure (e.g. source sizes that differ
                # with no explicit output size): each clip retries alone
                seq.extend(grp)
                continue
            if len(rs) != len(grp):
                # a result list that does not pair up with the group is a
                # contract violation: a group failure, never a silent
                # zip truncation that leaves None results
                seq.extend(grp)
                continue
            per = (time.perf_counter() - t0) / max(1, len(grp))
            for g, r in zip(grp, rs):
                if r.ok:
                    if jr is not None:
                        jr.mark_done(jobs[g], per)
                    results[g] = ClipResult(jobs[g], ok=True, seconds=per)
                    bump()
                else:
                    seq.append(g)  # per-clip retry on the sequential path

    for i in sorted(seq):
        job = jobs[i]
        t0 = time.perf_counter()
        err = ""
        ok = False
        for _ in range(1 + max_retries):
            try:
                process_fn(
                    job.input_path, job.output_path, job.params,
                    width=job.width, height=job.height, fps=job.fps,
                    report=False, **job.kwargs,
                )
                ok = True
                break
            except Exception:
                err = traceback.format_exc(limit=4)
        dt = time.perf_counter() - t0
        if ok and jr is not None:
            jr.mark_done(job, dt)
        results[i] = ClipResult(job, ok=ok, seconds=dt, error="" if ok else err)
        bump()
    return results  # type: ignore[return-value]
