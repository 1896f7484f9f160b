"""Persistence kernel (csrc/persist.cu): its least time over its device
time per launch, in % (portbench/yardstick.py persistence_work)."""

from portbench import yardstick


def read(ctx):
    tr = ctx.trace
    ks = tr.kernels("persist_kernel") if tr is not None else []
    if not ks:
        return None
    per_launch_s = sum(k[3] for k in ks) / len(ks) / 1e6
    return yardstick.bound_s(*yardstick.persistence_work(ctx.cfg, tr.frames / len(ks))) \
        / per_launch_s * 100.0
