"""The control of ``correct``: the reference in bfloat16, put in the port's place.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 [--late 1200]

For each seed, the calls a run compares (the first timed call, the one
drawn from the seed, and call ``--late`` standing for the window's last)
are rendered by the reference from the run's own inputs twice: in float32,
as the configuration states, and in bfloat16, the next precision below.
The bfloat16 frames are compared with the float32 ones by the run's
numbers, which the cell's limits must fail. Prints one JSON line per seed.
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run as prun
from portbench.reference.chain import lead_frames
from portbench.reference.compare import Reference, gaps


def control(workload: str, seed: int, late: int, *, device: str = "cuda",
            cfg_over: dict = None, traffic_over: dict = None) -> dict:
    import torch

    _, _, cfg, traffic = prun.cell_spec(workload)
    cfg = dict(cfg, **(cfg_over or {}))
    traffic = dict(traffic, **(traffic_over or {}))
    ecfg = prun.effective_cfg(cfg, traffic)
    h, w = int(cfg["height"]), int(cfg["width"])
    dev = torch.device(device)
    entry = prun.load_module("entries", traffic["entry"]).Entry(ecfg, traffic)
    ring = prun.make_ring(seed, traffic, entry.shape, dev)
    overlay = prun.overlay_for(traffic, h, w, seed)
    k_first, k_mid = prun.sample_calls(seed)
    limits = prun.load_json(prun.HERE, "limits", f"{workload}.json")
    f32 = Reference(ecfg, dev, torch.float32, overlay)
    bf16 = Reference(ecfg, dev, torch.bfloat16, overlay)
    lead = lead_frames(ecfg["params"]["persistence"])
    widest, off, values = 0, 0, 0
    with torch.no_grad():
        for k in (k_first, k_mid, late):
            for s in entry.streams(ring, k, lead, seed):
                want, got = f32.render(s), bf16.render(s)
                w_k, o_k = gaps(got, want)
                widest, off, values = max(widest, w_k), off + o_k, values + want.numel()
    nums = {"max_lsb": widest, "off_share": off / values}
    fails = [k for k in nums if nums[k] > limits[k]]
    return {"workload": workload, "seed": seed, "calls": [k_first, k_mid, late],
            "numbers": nums, "limits": limits, "limits_fail_it": bool(fails), "failed_by": fails}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The bfloat16 control of a cell's comparison.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--late", type=int, default=1200)
    a = ap.parse_args(argv)
    ok = True
    for s in a.seeds.split(","):
        r = control(a.workload, int(s), a.late)
        ok &= r["limits_fail_it"]
        print(json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
