"""The draw kernel (csrc/rng.cu, csrc/box_muller.cuh) with one part changed
at a time, timed on the card: what each part of the grain and export
entries costs.

    python3 scripts/port_rng_variants.py [--variants base,philox_store,...] [--out FILE]

Each variant is a patched copy of the two sources built alone into its own
library (nvcc with the kernels' flags, all at once) and launched through
``kernels/rng.py``'s argument struct on the draw shapes of the main paths:
the grain field at 1080x1920 and c3's 540x960 (8 frames) and at c5's
2160x3840 (32 frames), the export offsets of c4's and c5's bands. Per
variant and shape: the kernel's device time per launch from torch.profiler
(the best and worst of two turns, the variants in turns), and whether its
output is bit for bit the package's (the timing probes that drop work are
not). ``torch.randn`` of each shape is timed beside them. Prints one line
per shape, the card's name and power limit, and one JSON object; writes
it under chiprun_out/ when ``--out`` is given. Exits 2 without a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import device_ms  # noqa: E402

GRAIN_DRAW = "        normals4(bm::kAngle, bm::kLog, draw(a, g, f), z);"
# name -> [(text of csrc/rng.cu or csrc/box_muller.cuh, replacement)]
VARIANTS = {
    "base": [],
    # the grain's Philox words stored as they are: the transform left out
    "philox_store": [(GRAIN_DRAW, "        { const Words w = draw(a, g, f); z[0] = __uint_as_float(w.x);"
                      " z[1] = __uint_as_float(w.y); z[2] = __uint_as_float(w.z);"
                      " z[3] = __uint_as_float(w.w); }")],
    # the stores alone
    "store_only": [(GRAIN_DRAW, "        z[0] = __uint_as_float(g); z[1] = z[0] + 1.0f;"
                    " z[2] = z[0] * 3.0f; z[3] = __uint_as_float(g ^ 0x1234u);")],
    # the draws without their stores (a store no value takes)
    "no_store": [("            *reinterpret_cast<float4*>(o) = make_float4(z[0], z[1], z[2], z[3]);",
                  "            if (z[0] == 1234.5f && z[1] == z[2])\n"
                  "                *reinterpret_cast<float4*>(o) = make_float4(z[0], z[1], z[2], z[3]);")],
    # the fast products rounded with no test (not bit for bit by design)
    "no_rounding_test": [("    z0 = round_checked(e, r * a.c, ok);\n    z1 = round_checked(e, r * a.s, ok);",
                          "    z0 = (float)(r * a.c);\n    z1 = (float)(r * a.s);")],
    # the tables copied into shared memory by every block
    "smem_tables": [("    const int bi = blockIdx.y;\n    const uint64_t f = (uint64_t)__ldg(a.frames + bi);\n"
                     "    const uint64_t n = (uint64_t)a.n0 * a.n1;",
                     "    __shared__ bm::Tabs tabs;\n    bm::load_tabs(tabs);\n    __syncthreads();\n"
                     "    const int bi = blockIdx.y;\n    const uint64_t f = (uint64_t)__ldg(a.frames + bi);\n"
                     "    const uint64_t n = (uint64_t)a.n0 * a.n1;"),
                    (GRAIN_DRAW, "        normals4(tabs.ang, tabs.lg, draw(a, g, f), z);")],
    "groups_8": [("GRAIN_GROUPS = 4;", "GRAIN_GROUPS = 8;")],
    # libdevice's correctly rounded square root in place of sqrt_fast
    "libdevice_sqrt": [("    return sqrt_fast(fma(", "    return sqrt(fma(")],
    # the export walk's serial sum left out (not bit for bit)
    "no_walk_sum": [("        if (tid == 0 && lim_smem) {", "        if (tid == 0 && lim_smem && rows < 0) {")],
}
SOURCES = ("rng.cu", "box_muller.cuh")


def build(names, csrc, nvcc, flags, root) -> dict:
    """Each variant's patched sources built into root/<name>/lib.so, all nvcc
    processes at once; returns name -> loaded library."""
    procs = {}
    for name in names:
        d = os.path.join(root, name)
        os.makedirs(d)
        files = {f: open(os.path.join(csrc, f)).read() for f in SOURCES}
        for old, new in VARIANTS[name]:
            hit = [f for f in files if old in files[f]]
            if not hit:
                raise SystemExit(f"variant {name}: its patch does not apply: {old[:60]!r}")
            for f in hit:
                files[f] = files[f].replace(old, new)
        for f, src in files.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(src)
        procs[name] = subprocess.Popen([nvcc, *flags, "-shared", "-o", os.path.join(d, "lib.so"),
                                        os.path.join(d, "rng.cu")], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"variant {name}: nvcc failed:\n{out[-3000:]}")
        lib = ctypes.CDLL(os.path.join(root, name, "lib.so"))
        lib.crt_rng_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.crt_rng_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_rng_variants: no CUDA device available", file=sys.stderr)
        return 2
    from pythoncrt_tpu_torch import CRTEngine, EffectParams
    from pythoncrt_tpu_torch.kernels import _build
    from pythoncrt_tpu_torch.kernels import rng as krng

    names = args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    root = tempfile.mkdtemp()
    try:
        libs = build(names, str(_build.CSRC), _build.find_nvcc(), _build.NVCC_FLAGS, root)
        dev = torch.device("cuda")
        glitch = dict(scanline_strength=0.6, persistence=0.6, glitch_amp_px=6,
                      glitch_height_frac=0.3)
        c4 = CRTEngine(EffectParams(**glitch), 1080, 1920, 24.0, device=dev)
        c5 = CRTEngine(EffectParams(**glitch), 2160, 3840, 24.0, device=dev)
        cases = (("grain 1920x1080, B 8", 0, 8, 1080, 1920, None),
                 ("grain 960x540 (c3), B 8", 0, 8, 540, 960, None),
                 ("grain 3840x2160 (c5), B 32", 0, 32, 2160, 3840, None),
                 (f"export {c4._glitch_rows}x{c4._glitch_nseg} (c4), B 8", 1, 8,
                  c4._glitch_rows, c4._glitch_nseg, c4._glitch_amp),
                 (f"export {c5._glitch_rows}x{c5._glitch_nseg} (c5), B 32", 1, 32,
                  c5._glitch_rows, c5._glitch_nseg, c5._glitch_amp))

        def launch(lib, mode, nb, n0, n1, amp, out, fr):
            a = krng._RngArgs()
            a.out, a.frames = out.data_ptr(), fr.data_ptr()
            if amp is not None:
                a.amp = amp.data_ptr()
            a.mode, a.b, a.n0, a.n1 = mode, nb, n0, n1
            a.keys[:] = krng.round_keys(0)
            a.stream = krng.GRAIN_STREAM if mode == 0 else krng.GLITCH_STREAM
            rc = lib.crt_rng_launch(ctypes.byref(a),
                                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if rc:
                raise RuntimeError(f"crt_rng_launch failed with CUDA error {rc}")

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
        results = []
        for cname, mode, nb, n0, n1, amp in cases:
            fr = torch.arange(nb, device=dev) + 1000
            want = (krng.grain_normals(0, fr, n0, n1) if mode == 0
                    else krng.glitch_export_offsets(0, fr, n1, amp))
            times, same = {n: [] for n in libs}, {}
            for _ in range(2):  # two turns, the variants in turns
                for name, lib in libs.items():
                    out = torch.empty_like(want)
                    launch(lib, mode, nb, n0, n1, amp, out, fr)
                    torch.cuda.synchronize()
                    same[name] = bool(torch.equal(out, want))
                    times[name].append(device_ms((lambda: launch(lib, mode, nb, n0, n1, amp,
                                                                 out, fr), None))[0])
            randn = device_ms((lambda: torch.randn(want.shape, device=dev), None))[0]
            row = dict(shape=cname, randn_ms=randn, card=card, variants={
                n: dict(ms_min=min(t), ms_max=max(t), bit_for_bit=same[n]) for n, t in times.items()})
            results.append(row)
            print(f"[variants] {cname}: " + "; ".join(
                f"{n} {v['ms_min']:.4f}-{v['ms_max']:.4f} ms" + ("" if v["bit_for_bit"] else
                                                                   " (not bit for bit)")
                for n, v in row["variants"].items()) + f"; torch.randn {randn:.4f} ms", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", args.out), "w") as f:
            json.dump(results, f, indent=1)
    print(card)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
