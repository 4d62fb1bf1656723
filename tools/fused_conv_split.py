#!/usr/bin/env python3
"""Where the time of the fused conv kernel (B4) goes, on one card.

At every distinct conv-leaky-pixel-norm layer of a pggan256 generator pass
(batch 12, bf16 and fp32; ``chip_smoke.FUSED_CONV_CASES``; with ``--wide``,
its rows past one block's 1024 channels instead: 1032 to 2056 channels at
B 2, one pass over a cluster of 256-channel tiles, two past 2048), times B4
(``csrc/fused_conv.cu``, the tensor-core variant for bf16, the TF32 one
for fp32) beside copies of its source with one part taken out:

- ``no_xload``: the loads of x from device memory (bf16: the staged tile
  holds the channel indices instead; fp32: the copies only zero fill);
- ``no_mma``: the products (each pair of bf16 mma.sync, or each TF32
  product of the 3xTF32, replaced by an add);
- ``no_lo`` (fp32): the two small TF32 products of each 3xTF32 product
  (lo hi and hi lo; the large one stays);
- ``no_split`` (fp32): the hi/lo split of x and of the weights (both
  halves take the unsplit bits, the products stay);
- ``no_wcopy``: the cp.async copies of the weights;
- ``no_store``: the stores of y.

The copies compute wrong results and exist only to be timed; what a part
costs is how much faster the kernel gets without it. Times are the
kernels' device time from ``torch.profiler`` (the mean of 20 calls after
3 warm-ups), not CUDA events around the call: at 4-8 px a call's host
time is longer than its kernel. Each copy is built with the package's
nvcc flags into a temporary directory. Prints one JSON line per layer and
one with the sums over a pass (each layer times its count) for each type,
with the card's name and power limit. Run from the repository root:

    python3 tools/fused_conv_split.py [--dtype bfloat16|float32] [--wide]
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import chip_smoke  # noqa: E402
from flash_split import TF32_CUTS, build_copy  # noqa: E402
from twingan_tpu_torch.ops import cuda_build, fused_conv  # noqa: E402


def _tf32_product(part: str, use: str) -> tuple[str, str]:
    """One of the TF32 variant's three product lines, replaced by ``use``."""
    a, b = {"lo": ("lo", "bh"), "hi_lo": ("hi", "bl"), "hi": ("hi", "bh")}[part]
    return f"mma1688_tf32(cacc[mt][j + e], a[mt].{a}, {b}[e][0], {b}[e][1]);", use


TF32_MMA_USES = {"lo": "cacc[mt][j + e][0] += __uint_as_float(bh[e][0] ^ a[mt].lo[0]);",
                 "hi_lo": "cacc[mt][j + e][1] += __uint_as_float(bl[e][1] ^ bl[e][0]);",
                 "hi": "cacc[mt][j + e][2] += __uint_as_float(bh[e][1] ^ a[mt].hi[3]);"}
# Cuts by x's type: only the lines of that variant (and shared ones).
CUTS = {"bfloat16": {
    "kernel": [],
    "no_xload": [("const uint32_t bits = ci0 + j < cin ? __ldg(src + static_cast<int64_t>(j) * hw) : 0u;",
                  "const uint32_t bits = ci0 + j;")],
    "no_mma": [("              mma16816(acc[mt][2 * j], a[mt], bf[0], bf[1]);\n"
                "              mma16816(acc[mt][2 * j + 1], a[mt], bf[2], bf[3]);",
                "              acc[mt][2 * j][0] += __uint_as_float(bf[0] ^ a[mt][0] ^ bf[2]);")],
    "no_wcopy": [("        cp_async16(dst, in ? src : w9, in ? 16 : 0);",
                  "        if (in && tid < 0) cp_async16(dst, src, 16);")],
    "no_store": [("          store_as(yb + static_cast<int64_t>(n0) * hw + at, sum[mm * PS + co] * scale[mm]);",
                  "          if (co < 0) store_as(yb, sum[mm * PS + co] * scale[mm]);"),
                 ("        yb[static_cast<int64_t>(n0 + co) * hw + hh * width + ww] = ys[co * YS + m];",
                  "        if (co < 0) yb[0] = ys[m];"),
                 ("      if (hh < height && ww < width) {\n        *reinterpret_cast<uint4*>(yb",
                  "      if (hh < 0) {\n        *reinterpret_cast<uint4*>(yb")],
}}
CUTS["float32"] = {
    "kernel": [],
    "no_xload": [("                  in ? 4 : 0);", "                  0);")],
    "no_mma": [_tf32_product(part, use) for part, use in TF32_MMA_USES.items()],
    "no_lo": [_tf32_product(part, ";") for part in ("lo", "hi_lo")],
    "no_split": TF32_CUTS["no_split"],
    "no_wcopy": CUTS["bfloat16"]["no_wcopy"],
    "no_store": CUTS["bfloat16"]["no_store"],
}


def device_us(fn, reps: int = 20) -> float:
    """Mean device time of ``fn``'s kernels, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and e.time_range.end > e.time_range.start) / reps


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                        help="time only the variant of this type (default: both)")
    parser.add_argument("--wide", action="store_true",
                        help="the rows past 1024 output channels instead of pggan256's layers")
    args = parser.parse_args()
    dtypes = [d for d in CUTS if args.dtype in (None, d)]
    if not torch.cuda.is_available():
        print(json.dumps({"ok": False, "error": "no CUDA device"}))
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    workdir = tempfile.mkdtemp(prefix="fused_conv_split_")
    try:
        jobs = [(dtype, name, cuts) for dtype in dtypes for name, cuts in CUTS[dtype].items()]
        with ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 8)) as pool:
            built = list(pool.map(lambda j: (j[0], *build_copy(
                fused_conv.KERNEL_NAME, j[1], j[2], os.path.join(workdir, j[0]))), jobs))
        real = cuda_build.load(fused_conv.KERNEL_NAME)
        for dtype in dtypes:
            totals = dict.fromkeys(CUTS[dtype], 0.0)
            for label, b, hw, cin, cout, case_dtype, per_pass in chip_smoke.FUSED_CONV_CASES:
                wide = cout > fused_conv.COUT_TILE
                if case_dtype != dtype or (wide if not args.wide else not wide) or (
                        not args.wide and not per_pass):
                    continue
                gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 2)
                x = torch.randn(b, cin, hw, hw, device="cuda", generator=gen).to(
                    getattr(torch, dtype))
                w9 = fused_conv.fold_weights(
                    torch.randn(cout, cin, 3, 3, device="cuda", generator=gen),
                    (2.0 / (cin * 9)) ** 0.5)
                bias = 0.2 * torch.randn(cout, device="cuda", generator=gen)
                row = {"case": label, "B": b, "H": hw, "W": hw, "Cin": cin, "Cout": cout,
                       "dtype": dtype, "layers_per_pass": per_pass}
                for copy_dtype, name, so in built:
                    if copy_dtype != dtype:
                        continue
                    cuda_build._loaded[fused_conv.KERNEL_NAME] = ctypes.CDLL(so)  # the copy
                    try:
                        row[f"{name}_us"] = device_us(lambda: fused_conv.fused_conv(x, w9, bias))
                    finally:
                        cuda_build._loaded[fused_conv.KERNEL_NAME] = real
                    totals[name] += per_pass * row[f"{name}_us"]
                row["bound_us"] = 1e3 * chip_smoke.fused_conv_bound(b, hw, cin, cout, dtype)[0]
                row["card"] = smi
                print(json.dumps(row), flush=True)
            if not args.wide:
                print(json.dumps({"pass": "pggan256 generator, batch 12, 13 layers",
                                  "dtype": dtype, **{f"{k}_us": v for k, v in totals.items()},
                                  "card": smi}), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
