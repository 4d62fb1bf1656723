#!/usr/bin/env python3
"""Where the time of the tensor-core flash-attention kernels goes, on one card.

Times the bf16 forward (B1, ``csrc/flash_attn_fwd.cu``) at the serving
shape (B 4, N 4096, c_bar 8, C 64) and the bf16 dq and dkv kernels (B2
and B3, ``csrc/flash_attn_bwd.cu``) at the training shape (B 3), each
beside copies of its source with one part taken out:

- ``no_exp``: the exponentials (each ex2 replaced by its argument);
- ``no_scores``: the score product S = f g^T (S^T = g f^T in dkv);
- ``no_value`` (forward): the value product O += P h;
- ``no_dp`` (dq, dkv): the product dP = do h^T (dP^T = h do^T in dkv);
- ``no_grads``: the products dh += P^T do and dg += dS^T f (dkv), df +=
  dS g (dq);
- ``no_staging``: the copies of every tile after the first (the kernel
  reads the first tile's shared memory again).

The copies compute wrong results and exist only to be timed; what a part
costs is how much faster the kernel gets without it. Each is built with
the package's nvcc flags into a temporary directory, and all are timed in
turns (kernel, copies, kernel, ...) three times: CUDA events, the median
of 30 launches after 5 warm-ups. Prints one JSON line per timing, with the
card's name and power limit. Run from the repository root:

    python3 tools/flash_split.py
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

from twingan_tpu_torch.ops import attention, cuda_build  # noqa: E402

REPEATS = 3

# The text each copy replaces (it must occur in the source), by library.
FWD_CUTS = {
    "no_exp": [("s[j][e] = ex2(fmaf(s[j][e], kLog2e, -msc[e / 2]));",
                "s[j][e] = fmaf(s[j][e], kLog2e, -msc[e / 2]);")],
    "no_scores": [("for (int i = 0; i < 4; ++i) mma1688(s[4 * j + i], fa[0][0], fa[0][1], bf[i]);",
                   "s[4 * j][0] += __uint_as_float(bf[0]);")],
    "no_value": [("        mma16816(acc[2 * j], pa, bf[0], bf[1]);\n"
                  "        mma16816(acc[2 * j + 1], pa, bf[2], bf[3]);",
                  "        acc[2 * j][0] += __uint_as_float(bf[0] ^ pa[0]);")],
    "no_staging": [("    if (t + 1 < ntiles) stage(t + 1, (t + 1) & 1);",
                    "    if (t + 1 < ntiles && t < 0) stage(t + 1, (t + 1) & 1);")],
}
DKV_CUTS = {
    "no_exp": [(f"p[j][{e}] = ex2(fmaf(p[j][{e}], kLog2e, -l{e % 2}));",
                f"p[j][{e}] = fmaf(p[j][{e}], kLog2e, -l{e % 2});") for e in range(4)],
    "no_scores": [("for (int i = 0; i < 4; ++i) mma1688(p[4 * j + i], ga[0][0], ga[0][1], bf[i]);",
                   "p[4 * j][0] += __uint_as_float(bf[0]);")],
    "no_dp": [("        mma16816(ds[2 * j], ha[ks], bf[0], bf[1]);\n"
               "        mma16816(ds[2 * j + 1], ha[ks], bf[2], bf[3]);",
               "        ds[2 * j][0] += __uint_as_float(bf[0] ^ ha[ks][0]);")],
    "no_grads": [("        mma16816(dha[2 * j], pa, bf[0], bf[1]);\n"
                  "        mma16816(dha[2 * j + 1], pa, bf[2], bf[3]);",
                  "        dha[2 * j][0] += __uint_as_float(bf[0] ^ pa[0]);"),
                 ("          mma16816(dga[0], da, bf[0], bf[1]);",
                  "          dga[0][0] += __uint_as_float(bf[0] ^ da[0]);")],
    "no_staging": [("    if (t + 1 < ntiles) stage(t + 1, (t + 1) & 1);",
                    "    if (t + 1 < ntiles && t < 0) stage(t + 1, (t + 1) & 1);")],
}
# dq's lines; where dkv has the same text (an exponential, the staging),
# its copy is cut too, and only dq is timed.
DQ_CUTS = {
    "no_exp": [(f"p[j][{e}] = ex2(fmaf(p[j][{e}], kLog2e, -l{e // 2}));",
                f"p[j][{e}] = fmaf(p[j][{e}], kLog2e, -l{e // 2});") for e in range(4)],
    "no_scores": [("for (int i = 0; i < 4; ++i) mma1688(p[4 * j + i], fa[0][0], fa[0][1], bf[i]);",
                   "p[4 * j][0] += __uint_as_float(bf[0]);")],
    "no_dp": [("        mma16816(ds[2 * j], doa[ks], bf[0], bf[1]);\n"
               "        mma16816(ds[2 * j + 1], doa[ks], bf[2], bf[3]);",
               "        ds[2 * j][0] += __uint_as_float(bf[0] ^ doa[ks][0]);")],
    "no_grads": [("        mma16816(dfa[0], da, bf[0], bf[1]);",
                  "        dfa[0][0] += __uint_as_float(bf[0] ^ da[0]);")],
    "no_staging": DKV_CUTS["no_staging"],
}
# kernel -> (library, cuts, shape B, N, c_bar, C)
KERNELS = {
    attention.KERNEL_NAME: (attention.KERNEL_NAME, FWD_CUTS, (4, 4096, 8, 64)),
    attention.DQ_KERNEL: (attention.BWD_LIBRARY, DQ_CUTS, (3, 4096, 8, 64)),
    attention.DKV_KERNEL: (attention.BWD_LIBRARY, DKV_CUTS, (3, 4096, 8, 64)),
}


def build_copy(library: str, name: str, cuts, workdir: str) -> tuple[str, str]:
    """Compile csrc/<library>.cu with ``cuts`` applied; returns (name, .so)."""
    src_dir = os.path.join(workdir, name)
    shutil.copytree(cuda_build.CSRC_DIR, src_dir)
    path = os.path.join(src_dir, f"{library}.cu")
    with open(path) as fh:
        text = fh.read()
    for old, new in cuts:
        if old not in text:
            raise RuntimeError(f"{library}.cu no longer holds the text {name} cuts: {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as fh:
        fh.write(text)
    out = os.path.join(src_dir, f"lib{library}.so")
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {name} copy of {library}.cu:\n{proc.stderr}")
    return name, out


def time_ms(fn, reps: int = 30) -> float:
    import torch

    for _ in range(5):
        fn()
    events = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"ok": False, "error": "no CUDA device"}))
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    workdir = tempfile.mkdtemp(prefix="flash_split_")
    try:
        jobs = [(kernel, name, cuts) for kernel, (_, all_cuts, _) in KERNELS.items()
                for name, cuts in [("kernel", []), *all_cuts.items()]]
        with ThreadPoolExecutor(len(jobs)) as pool:
            built = list(pool.map(lambda j: (j[0], *build_copy(
                KERNELS[j[0]][0], j[1], j[2], os.path.join(workdir, j[0]))), jobs))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for kernel, (library, _, (b, n, c_bar, c)) in KERNELS.items():
            f, g = (torch.randn(b, n, c_bar, device="cuda", generator=gen).bfloat16()
                    for _ in range(2))
            h, do = (torch.randn(b, n, c, device="cuda", generator=gen).bfloat16()
                     for _ in range(2))
            o, lse = attention.flash_attention_forward(f, g, h)
            delta = torch.sum(do.float() * o.float(), dim=-1)
            call = {
                attention.KERNEL_NAME: lambda: attention.flash_attention_forward(f, g, h),
                attention.DQ_KERNEL: lambda: attention.flash_attention_dq(f, g, h, do, lse, delta),
                attention.DKV_KERNEL: lambda: attention.flash_attention_dkv(f, g, h, do, lse, delta),
            }[kernel]
            copies = [(name, ctypes.CDLL(so)) for k, name, so in built if k == kernel]
            real = cuda_build.load(library)
            for rep in range(REPEATS):
                for name, lib in copies:
                    cuda_build._loaded[library] = lib  # the wrapper launches the copy
                    try:
                        ms = time_ms(call)
                    finally:
                        cuda_build._loaded[library] = real
                    print(json.dumps({"kernel": kernel, "B": b, "N": n, "c_bar": c_bar,
                                      "C": c, "dtype": "bfloat16", "copy": name, "repeat": rep,
                                      "ms": ms, "card": smi}), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
