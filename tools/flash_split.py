#!/usr/bin/env python3
"""Where the time of the tensor-core flash-attention kernels goes, on one card.

Times the bf16 forward (B1, ``csrc/flash_attn_fwd.cu``) at the serving
shape (B 4, N 4096, c_bar 8, C 64) and the bf16 dq and dkv kernels (B2
and B3, ``csrc/flash_attn_bwd.cu``) at the training shape (B 3), and the
fp32 (3xTF32) forward, dq and dkv at the same shapes; with ``--wide``,
the kernels past the register-held widths instead (``csrc/flash_wide.cuh``):
the fp32 3xTF32 kernel at (B 2, N 256, c_bar 256, C 2048) and at a ragged
N of 1000 with C 512, and the bf16 dq and dkv (``wide_bf16_kernel``) at
those two and at the 512-channel configuration's (B 4, N 64, c_bar 64, C
512) and N 4096. Each is timed beside copies of its source with one part
taken out:

- ``no_exp``: the exponentials (each ex2 replaced by its argument);
- ``no_scores``: the score product S = f g^T (S^T = g f^T in dkv);
- ``no_value`` (forward): the value product O += P h;
- ``no_dp`` (dq, dkv): the product dP = do h^T (dP^T = h do^T in dkv);
- ``no_grads``: the products dh += P^T do and dg += dS^T f (dkv), df +=
  dS g (dq);
- ``no_lo`` (fp32): the two small TF32 products of each 3xTF32 product
  (lo hi and hi lo; the large one stays), with the splits only they use
  (dq splits each staged tile into both halves whatever it multiplies);
- ``no_split`` (fp32): the hi/lo split of every operand (cvt.rna, the
  subtraction and the cut of lo; both halves take the unsplit bits, the
  products stay);
- ``no_staging``: the copies of every tile after the first (the kernel
  reads the first tile's shared memory again; the wide kernel's steps
  after the first two);
- ``no_merge`` (wide): the loads of the cluster's partial outputs in the
  epilogue (each block writes its own share unsummed);
- ``no_exchange`` (wide bf16): the loads of the cluster's partial dp and of
  its sums, where the cluster splits dp's chunks (each block's own);
- ``no_dsplit`` (wide bf16): the plan's split of dp's chunks at one or two
  tiles (the cluster splits the tiles there too, as elsewhere);
- ``no_resident`` (wide bf16): the own rows' chunks kept in shared memory
  across tiles (staged again every tile);
- ``half_splits`` (wide bf16): the plan's split of the tiles capped at half
  the cluster (or the tiles): fewer, longer blocks.
The wide fp32 kernel's ``no_scores`` cuts the score and dp chunks'
products together, ``no_value`` the last product (o, df, dg or dh); the
bf16 kernel's ``no_scores`` the score products alone, ``no_dp`` dp's.

The copies compute wrong results and exist only to be timed; what a part
costs is how much faster the kernel gets without it. Each is built with
the package's nvcc flags into a temporary directory, and all are timed in
turns (kernel, copies, kernel, ...) three times: device time, the mean of
30 launches queued behind a spin of the card (CUDA events around them),
after 5 warm-ups. Prints one JSON line per timing, with the
card's name and power limit. Run from the repository root:

    python3 tools/flash_split.py [--dtype bfloat16|float32] [--wide]
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
HEADER = "flash_mma.cuh"

# The text each copy replaces (it must occur in the source), by library; a
# cut of three strings names the file of csrc/ it applies to.
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
# The 3xTF32 variants' cuts: the products' lines of the fp32 kernels, and
# the split and the small products in flash_mma.cuh.
TF32_CUTS = {
    "no_lo": [(HEADER, "  mma1688_tf32(d, a.lo, s0.hi, s1.hi);\n"
                       "  mma1688_tf32(d, a.hi, s0.lo, s1.lo);\n", "")],
    "no_split": [(HEADER, "  const uint32_t hi = to_tf32(x);\n"
                          "  return {hi, __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u};",
                  "  return {__float_as_uint(x), __float_as_uint(x)};")],
}
FWD_TF32_CUTS = {
    "no_exp": FWD_CUTS["no_exp"],
    "no_scores": [("for (int ks = 0; ks < KS; ++ks) mma1688_tf32x3(s[j], fa[ks], gr[8 * ks], "
                   "gr[8 * ks + 4]);", "s[j][0] += gr[0];")],
    "no_value": [("for (int j = 0; j < 8; ++j) mma1688_tf32x3(pv[j], pa, hr[8 * j], "
                  "hr[HS + 8 * j]);",
                  "pv[kk][0] += hr[0] + __uint_as_float(pa.hi[0] ^ pa.lo[3]);")],
    **TF32_CUTS,
    "no_staging": FWD_CUTS["no_staging"],
}
DKV_TF32_CUTS = {
    "no_exp": DKV_CUTS["no_exp"],
    "no_scores": [("for (int ks = 0; ks < KS; ++ks) mma1688_tf32x3(p[j], ga[ks], fr[8 * ks], "
                   "fr[8 * ks + 4]);", "p[j][0] += fr[0];")],
    "no_dp": [("        mma1688_tf32x3(ds[j], ha, dr[0], dr[4]);",
               "        ds[j][0] += dr[0] + __uint_as_float(ha.hi[0] ^ ha.lo[3]);")],
    "no_grads": [("for (int j = 0; j < 8; ++j) mma1688_tf32x3(th[j], pa, dr[8 * j], "
                  "dr[DS + 8 * j]);",
                  "th[kk][0] += dr[0] + __uint_as_float(pa.hi[0] ^ pa.lo[3]);"),
                 ("for (int j = 0; j < NG; ++j) mma1688_tf32x3(tg[j], da, fr[8 * j], "
                  "fr[FS + 8 * j]);",
                  "tg[0][0] += fr[0] + __uint_as_float(da.hi[0] ^ da.lo[3]);")],
    **TF32_CUTS,
    "no_staging": DKV_CUTS["no_staging"],
}
# fp32 dq issues its three TF32 products itself, each over its independent
# accumulators in turn: (accumulator, A fragment, B registers) of S, dP and
# df.
DQ_TF32_PRODUCTS = {
    "no_scores": ("p[j]", "fa[ks]", "[j]"),
    "no_dp": ("ds[i][j]", "da[i]", "[i][j]"),
    "no_grads": ("tq[kk][j]", "sa[kk]", "[kk]"),
}


def _dq_tf32_cut(acc: str, a: str, b: str, parts=("lo", "hi_lo", "hi")) -> list:
    """The lines of one dq product's TF32 products (``parts`` of them),
    each replaced by a use of its operands."""
    calls = {"lo": f"mma1688_tf32({acc}, {a}.lo, bh{b}[0], bh{b}[1]);",
             "hi_lo": f"mma1688_tf32({acc}, {a}.hi, bl{b}[0], bl{b}[1]);",
             "hi": f"mma1688_tf32({acc}, {a}.hi, bh{b}[0], bh{b}[1]);"}
    uses = {"lo": f"{acc}[0] += __uint_as_float(bh{b}[0] ^ bh{b}[1] ^ {a}.lo[0]);",
            "hi_lo": f"{acc}[1] += __uint_as_float(bl{b}[0] ^ bl{b}[1]);",
            "hi": f"{acc}[2] += __uint_as_float({a}.hi[0]);"}
    return [(calls[k], uses[k] if len(parts) == 3 else ";") for k in parts]


DQ_TF32_CUTS = {
    "no_exp": DQ_CUTS["no_exp"],
    **{name: _dq_tf32_cut(*ops) for name, ops in DQ_TF32_PRODUCTS.items()},
    "no_lo": [cut for ops in DQ_TF32_PRODUCTS.values()
              for cut in _dq_tf32_cut(*ops, parts=("lo", "hi_lo"))],
    "no_split": TF32_CUTS["no_split"],
    "no_staging": [("    if (t + 2 < ntiles) copy(t + 2, buf);",
                    "    if (t + 2 < ntiles && t < 0) copy(t + 2, buf);")],
}
WIDE = "flash_wide.cuh"


def _wide_products(a: str, b_lo: str = "blr", b_hi: str = "bhr", parts=("lo", "hi_lo", "hi")):
    """The wide kernel's three product lines of A fragment ``a``, each
    replaced by a use of its operands (or removed, for ``no_lo``)."""
    calls = {"lo": f"mma1688_tf32(part[jj], {a}.lo, {b_hi}[jj][0], {b_hi}[jj][1]);",
             "hi_lo": f"mma1688_tf32(part[jj], {a}.hi, {b_lo}[jj][0], {b_lo}[jj][1]);",
             "hi": f"mma1688_tf32(part[jj], {a}.hi, {b_hi}[jj][0], {b_hi}[jj][1]);"}
    uses = {"lo": f"part[jj][0] += __uint_as_float({b_hi}[jj][0] ^ {b_hi}[jj][1] ^ {a}.lo[0]);",
            "hi_lo": f"part[jj][1] += __uint_as_float({b_lo}[jj][0] ^ {b_lo}[jj][1]);",
            "hi": f"part[jj][2] += __uint_as_float({a}.hi[0]);"}
    return [(WIDE, calls[k], uses[k] if len(parts) == 3 else ";") for k in parts]


WIDE_TF32_CUTS = {
    "no_exp": [(WIDE, "s[jj][e] = ex2(fmaf(s[jj][e], kLog2e, -msc[e / 2]));",
                "s[jj][e] = fmaf(s[jj][e], kLog2e, -msc[e / 2]);"),
               (WIDE, "const float pe = q + (e & 1) < n ? ex2(fmaf(s[jj][e], kLog2e, -l)) : 0.f;",
                "const float pe = q + (e & 1) < n ? fmaf(s[jj][e], kLog2e, -l) : 0.f;")],
    "no_scores": _wide_products("af"),
    "no_value": _wide_products("pa[kk]"),
    "no_lo": _wide_products("af", parts=("lo", "hi_lo")) + _wide_products(
        "pa[kk]", parts=("lo", "hi_lo")),
    "no_split": TF32_CUTS["no_split"],
    "no_staging": [(WIDE, "    if (gs + kStages - 1 < total) stage(gs + kStages - 1);",
                    "    if (gs + kStages - 1 < total && gs < 0) stage(gs + kStages - 1);")],
    "no_merge": [(WIDE, "  peer_sources(srcs, accs, splits);", "  peer_sources(srcs, accs, 1);")],
}
WIDE_SHAPES = {"C 2048": (2, 256, 256, 2048), "ragged N": (2, 1000, 64, 512)}
# The bf16 dq and dkv kernel's cuts: a product replaced by a use of its
# operands; the exchange's and the merge's remote loads by local ones.
WIDE_BF16_CUTS = {
    "no_exp": [WIDE_TF32_CUTS["no_exp"][1]],
    "no_scores": [(WIDE, "        mma_abt<true>(s, at, bt, warp, lane);\n      } else {",
                   "        s[0][0] += __bfloat162float(at[lane]) + __bfloat162float(bt[lane]);\n"
                   "      } else {")],
    "no_dp": [(WIDE, "        if constexpr (DP) mma_abt<true>(dp, at, bt, warp, lane);",
               "        if constexpr (DP) dp[0][0] += __bfloat162float(at[lane]) + "
               "__bfloat162float(bt[lane]);")],
    "no_value": [(WIDE, "        mma_pv<true>(acc[i], pa, ring_b + (gs % S) * kChunkElems, lane);",
                  "        acc[i][0][0] += __uint_as_float(pa[0][0]) + "
                  "__bfloat162float(ring_b[(gs % S) * kChunkElems + lane]);")],
    "no_staging": [(WIDE, "    if (gs + S - 1 < total) stage(gs + S - 1);",
                    "    if (gs + S - 1 < total && gs < 0) stage(gs + S - 1);")],
    "no_exchange": [(WIDE, "          peer_sources(srcs, xbuf, splits);",
                     "          peer_sources(srcs, xbuf, 1);"),
                    (WIDE, "const float4 v = peer(xsum, u * splits / kXUnits, splits)[u];",
                     "const float4 v = xsum[u];")],
    "no_merge": [(WIDE, "  peer_sources(srcs, accs, merge);", "  peer_sources(srcs, accs, 1);")],
    "no_dsplit": [(WIDE, "  if (ntiles <= 2) {", "  if (ntiles < 0) {")],
    "no_resident": [(WIDE, "  plan.a_res = !plan.dsplit && ", "  plan.a_res = false && ")],
    "half_splits": [(WIDE, "                              static_cast<int64_t>(rows) * batch * ntiles * spt_sum, sms,\n"
                           "                              min(max_splits, ntiles));",
                     "                              static_cast<int64_t>(rows) * batch * ntiles * spt_sum, sms,\n"
                     "                              max(1, min(max_splits, ntiles) / 2));")],
}
WIDE_BF16_SHAPES = {**WIDE_SHAPES, "C 512, 8 px": (4, 64, 64, 512), "N 4096": (4, 4096, 64, 512)}
# (kernel, dtype[, shape label]) -> (library, cuts, shape B, N, c_bar, C)
KERNELS = {
    (attention.KERNEL_NAME, "bfloat16"): (attention.KERNEL_NAME, FWD_CUTS, (4, 4096, 8, 64)),
    (attention.DQ_KERNEL, "bfloat16"): (attention.BWD_LIBRARY, DQ_CUTS, (3, 4096, 8, 64)),
    (attention.DKV_KERNEL, "bfloat16"): (attention.BWD_LIBRARY, DKV_CUTS, (3, 4096, 8, 64)),
    (attention.KERNEL_NAME, "float32"): (attention.KERNEL_NAME, FWD_TF32_CUTS,
                                         (4, 4096, 8, 64)),
    (attention.DQ_KERNEL, "float32"): (attention.BWD_LIBRARY, DQ_TF32_CUTS, (3, 4096, 8, 64)),
    (attention.DKV_KERNEL, "float32"): (attention.BWD_LIBRARY, DKV_TF32_CUTS,
                                        (3, 4096, 8, 64)),
}
WIDE_KERNELS = {
    **{(kernel, "float32", label): (library, WIDE_TF32_CUTS, shape)
       for label, shape in WIDE_SHAPES.items()
       for kernel, library in ((attention.KERNEL_NAME, attention.KERNEL_NAME),
                               (attention.DQ_KERNEL, attention.BWD_LIBRARY),
                               (attention.DKV_KERNEL, attention.BWD_LIBRARY))},
    **{(kernel, "bfloat16", label): (attention.BWD_LIBRARY, WIDE_BF16_CUTS, shape)
       for label, shape in WIDE_BF16_SHAPES.items()
       for kernel in (attention.DQ_KERNEL, attention.DKV_KERNEL)},
}


def build_copy(library: str, name: str, cuts, workdir: str) -> tuple[str, str]:
    """Compile csrc/<library>.cu with ``cuts`` applied; returns (name, .so)."""
    src_dir = os.path.join(workdir, name)
    shutil.copytree(cuda_build.CSRC_DIR, src_dir)
    path = os.path.join(src_dir, f"{library}.cu")
    for cut in cuts:
        file, old, new = cut if len(cut) == 3 else (f"{library}.cu", *cut)
        with open(os.path.join(src_dir, file)) as fh:
            text = fh.read()
        if old not in text:
            raise RuntimeError(f"{file} no longer holds the text {name} cuts: {old!r}")
        with open(os.path.join(src_dir, file), "w") as fh:
            fh.write(text.replace(old, new))
    out = os.path.join(src_dir, f"lib{library}.so")
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {name} copy of {library}.cu:\n{proc.stderr}")
    return name, out


def time_ms(fn, reps: int = 30) -> float:
    """Device time of one of ``fn``'s launches: ``reps`` launches queued
    while the card spins (``torch.cuda._sleep``), so that the events time
    the kernels back to back and not the host's dispatch of each; the mean,
    after 5 warm-ups."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e7))  # about 10 ms: longer than enqueueing reps calls
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                        help="time only the kernels of this type (default: both)")
    parser.add_argument("--wide", action="store_true",
                        help="the kernels past the register-held widths instead")
    args = parser.parse_args()
    kernels = {k: v for k, v in (WIDE_KERNELS if args.wide else KERNELS).items()
               if args.dtype in (None, k[1])}
    if not torch.cuda.is_available():
        print(json.dumps({"ok": False, "error": "no CUDA device"}))
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    workdir = tempfile.mkdtemp(prefix="flash_split_")
    try:
        # One build a copy of a library, whichever kernels and shapes share
        # its table of cuts.
        jobs = {(library, id(all_cuts), name): cuts for library, all_cuts, _ in kernels.values()
                for name, cuts in [("kernel", []), *all_cuts.items()]}
        with ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 8)) as pool:
            done = dict(zip(jobs, pool.map(lambda j: build_copy(
                j[0], j[2], jobs[j], os.path.join(workdir, f"{j[0]}-{j[1]}", j[2]))[1], jobs)))
        built = [(key, name, done[(library, id(all_cuts), name)])
                 for key, (library, all_cuts, _) in kernels.items()
                 for name in ["kernel", *all_cuts]]
        gen = torch.Generator(device="cuda").manual_seed(0)
        for key, (library, _, (b, n, c_bar, c)) in kernels.items():
            kernel, dtype = key[:2]
            dt = getattr(torch, dtype)
            f, g = (torch.randn(b, n, c_bar, device="cuda", generator=gen).to(dt)
                    for _ in range(2))
            h, do = (torch.randn(b, n, c, device="cuda", generator=gen).to(dt)
                     for _ in range(2))
            o, lse = attention.flash_attention_forward(f, g, h)
            delta = torch.sum(do.float() * o.float(), dim=-1)
            call = {
                attention.KERNEL_NAME: lambda: attention.flash_attention_forward(f, g, h),
                attention.DQ_KERNEL: lambda: attention.flash_attention_dq(f, g, h, do, lse, delta),
                attention.DKV_KERNEL: lambda: attention.flash_attention_dkv(f, g, h, do, lse, delta),
            }[kernel]
            copies = [(name, ctypes.CDLL(so)) for k, name, so in built if k == key]
            real = cuda_build.load(library)
            for rep in range(REPEATS):
                for name, lib in copies:
                    cuda_build._loaded[library] = lib  # the wrapper launches the copy
                    try:
                        ms = time_ms(call)
                    finally:
                        cuda_build._loaded[library] = real
                    print(json.dumps({"kernel": kernel, "B": b, "N": n, "c_bar": c_bar,
                                      "C": c, "dtype": dtype, "copy": name, "repeat": rep,
                                      "ms": ms, "card": smi}), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
