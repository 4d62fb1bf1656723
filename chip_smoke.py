#!/usr/bin/env python3
"""Drive the PyTorch port (``twingan_tpu_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and no
result line is printed:

1. device  - the card's name and power limit; TF32 off for the comparisons.
2. build   - nvcc builds ``csrc/flash_attn_fwd.cu`` (the hand-written
             flash-attention forward kernel) into a ctypes library.
3. kernel  - at each listed shape, the kernel against its plain PyTorch
             version on the same inputs (output and logsumexp), with the
             kernel's, the plain version's and SDPA's times (CUDA events,
             median) beside the card's bound for the same work.
4. serving - the port's main path at full width: a 256 px TwinGAN (batch
             norm, eq-lr, pixel norm, UNet skips, bf16, SAGAN attention at
             64 px) with seeded random weights is written as a stage dir,
             loaded by ``ImageInferer`` and served to 8 concurrent requests
             per round through ``BatchingLocalClient``; the kernel's launch
             count must be 2 (encoder + generator) per dispatched batch, and
             one request must agree with the same weights run in fp32 on
             the CPU with the plain attention.
5. kernels - one line listing each kernel of the path.
Then the card as ``nvidia-smi`` names it, and the last line
``{"ok": true, "device": {...}}``.

It needs one CUDA card and the repository around it; without either it
exits non-zero. A watchdog ends it (non-zero) after 15 minutes.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

WATCHDOG_S = 900
SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "twingan_tpu_torch/csrc/flash_attn_fwd.cu"
KERNEL_REPLACES = "twingan_tpu/ops/attention.py:54"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the bound of a call is
# the larger of its bytes over the memory rate and its FLOPs over the peak
# of its input type (bf16 on the tensor cores, fp32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# (label, B, N, c_bar, C, dtype). The serving shape is the main path's: the
# client pads every batch to 4, and attention sits at 64 px (N = 4096) with
# C = 64 and c_bar = C / 8 in both the encoder and the generator.
SERVING_CASE = ("serving batch", 4, 4096, 8, 64, "bfloat16")
KERNEL_CASES = [
    ("slice", 8, 4096, 8, 64, "bfloat16"),
    ("slice", 8, 4096, 8, 64, "float32"),
    SERVING_CASE,
    ("ragged N", 2, 1000, 8, 64, "float32"),
    ("ragged N", 2, 1000, 8, 64, "bfloat16"),
    ("c_bar 1, C 8", 2, 4096, 1, 8, "float32"),
    ("c_bar 32, C 256", 2, 4096, 32, 256, "bfloat16"),
    ("docs/PERFORMANCE.md", 4, 4096, 32, 64, "float32"),
    ("docs/PERFORMANCE.md", 4, 16384, 32, 64, "float32"),
]

# Serving-path agreement with the fp32 CPU run, in units of the CPU
# output's standard deviation. bf16 keeps 8 significant bits and every
# layer rounds its activations; the same weights at 32 px (half the depth)
# in bf16 on the CPU differ from fp32 by 0.027 (mean) and 0.12 (max) of the
# std, so twice that depth gets 0.1 and 0.5. The check also requires that
# switching attention off (every sa_gamma 0) moves the fp32 output by more
# than the mean tolerance, so it can tell a wrong attention from a right one.
SERVE_MEAN_TOL = 0.1
SERVE_MAX_TOL = 0.5
REQUESTS_PER_ROUND = 8
TIMED_ROUNDS = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    emit({"phase": phase, "ok": False, "error": msg})
    sys.exit(1)


def start_watchdog() -> None:
    def fire():
        emit({"phase": "watchdog", "ok": False,
              "error": f"chip_smoke.py still running after {WATCHDOG_S} s"})
        os._exit(3)

    timer = threading.Timer(WATCHDOG_S, fire)
    timer.daemon = True
    timer.start()


def tolerance(dtype: str, ref_max: float) -> float:
    """Kernel vs plain version, max abs error on the output. fp32: the
    kernel sums N terms sequentially per row where the plain matmul sums
    blockwise, 1e-4 of the output's magnitude. bf16: both round the same
    fp32 result to 8 significant bits, so up to one unit in the last place
    (1/128 of the magnitude) apart, plus the plain version's bf16 cast of
    the probabilities: 1/64 of the magnitude."""
    scale = max(1.0, ref_max)
    return scale * (1e-4 if dtype == "float32" else 1.0 / 64)


def device_phase():
    import torch

    if not torch.cuda.is_available():
        fail("device", "no CUDA device: chip_smoke.py runs the port on the card only")
    if not os.path.isdir(os.path.join(REPO, "twingan_tpu_torch")):
        fail("device", f"twingan_tpu_torch not found beside chip_smoke.py in {REPO}")
    sys.path.insert(0, REPO)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail("device", f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "ok": True, "kind": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": "off for matmul and cuDNN"})
    return name, smi_line


def build_phase():
    from twingan_tpu_torch.ops import attention, cuda_build

    t0 = time.perf_counter()
    cuda_build.load(attention.KERNEL_NAME)
    seconds = time.perf_counter() - t0
    log = cuda_build.build_info[attention.KERNEL_NAME]["log"]
    regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "registers" in ln]
    emit({"phase": "build", "ok": True, "kernel": attention.KERNEL_NAME,
          "seconds": round(seconds, 3), "nvcc_seconds": cuda_build.build_info[attention.KERNEL_NAME]["seconds"],
          "ptxas": regs})


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` launches, each timed by CUDA events, after warm-up."""
    import torch

    for _ in range(3):
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


def bound(b: int, n: int, c_bar: int, c: int, dtype: str) -> tuple[float, str]:
    """Least time of the function on the card: each input read once, each
    output written once, the two products' FLOPs at the type's peak."""
    elt = 4 if dtype == "float32" else 2
    nbytes = elt * (2 * b * n * c_bar + b * n * c) + elt * b * n * c + 4 * b * n
    flops = 2.0 * b * n * n * (c_bar + c)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def kernel_phase() -> dict:
    import torch
    import torch.nn.functional as F
    from twingan_tpu_torch.ops import attention

    results = {}
    for label, b, n, c_bar, c, dtype in KERNEL_CASES:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        f = torch.randn(b, n, c_bar, device="cuda", generator=gen).to(dt)
        g = torch.randn(b, n, c_bar, device="cuda", generator=gen).to(dt)
        h = torch.randn(b, n, c, device="cuda", generator=gen).to(dt)
        o, lse = attention.flash_attention_forward(f, g, h)
        torch.cuda.synchronize()
        ref = attention.attention_core(f, g, h)
        ref_lse = attention.attention_lse(f, g)
        torch.cuda.synchronize()
        err = (o.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = tolerance(dtype, ref_max)
        lse_tol = 1e-4 * max(1.0, ref_lse.abs().max().item())
        q, k, v = f[:, None], g[:, None], h[:, None]
        sdpa_err = (F.scaled_dot_product_attention(q, k, v, scale=1.0)[:, 0].float()
                    - ref.float()).abs().max().item()
        ms = time_ms(lambda: attention.flash_attention_forward(f, g, h))
        plain_ms = time_ms(lambda: attention.attention_core(f, g, h))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
        bound_ms, bound_by = bound(b, n, c_bar, c, dtype)
        row = {"phase": "kernel", "case": label, "B": b, "N": n, "c_bar": c_bar, "C": c,
               "dtype": dtype, "max_abs_err": err, "tolerance": tol, "lse_err": lse_err,
               "lse_tolerance": lse_tol, "sdpa_err": sdpa_err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "ok": bool(err <= tol and lse_err <= lse_tol)}
        emit(row)
        if not row["ok"]:
            fail("kernel", f"flash_attn_fwd disagrees with the plain version at {label} "
                           f"B={b} N={n} c_bar={c_bar} C={c} {dtype}")
        results[(label, b, n, c_bar, c, dtype)] = row
    return results[SERVING_CASE]


def slice_config():
    from twingan_tpu_torch.models.config import PGGANConfig
    from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig

    return TwinGANConfig(
        model=PGGANConfig(resolution=256, max_channels=256, norm_type="batch_norm",
                          equalized_lr=True, do_pixel_norm=True, num_domains=2,
                          dtype="bfloat16", do_self_attention=True, self_attention_hw=64),
        use_unet=True)


def random_translator(cfg):
    """Seeded random weights in which attention and the norms show: every
    sa_gamma 1, norm banks and moving statistics drawn at random, and the
    target-domain bank of the output layer set to put images in [0,1] as a
    trained model's are (0.5 + 0.05 * normalized)."""
    import torch
    from twingan_tpu_torch.models.layers import DomainNorm, SelfAttention, reset_parameters
    from twingan_tpu_torch.train.twingan_trainer import TwinGANTranslator

    gen = torch.Generator().manual_seed(SEED)
    model = TwinGANTranslator(cfg)
    reset_parameters(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SelfAttention):
                m.sa_gamma.fill_(1.0)
            if isinstance(m, DomainNorm) and m.kind == "batch_norm":
                for name, t in list(m.named_parameters()) + list(m.named_buffers()):
                    if name.startswith(("gamma_", "moving_var_")):
                        t.uniform_(0.5, 1.5, generator=gen)
                    else:
                        t.normal_(0.0, 0.2, generator=gen)
        out_norm = getattr(model.generator, f"to_rgb_{cfg.model.resolution}").norm
        out_norm.gamma_1.fill_(0.05)
        out_norm.beta_1.fill_(0.5)
    return model


def serving_phase(card: str, smi_line: str) -> int:
    import numpy as np
    import torch
    from twingan_tpu_torch.infer.translate import ImageInferer
    from twingan_tpu_torch.ops import attention
    from twingan_tpu_torch.runner.checkpoint import save_stage
    from twingan_tpu_torch.serve.clients import BatchingLocalClient

    cfg = slice_config()
    stage_dir = tempfile.mkdtemp(prefix="twingan_smoke_")
    try:
        model = random_translator(cfg)
        save_stage(stage_dir, cfg, model.state_dict(), step=0)
        rng = np.random.RandomState(SEED)
        images = [rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)
                  for _ in range(REQUESTS_PER_ROUND)]

        inferer = ImageInferer(stage_dir)  # the card, by default
        client = BatchingLocalClient(inferer, max_batch=4, max_wait_ms=50.0)
        attention.reset_launch_counts()
        round_s = []
        try:
            with ThreadPoolExecutor(REQUESTS_PER_ROUND) as pool:
                for _ in range(1 + TIMED_ROUNDS):  # the first round warms up
                    t0 = time.perf_counter()
                    outs = list(pool.map(client.do_inference, images))
                    torch.cuda.synchronize()
                    round_s.append(time.perf_counter() - t0)
        finally:
            client.close()
        launches = attention.launch_counts[attention.KERNEL_NAME]
        dispatches = client.dispatches

        for i, out in enumerate(outs):
            if out.shape != (256, 256, 3) or not np.isfinite(out).all():
                fail("serving", f"request {i}: shape {out.shape}, finite {np.isfinite(out).all()}")
            if out.min() < 0.0 or out.max() > 1.0:
                fail("serving", f"request {i}: values in [{out.min()}, {out.max()}], not [0,1]")
        if launches != 2 * dispatches or dispatches < 2 * (1 + TIMED_ROUNDS):
            fail("serving", f"{launches} kernel launches for {dispatches} dispatched batches "
                            "(expected 2 per batch: encoder and generator)")

        cpu = ImageInferer(stage_dir, device="cpu", dtype="float32")
        ref = cpu.infer_batch([images[0]])[0]
        std = float(ref.std())
        diff = np.abs(outs[0] - ref)
        mean_err, max_err = float(diff.mean()) / std, float(diff.max()) / std
        with torch.no_grad():
            for m in cpu.model.modules():
                if hasattr(m, "sa_gamma"):
                    m.sa_gamma.zero_()
        no_attention = float(np.abs(cpu.infer_batch([images[0]])[0] - ref).mean()) / std
        timed = sorted(round_s[1:])[len(round_s[1:]) // 2]
        row = {"phase": "serving", "requests": REQUESTS_PER_ROUND * (1 + TIMED_ROUNDS),
               "dispatches": dispatches, "kernel_launches": launches,
               "images_per_s": REQUESTS_PER_ROUND / timed, "round_s": round_s,
               "card": card, "nvidia_smi": smi_line,
               "vs_cpu_fp32": {"mean_abs_err_over_std": mean_err, "max_abs_err_over_std": max_err,
                               "mean_tolerance": SERVE_MEAN_TOL, "max_tolerance": SERVE_MAX_TOL,
                               "output_std": std,
                               "attention_off_mean_diff_over_std": no_attention},
               "ok": bool(mean_err <= SERVE_MEAN_TOL and max_err <= SERVE_MAX_TOL
                          and no_attention > SERVE_MEAN_TOL)}
        emit(row)
        if not row["ok"]:
            fail("serving", "the card's output disagrees with the fp32 CPU run, or "
                            "attention does not change the output beyond the tolerance")
        return launches
    finally:
        shutil.rmtree(stage_dir, ignore_errors=True)


def main() -> int:
    start_watchdog()
    card, smi_line = device_phase()
    build_phase()
    serving_row = kernel_phase()
    launches = serving_phase(card, smi_line)
    emit({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": serving_row["max_abs_err"], "max_err": serving_row["max_abs_err"],
        "ms": serving_row["ms"], "plain_ms": serving_row["plain_ms"],
        "bound_ms": serving_row["bound_ms"], "bound_by": serving_row["bound_by"],
        "library_ms": serving_row["library_ms"]}]})
    print(smi_line, flush=True)
    import torch

    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
