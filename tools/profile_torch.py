#!/usr/bin/env python3
"""Profile the PyTorch port's serving, training or generation path on one CUDA card.

The paths run the models ``chip_smoke.py`` drives, with seeded random
weights:

- ``--path serving``: the 256 px TwinGAN (batch norm, eq-lr, pixel norm,
  UNet, bf16, SAGAN attention at 64 px) loaded through ``ImageInferer``;
  ``--steps`` calls of ``infer_batch`` on ``--batch`` images;
- ``--path int8``: the same served in int8 (``ImageInferer(quantize=True)``),
  calibrated until its scales freeze; ``--steps`` frozen int8 batches;
  then kernel Q1 at each distinct conv of that batch
  (``chip_smoke.int8_kernel_rows``: both entries bit-equal to their plain
  versions, device times, bounds, ``torch._int_mm``) and a ``q1`` line of
  their sums over the batch's convs, bf16 out;
- ``--path train``: ``TwinGANTrainer`` on the same model with
  chip_smoke.py's training configuration (DRAGAN, Adam, n_critic 2, batch
  3, every sa_gamma 1); ``--steps`` rounds of ``round_step`` (one G step,
  one D step);
- ``--path generation``: ``GanTrainer`` on pggan256 (no norm, pixel norm,
  eq-lr, bf16, batch 12, DRAGAN, Adam, n_critic 2, random biases);
  ``--steps`` rounds of ``round_step``, whose D step runs the generator
  through kernel B4.

After warm-up, the steps run under ``torch.profiler``, which prints JSON
lines per step (a batch or a round):

- ``window``: host wall time, the device's busy time (the union of all
  kernel and copy intervals) and its idle share in that window, and the
  kernels and copies the device ran per step;
- ``groups``: device time by kind (each attention kernel, convolutions and
  matrix products, copies, the rest);
- ``top``: the kernels with the most device time.

Run from the repository root:

    python3 tools/profile_torch.py [--path serving|int8|train|generation] [--batch 4] \
        [--steps 10] [--repo DIR]

``--repo`` profiles another checkout's port (its ``twingan_tpu_torch`` and
``chip_smoke.py``), such as an unpacked ``git archive`` of the parent
commit, with this script: the launch counts and Q1's times of two
commits in one call, in turns (a checkout from before the fused entry
times ``conv_i8`` alone):

    python3 tools/profile_torch.py --path int8 --repo _archive/old && \
    python3 tools/profile_torch.py --path int8 && \
    python3 tools/profile_torch.py --path int8 && \
    python3 tools/profile_torch.py --path int8 --repo _archive/old
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _group(name: str) -> str:
    low = name.lower()
    if "fused_conv" in low:  # B4: the implicit GEMM (fp32 x: its float instance) or pass 2
        cores = ("second pass" if "pixel_norm_pass" in low
                 else "TF32 tensor cores" if "mma_kernelif" in low else "tensor cores")
        return f"fused conv kernel (B4, {cores})"
    for kernel in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"):
        if kernel in low:  # the variants' kernels are named *_mma_kernel and *_tf32_kernel
            cores = ("tensor cores" if f"{kernel}_mma" in low
                     else "TF32 tensor cores" if f"{kernel}_tf32" in low else "CUDA cores")
            return f"attention kernel ({kernel}, {cores})"
    if "conv_i8" in low:
        return "int8 conv kernel (Q1, tensor cores)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90_", "cutlass")):
        return "convolutions and matrix products"
    return "elementwise, norms, pooling, other"


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _serving_step(chip_smoke, batch: int, quantize: bool = False):
    import numpy as np
    from twingan_tpu_torch.infer.quantize import CALIB_MIN_IMAGES
    from twingan_tpu_torch.infer.translate import ImageInferer
    from twingan_tpu_torch.runner.checkpoint import save_stage

    cfg = chip_smoke.slice_config()
    stage_dir = tempfile.mkdtemp(prefix="twingan_profile_")
    try:
        save_stage(stage_dir, cfg, chip_smoke.random_translator(cfg).state_dict())
        inferer = ImageInferer(stage_dir, quantize=quantize)
    finally:
        shutil.rmtree(stage_dir, ignore_errors=True)
    rng = np.random.RandomState(chip_smoke.SEED)
    images = [rng.randint(0, 256, (256, 256, 3)).astype(np.uint8) for _ in range(batch)]
    while quantize and inferer.calibrated_images < CALIB_MIN_IMAGES:
        inferer.infer_batch(images)  # calibrates, then serves in int8
    return (lambda: inferer.infer_batch(images)), inferer, images


def _q1_sums(chip_smoke, inferer, images) -> dict:
    """Q1's rows at the convs of one int8 translate of ``images``, and
    their sums over those convs, bf16 out (each distinct shape's row
    times its count)."""
    import numpy as np
    import torch

    x = torch.from_numpy(np.stack([inferer.preprocess(im) for im in images]))
    # A checkout from before the fused entry gives (row, count) and rows
    # without its fields; this one (row, (count, input type)).
    rows = [(row, extra if isinstance(extra, tuple) else (extra, None))
            for row, extra in chip_smoke.int8_kernel_rows(chip_smoke.conv_shapes(inferer, x))]
    sums = {}
    for key in ("ms", "q_ms", "old_quantize_ms", "library_ms"):
        total = 0.0
        for row, (n, dtype) in rows:
            value = row.get(key)
            if not n or value is None:  # an extra case, or a field that checkout lacks
                continue
            if isinstance(value, dict):
                value = value["bfloat16" if key == "ms" else f"{dtype}->bfloat16"]
            total += value * n
        sums[key] = total
    return {"phase": "q1", "convs": sum(n for _, (n, _) in rows),
            "conv_i8_ms": sums["ms"], "conv_i8q_ms": sums["q_ms"] or None,
            "old_quantize_ms": sums["old_quantize_ms"] or None,
            "int_mm_ms": sums["library_ms"],
            "conv_i8_ms_by_case": {row["case"]: row["ms"]["bfloat16"] for row, _ in rows}}


def _train_step(chip_smoke):
    import numpy as np
    from twingan_tpu_torch.train.twingan_trainer import TwinGANTrainer

    cfg = chip_smoke.train_config()
    trainer = TwinGANTrainer(cfg)
    state = trainer.init_state(chip_smoke.SEED)
    chip_smoke.set_attention_gamma(state.nets)
    rng = np.random.RandomState(chip_smoke.SEED)
    batches = [chip_smoke._train_batch(rng, cfg, "cuda") for _ in range(cfg.n_critic)]
    return lambda: trainer.round_step(state, batches, rng=chip_smoke.SEED)


def _generation_step(chip_smoke):
    import numpy as np
    import torch
    from twingan_tpu_torch.train.gan_trainer import GanTrainer

    cfg = chip_smoke.generation_config()
    trainer = GanTrainer(cfg)
    state = trainer.init_state(chip_smoke.SEED)
    chip_smoke.randomize_biases(state.nets, chip_smoke.SEED)
    rng = np.random.RandomState(chip_smoke.SEED)
    res = cfg.model.resolution
    batches = [{"target": torch.from_numpy(rng.rand(cfg.batch_size, res, res, 3)
                                           .astype("float32")).to("cuda")}
               for _ in range(cfg.n_critic)]
    return lambda: trainer.round_step(state, batches, rng=chip_smoke.SEED)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--path", default="serving",
                   choices=["serving", "int8", "train", "generation"])
    p.add_argument("--batch", type=int, default=4, help="serving batch size")
    p.add_argument("--steps", type=int, default=10, help="batches or rounds profiled")
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--repo", default=REPO, help="the checkout whose port is profiled")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print(json.dumps({"ok": False, "error": "no CUDA device"}))
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    import chip_smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    if args.path in ("serving", "int8"):
        step, inferer, images = _serving_step(chip_smoke, args.batch, args.path == "int8")
    else:
        step = {"train": _train_step, "generation": _generation_step}[args.path](chip_smoke)
    for _ in range(3):
        step()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    # Kernels and copies; user annotations (such as the optimizer's step
    # range) are intervals on the device's timeline, not device work.
    device_events = [e for e in prof.events()
                     if str(getattr(e, "device_type", "")).endswith("CUDA")
                     and not getattr(e, "is_user_annotation", False)
                     and e.time_range.end > e.time_range.start]
    if not device_events:
        print(json.dumps({"ok": False, "error": "the profiler recorded no device activity"}))
        return 1
    busy_us = _busy_us([(e.time_range.start, e.time_range.end) for e in device_events])
    copies = sum("memcpy" in e.name.lower() or "memset" in e.name.lower()
                 for e in device_events)
    by_name: dict[str, float] = {}
    for e in device_events:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
    groups: dict[str, float] = {}
    for name, us in by_name.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + us
    n = args.steps
    unit = "batch" if args.path in ("serving", "int8") else "round"
    # Streams the device work ran on: with more than one, kernels overlap
    # and their summed time exceeds the busy time.
    streams = sorted({ev.device_resource_id() for ev in prof.profiler.kineto_results.events()
                      if str(ev.device_type()).endswith("CUDA") and not ev.is_user_annotation()})
    print(json.dumps({"phase": "window", "path": args.path, "card": smi,
                      "repo": os.path.abspath(args.repo),
                      f"kernels_per_{unit}": (len(device_events) - copies) / n,
                      f"copies_per_{unit}": copies / n,
                      "batch": {"serving": args.batch, "int8": args.batch,
                                "train": chip_smoke.TRAIN_BATCH,
                                "generation": chip_smoke.GEN_BATCH}[args.path],
                      "steps": n, f"wall_ms_per_{unit}": 1e3 * wall_s / n,
                      f"device_busy_ms_per_{unit}": busy_us / 1e3 / n,
                      f"device_summed_ms_per_{unit}": sum(by_name.values()) / 1e3 / n,
                      "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
                      "streams": streams}))
    print(json.dumps({"phase": "groups", f"ms_per_{unit}": {
        k: v / 1e3 / n for k, v in sorted(groups.items(), key=lambda kv: -kv[1])}}))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]
    print(json.dumps({"phase": "top", f"ms_per_{unit}": [[k[:120], v / 1e3 / n]
                                                          for k, v in top]}))
    if args.path == "int8":
        print(json.dumps({**_q1_sums(chip_smoke, inferer, images), "card": smi}))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
