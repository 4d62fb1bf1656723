#!/usr/bin/env python3
"""Profile the PyTorch port's serving, training or generation path on one CUDA card.

The paths run the models ``chip_smoke.py`` drives, with seeded random
weights:

- ``--path serving``: the 256 px TwinGAN (batch norm, eq-lr, pixel norm,
  UNet, bf16, SAGAN attention at 64 px) loaded through ``ImageInferer``;
  ``--steps`` calls of ``infer_batch`` on ``--batch`` images;
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
  kernel and copy intervals) and its idle share in that window;
- ``groups``: device time by kind (each attention kernel, convolutions and
  matrix products, copies, the rest);
- ``top``: the kernels with the most device time.

Run from the repository root:

    python3 tools/profile_torch.py [--path serving|train|generation] [--batch 4] [--steps 10]
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
    if "fused_conv" in low:  # B4: the tensor-core kernel and its split-K sum, or CUDA cores
        cores = "CUDA cores" if "fused_conv_kernel" in low else "tensor cores"
        return f"fused conv kernel (B4, {cores})"
    for kernel in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"):
        if kernel in low:  # the tensor-core variants' kernels are named *_mma_kernel
            cores = "tensor cores" if f"{kernel}_mma" in low else "CUDA cores"
            return f"attention kernel ({kernel}, {cores})"
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


def _serving_step(chip_smoke, batch: int):
    import numpy as np
    from twingan_tpu_torch.infer.translate import ImageInferer
    from twingan_tpu_torch.runner.checkpoint import save_stage

    cfg = chip_smoke.slice_config()
    stage_dir = tempfile.mkdtemp(prefix="twingan_profile_")
    try:
        save_stage(stage_dir, cfg, chip_smoke.random_translator(cfg).state_dict())
        inferer = ImageInferer(stage_dir)
    finally:
        shutil.rmtree(stage_dir, ignore_errors=True)
    rng = np.random.RandomState(chip_smoke.SEED)
    images = [rng.randint(0, 256, (256, 256, 3)).astype(np.uint8) for _ in range(batch)]
    return lambda: inferer.infer_batch(images)


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
    p.add_argument("--path", default="serving", choices=["serving", "train", "generation"])
    p.add_argument("--batch", type=int, default=4, help="serving batch size")
    p.add_argument("--steps", type=int, default=10, help="batches or rounds profiled")
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print(json.dumps({"ok": False, "error": "no CUDA device"}))
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    step = {"serving": lambda: _serving_step(chip_smoke, args.batch),
            "train": lambda: _train_step(chip_smoke),
            "generation": lambda: _generation_step(chip_smoke)}[args.path]()
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
    by_name: dict[str, float] = {}
    for e in device_events:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
    groups: dict[str, float] = {}
    for name, us in by_name.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + us
    n = args.steps
    unit = "batch" if args.path == "serving" else "round"
    # Streams the device work ran on: with more than one, kernels overlap
    # and their summed time exceeds the busy time.
    streams = sorted({ev.device_resource_id() for ev in prof.profiler.kineto_results.events()
                      if str(ev.device_type()).endswith("CUDA") and not ev.is_user_annotation()})
    print(json.dumps({"phase": "window", "path": args.path, "card": smi,
                      "batch": {"serving": args.batch, "train": chip_smoke.TRAIN_BATCH,
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
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
