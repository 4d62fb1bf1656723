#!/usr/bin/env python3
"""Profile the PyTorch port's serving path on one CUDA card.

Builds the model ``chip_smoke.py`` serves (256 px TwinGAN, batch norm,
eq-lr, pixel norm, UNet, bf16, SAGAN attention at 64 px; seeded random
weights), loads it through ``ImageInferer`` on the card, warms up, then
runs ``--batches`` calls of ``infer_batch`` on ``--batch`` images under
``torch.profiler`` and prints JSON lines:

- ``window``: host wall time per batch, the device's busy time (the union
  of all kernel and copy intervals) and its idle share in that window;
- ``groups``: device time per batch by kind (the attention kernel,
  convolutions, copies, the rest);
- ``top``: the kernels with the most device time per batch.

Run from the repository root:

    python3 tools/profile_torch_serving.py [--batch 4] [--batches 10]
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
    if "flash_attn_fwd" in low:
        return "attention kernel (flash_attn_fwd)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90_", "cutlass")):
        return "convolutions"
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--batches", type=int, default=10)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print(json.dumps({"ok": False, "error": "no CUDA device"}))
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from twingan_tpu_torch.infer.translate import ImageInferer
    from twingan_tpu_torch.runner.checkpoint import save_stage

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = chip_smoke.slice_config()
    stage_dir = tempfile.mkdtemp(prefix="twingan_profile_")
    try:
        save_stage(stage_dir, cfg, chip_smoke.random_translator(cfg).state_dict())
        inferer = ImageInferer(stage_dir)
    finally:
        shutil.rmtree(stage_dir, ignore_errors=True)
    rng = np.random.RandomState(chip_smoke.SEED)
    images = [rng.randint(0, 256, (256, 256, 3)).astype(np.uint8) for _ in range(args.batch)]
    for _ in range(3):
        inferer.infer_batch(images)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.batches):
            inferer.infer_batch(images)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    device_events = [e for e in prof.events()
                     if str(getattr(e, "device_type", "")).endswith("CUDA")
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
    n = args.batches
    print(json.dumps({"phase": "window", "card": smi, "batch": args.batch, "batches": n,
                      "wall_ms_per_batch": 1e3 * wall_s / n,
                      "device_busy_ms_per_batch": busy_us / 1e3 / n,
                      "device_idle_share": 1.0 - busy_us / 1e6 / wall_s}))
    print(json.dumps({"phase": "groups", "ms_per_batch": {
        k: v / 1e3 / n for k, v in sorted(groups.items(), key=lambda kv: -kv[1])}}))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]
    print(json.dumps({"phase": "top", "ms_per_batch": [[k[:120], v / 1e3 / n] for k, v in top]}))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
