#!/usr/bin/env python3
"""Convert a stage directory of the JAX runner (Orbax checkpoints) into a
stage directory of the PyTorch port.

    python tools/orbax_to_torch_stage.py SRC_STAGE_DIR DST_STAGE_DIR

Every ``ckpt-<step>`` of SRC is restored through the JAX package and
written as the port's ``ckpt-<step>/state.pt`` (the flat train state of
``twingan_tpu_torch.train.state.state_to_dict``: JAX state-dict paths,
conv kernels in PyTorch's OIHW layout); ``config.json`` is copied as it is
(both packages read the same schema), and ``model.pt``, the serving unit,
is written from the latest checkpoint. The port's ``StageRunner`` resumes
or grows from the result like from a stage it wrote itself.

A classifier train dir of the JAX ``classifier_runner`` (its
``config.json`` is a ``ClassifierConfig``) converts the same way
(``convert_classifier``, chosen by the config): every checkpoint becomes
the port's flat ``ClassifierTrainer`` state, conv kernels in OIHW as
above, and the port's ``classifier_runner`` and FID
functions restore it. No ``model.pt`` is written for it.

Runs on the CPU; it imports both packages, which the port itself never
does.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def convert_stage(src: str, dst: str) -> list[int]:
    """Convert every checkpoint of ``src`` into ``dst``; returns the steps."""
    from twingan_tpu.runner.checkpoint import CheckpointManager as JaxCheckpointManager

    from twingan_tpu_torch import bridge
    from twingan_tpu_torch.runner.checkpoint import CheckpointManager, save_model
    from twingan_tpu_torch.train import gan_trainer, twingan_trainer
    from twingan_tpu_torch.train.state import serving_state_dict

    jcm = JaxCheckpointManager(src)
    steps = jcm.all_steps()
    if not steps:
        raise FileNotFoundError(f"no Orbax checkpoint under {src}")
    cm = CheckpointManager(dst)
    shutil.copyfile(os.path.join(src, "config.json"), os.path.join(dst, "config.json"))
    with open(os.path.join(dst, "config.json")) as f:
        twingan = "l_cyc_weight" in json.load(f)["trainer"]
    flat = None
    for step in steps:
        flat = bridge.torch_flat(bridge.flat_from_flax(jcm.restore_dict(step)))
        cm.save(step, flat, keep=0)
    if twingan:
        served = serving_state_dict(flat, (twingan_trainer.ENC, twingan_trainer.GEN))
    else:
        served = serving_state_dict(flat, (gan_trainer.GEN,), ema_net=gan_trainer.GEN)
    save_model(dst, served, int(flat["step"]))
    return steps


def is_classifier_dir(src: str) -> bool:
    with open(os.path.join(src, "config.json")) as f:
        return "network" in json.load(f)


def convert_classifier(src: str, dst: str) -> list[int]:
    """Convert every checkpoint of a JAX classifier train dir ``src`` into
    ``dst``; returns the steps."""
    from twingan_tpu.runner.checkpoint import CheckpointManager as JaxCheckpointManager

    from twingan_tpu_torch import bridge
    from twingan_tpu_torch.runner.checkpoint import CheckpointManager

    jcm = JaxCheckpointManager(src)
    steps = jcm.all_steps()
    if not steps:
        raise FileNotFoundError(f"no Orbax checkpoint under {src}")
    cm = CheckpointManager(dst)
    shutil.copyfile(os.path.join(src, "config.json"), os.path.join(dst, "config.json"))
    for step in steps:
        cm.save(step, bridge.classifier_torch_flat(bridge.flat_from_flax(jcm.restore_dict(step))),
                keep=0)
    return steps


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src", help="a JAX runner's stage directory, or a JAX classifier train "
                               "dir (ckpt-<step>/ by Orbax)")
    p.add_argument("dst", help="the port's stage directory to write")
    args = p.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    convert = convert_classifier if is_classifier_dir(args.src) else convert_stage
    steps = convert(args.src, args.dst)
    print(f"converted {len(steps)} checkpoints {steps} from {args.src} to {args.dst}")


if __name__ == "__main__":
    main()
