"""Image classifier training and evaluation CLI on the port.

Counterpart of ``twingan_tpu/runner/classifier_runner.py``, every flag
kept, plus ``--device`` (the card by default, ``cpu`` on request). Modes:

- train    multi-label (sigmoid) or softmax training; checkpoints and the
           config snapshot in ``--train_dir``, a ``logs/`` metrics file;
- eval     AUC, precision and recall at 0.5 over ``--num_eval_batches``;
- tags     top-k tag files (``tags.txt``), optionally through the tag-group
           filter of ``--tags_group_file``;
- gradcam  Grad-CAM overlays of one batch at ``--gradcam_layer``
           (``gradcam.png``).

Synthetic data (``--use_synthetic_data``, or no ``--dataset_dir``) draws
each batch from ``np.random.RandomState(seed)`` as the JAX CLI does, so both
packages see the same images and labels; real data comes from tfrecord
shards through ``TFRecordSource``, preprocessed on the device by the
model's entry of ``data/preprocessing_factory.py`` (draws from a generator
seeded by ``--seed``), with the first ``labels_offset`` label columns
dropped. ``eval``, ``tags`` and ``gradcam`` rebuild the trained config from
the train dir's ``config.json`` (``load_config_snapshot``). Checkpoints are
the port's (``ckpt-<step>/state.pt``); a JAX train dir converts with
``tools/orbax_to_torch_stage.py``.

    python -m twingan_tpu_torch.runner.classifier_runner --mode=train \\
        --model_name=illust2vec --train_image_size=224 --use_synthetic_data \\
        --train_dir=/tmp/tagger --max_number_of_steps=100 [--device=cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from twingan_tpu_torch.data.datasets import get_dataset
from twingan_tpu_torch.data.pipeline import TFRecordSource
from twingan_tpu_torch.data.preprocess import PreprocessConfig
from twingan_tpu_torch.data.preprocessing_factory import get_preprocessing
from twingan_tpu_torch.data.tfrecord import list_shards
from twingan_tpu_torch.runner.checkpoint import CheckpointManager, save_config_snapshot
from twingan_tpu_torch.train.base import resolve_device
from twingan_tpu_torch.train.classifier_trainer import (
    ClassifierConfig,
    ClassifierTrainer,
    classifier_state_from_dict,
    classifier_state_to_dict,
)
from twingan_tpu_torch.train.optimizers import OptimizerConfig
from twingan_tpu_torch.utils.summary import SummaryWriter


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", default="train", choices=["train", "eval", "tags", "gradcam"])
    p.add_argument("--train_dir", required=True)
    p.add_argument("--model_name", default="illust2vec")
    p.add_argument("--num_classes", type=int, default=1539)
    p.add_argument("--labels_offset", type=int, default=0,
                   help="drop the first N label columns and shrink the logits layer by N")
    p.add_argument("--multi_label", default=True, type=lambda v: str(v).lower() in ("1", "true"))
    p.add_argument("--dataset_name", default="danbooru_2_illust2vec")
    p.add_argument("--dataset_dir", default="")
    p.add_argument("--dataset_split_name", default="train")
    p.add_argument("--use_synthetic_data", action="store_true")
    p.add_argument("--train_image_size", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_number_of_steps", type=int, default=10000)
    p.add_argument("--learning_rate", type=float, default=0.01)
    p.add_argument("--optimizer", default="rmsprop")
    p.add_argument("--weight_decay", type=float, default=0.00004,
                   help="coupled L2 weight decay")
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--preprocessing_name", default="")
    p.add_argument("--log_every_n_steps", type=int, default=50)
    p.add_argument("--save_every_n_steps", type=int, default=1000)
    p.add_argument("--num_eval_batches", type=int, default=16)
    p.add_argument("--tags_id_lookup_file", default="")
    p.add_argument("--tag_threshold", type=float, default=0.25)
    # A TSV mapping label id -> tag group: only the best label per group is
    # kept, and images missing hair (group 2) or eye (group 3) colour emit
    # no tags.
    p.add_argument("--tags_group_file", default="")
    p.add_argument("--gradcam_layer", default="conv5")
    p.add_argument("--output_dir", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    return p


def make_batches(args, cfg: ClassifierConfig, training: bool, device: torch.device):
    """Yields {"image": NHWC, "labels": [B, classes]} batches: numpy
    arrays for synthetic data, tensors on ``device`` for records."""
    # The trained config's offset wins, so eval and tags on a train dir
    # realign without the flag; the flag covers train mode.
    offset = getattr(cfg, "labels_offset", 0) or getattr(args, "labels_offset", 0)
    if args.use_synthetic_data or not args.dataset_dir:
        rng = np.random.RandomState(args.seed)
        while True:
            imgs = rng.rand(cfg.batch_size, cfg.image_hw, cfg.image_hw, 3).astype(np.float32)
            labels = (rng.rand(cfg.batch_size, cfg.num_classes) > 0.9).astype(np.float32)
            yield {"image": imgs, "labels": labels}
    pp_name = args.preprocessing_name or args.model_name
    try:
        device_pp = get_preprocessing(pp_name, cfg.image_hw, is_training=training)
    except ValueError:
        device_pp = get_preprocessing("danbooru", cfg.image_hw, is_training=training)
    generator = torch.Generator(device=device).manual_seed(args.seed + (0 if training else 1))
    # The records carry the whole vocabulary; the net sees num_classes.
    spec = get_dataset(args.dataset_name, num_classes=cfg.num_classes + offset,
                       vocab_file=args.tags_id_lookup_file or None)
    src = TFRecordSource(spec, list_shards(args.dataset_dir, args.dataset_split_name),
                         PreprocessConfig(output_hw=cfg.image_hw, is_training=False),
                         cfg.batch_size, seed=args.seed, repeat=training)
    for batch in iter(src):
        labels = batch.get("target", batch.get("conditional_labels"))
        if labels is None:
            continue
        imgs = device_pp(torch.as_tensor(np.asarray(batch["source"])).to(device),
                         generator=generator)
        labels = torch.as_tensor(np.asarray(labels))
        if offset:
            labels = labels[..., offset:]
        yield {"image": imgs, "labels": labels}


def load_config_snapshot(train_dir: str) -> ClassifierConfig:
    """The trained config from a train dir's ``config.json`` (the
    optimizer too, whose slots must match the checkpoint's)."""
    with open(os.path.join(train_dir, "config.json")) as f:
        data = json.load(f)
    opt_fields = {f.name for f in dataclasses.fields(OptimizerConfig)}
    opt = data.pop("opt")
    opt = OptimizerConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in opt.items() if k in opt_fields})
    fields = {f.name for f in dataclasses.fields(ClassifierConfig)}
    return ClassifierConfig(**{k: v for k, v in data.items() if k in fields and k != "opt"},
                            opt=opt)


def load_trained_classifier(train_dir: str, device=None, step: Optional[int] = None):
    """(trainer, restored state) from a classifier train dir, at ``step``
    (the latest checkpoint when None)."""
    cfg = load_config_snapshot(train_dir)
    trainer = ClassifierTrainer(cfg, device=device)
    state = CheckpointManager(train_dir).restore(
        trainer.init_state(cfg.seed), step=step, to_dict=classifier_state_to_dict,
        from_dict=classifier_state_from_dict)
    if state is None:
        raise FileNotFoundError(f"no checkpoint in {train_dir}")
    return trainer, state


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    snapshot = os.path.join(args.train_dir, "config.json")
    if args.mode != "train" and os.path.exists(snapshot):
        cfg = load_config_snapshot(args.train_dir)
    else:
        cfg = ClassifierConfig(
            network=args.model_name,
            num_classes=args.num_classes - args.labels_offset,
            labels_offset=args.labels_offset,
            multi_label=args.multi_label,
            image_hw=args.train_image_size or 64,
            batch_size=args.batch_size,
            label_smoothing=args.label_smoothing,
            seed=args.seed,
            total_steps=args.max_number_of_steps,
            opt=OptimizerConfig(optimizer=args.optimizer, learning_rate=args.learning_rate,
                                weight_decay=args.weight_decay),
        )
    trainer = ClassifierTrainer(cfg, device=device)
    cm = CheckpointManager(args.train_dir)
    state = trainer.init_state(args.seed)
    restored = cm.restore(state, to_dict=classifier_state_to_dict,
                          from_dict=classifier_state_from_dict)
    if restored is not None:
        state = restored
        print(f"resumed at step {state.step}")
    elif args.mode != "train":
        # Scores of a random init would look plausible: refuse.
        raise FileNotFoundError(
            f"--mode={args.mode} needs a trained checkpoint in {args.train_dir}, found none")
    result: dict = {"mode": args.mode}

    if args.mode == "train":
        save_config_snapshot(args.train_dir, cfg)
        writer = SummaryWriter(os.path.join(args.train_dir, "logs"))
        batches = make_batches(args, cfg, training=True, device=device)
        losses = []
        t0 = time.time()
        while state.step < args.max_number_of_steps:
            state, metrics = trainer.train_step(state, next(batches))
            cur = state.step
            losses.append(metrics["loss"])
            if cur % args.log_every_n_steps == 0:
                rate = args.log_every_n_steps / max(time.time() - t0, 1e-9)
                t0 = time.time()
                loss = float(metrics["loss"])
                print(f"step {cur}/{args.max_number_of_steps} loss={loss:.4f} "
                      f"{rate:.1f} steps/s")
                writer.scalars(cur, {"loss": loss, "steps_per_sec": rate})
            if cur % args.save_every_n_steps == 0:
                cm.save(cur, classifier_state_to_dict(state))
        cm.save(state.step, classifier_state_to_dict(state))
        writer.close()
        result.update(step=state.step, losses=[float(v) for v in losses])

    elif args.mode == "eval":
        batches = make_batches(args, cfg, training=False, device=device)
        eval_batches = [next(batches) for _ in range(args.num_eval_batches)]
        metrics = trainer.evaluate(state, eval_batches)
        print({k: round(v, 4) for k, v in metrics.items()})
        result.update(metrics=metrics)

    elif args.mode == "tags":
        if not args.tags_id_lookup_file:
            raise ValueError("--tags_id_lookup_file required for tags mode")
        with open(args.tags_id_lookup_file, encoding="utf-8") as f:
            tag_names = [line.rstrip("\n") for line in f]
        # Logit j was trained against vocabulary index j + offset.
        offset = getattr(cfg, "labels_offset", 0) or args.labels_offset
        if offset:
            tag_names = tag_names[offset:]
        out = args.output_dir or os.path.join(args.train_dir, "tags_out")
        os.makedirs(out, exist_ok=True)
        groups = None
        if args.tags_group_file:
            from twingan_tpu_torch.utils.misc import get_tags_dict

            groups = get_tags_dict(args.tags_group_file, 0, 2)
        batches = make_batches(args, cfg, training=False, device=device)
        written = 0
        path = os.path.join(out, "tags.txt")
        for _ in range(args.num_eval_batches):
            batch = next(batches)
            names = [f"img_{written + i}" for i in range(len(batch["image"]))]
            trainer.write_tags(state, batch["image"], names, tag_names, path,
                               threshold=args.tag_threshold, labels_id_to_group=groups)
            written += len(names)
        print(f"wrote tags for {written} images to {path}")
        result.update(path=path, images=written)

    elif args.mode == "gradcam":
        from twingan_tpu_torch.utils.image_io import save_image_grid

        out = args.output_dir or os.path.join(args.train_dir, "gradcam")
        batch = next(make_batches(args, cfg, training=False, device=device))
        imgs = torch.clamp(torch.as_tensor(batch["image"]), 0.0, 1.0)
        overlays = trainer.grad_cam_images(state, imgs, layer=args.gradcam_layer)
        path = os.path.join(out, "gradcam.png")
        save_image_grid(path, overlays)
        print(f"wrote {path}")
        result.update(path=path, overlays=overlays)
    return result


if __name__ == "__main__":
    main()
