"""Evaluation CLI on the port.

Counterpart of ``twingan_tpu/evals/run_eval.py``, every flag kept, plus
``--device`` (the card by default, ``cpu`` on request). Modes (--mode):

- loss        streaming means of every TwinGAN loss over eval batches
              (the G step's metrics on the stage's restored train state)
- swd         sliced Wasserstein protocol on real vs translated images
- msssim      MS-SSIM diversity of the translated set, and the cycle
              fidelity translate(translate(s), t2s) vs s
- eval_debug  HTML gallery of sources / targets / translations
- output      embedding CSV dump (the content encoding of each image)
- fid         Fréchet distance of real vs translated images in the
              features of a random-init InceptionV3 (``Mixed_5b``, pooled;
              the port's own draws from ``--seed``: a relative metric whose
              numbers differ from the JAX package's at the same seed), or
              of the classifier at ``--classifier_path`` (``PreLogits``)
- inception_score  the 10-split inception score of the translations: the
              classifier's logits at ``--classifier_path``, or the same
              random InceptionV3 features through a fixed random head
              [features, 1000] / sqrt(features) drawn from ``--seed`` + 1

Translations go through the port's ``ImageInferer`` (the stage's
``model.pt``); ``loss`` and ``output`` restore the stage's latest
checkpoint into a ``TwinGANTrainer``, as the JAX CLI does. ``main`` takes
``inception_weights`` (an InceptionV3 ``state_dict``) and ``is_head`` (the
random head) in place of the port's draws, which is how the tests hand
both packages the same numbers.

    python -m twingan_tpu_torch.evals.run_eval --mode=swd \\
        --model_path=/trained --dataset_dir=... --target_dataset_dir=... \\
        --eval_dir=/tmp/eval [--swd_num_images=8192]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from twingan_tpu_torch.data.datasets import get_dataset
from twingan_tpu_torch.data.pipeline import SyntheticSource, TFRecordSource, UnpairedSource
from twingan_tpu_torch.data.preprocess import PreprocessConfig
from twingan_tpu_torch.data.tfrecord import list_shards
from twingan_tpu_torch.evals.gallery import write_embeddings_csv, write_html_gallery
from twingan_tpu_torch.evals.metrics import msssim_eval, pairwise_msssim, swd_eval
from twingan_tpu_torch.infer.translate import ImageInferer
from twingan_tpu_torch.runner.checkpoint import CheckpointManager
from twingan_tpu_torch.train.twingan_trainer import DOMAIN_S, ENC, TwinGANTrainer

MODES = ("loss", "swd", "msssim", "fid", "inception_score", "eval_debug", "output")


def build_batches(args, hw: int):
    """Yields {source, target} float batches at hw."""
    if args.use_synthetic_data or not args.dataset_dir:
        src = SyntheticSource(args.batch_size, hw, seed=args.seed, keys=("source", "target"))
        it = iter(src)
        while True:
            yield next(it)
    else:
        pp = PreprocessConfig(output_hw=hw, resize_mode=args.resize_mode, is_training=False)
        a = TFRecordSource(get_dataset(args.dataset_name),
                           list_shards(args.dataset_dir, args.dataset_split_name),
                           pp, args.batch_size, seed=args.seed, repeat=True)
        b = TFRecordSource(get_dataset(args.target_dataset_name),
                           list_shards(args.target_dataset_dir or args.dataset_dir,
                                       args.dataset_split_name),
                           pp, args.batch_size, seed=args.seed + 1, repeat=True)
        yield from iter(UnpairedSource(a, b))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", required=True, choices=list(MODES))
    p.add_argument("--model_path", required=True)
    p.add_argument("--classifier_path", default="",
                   help="trained classifier dir for --mode=inception_score and "
                        "--mode=fid (default: random-init InceptionV3 features)")
    p.add_argument("--eval_dir", default="/tmp/twingan_eval")
    p.add_argument("--dataset_name", default="image_only")
    p.add_argument("--dataset_dir", default="")
    p.add_argument("--target_dataset_name", default="image_only")
    p.add_argument("--target_dataset_dir", default="")
    p.add_argument("--dataset_split_name", default="train")
    p.add_argument("--use_synthetic_data", action="store_true")
    p.add_argument("--resize_mode", default="PAD")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_images", type=int, default=512)
    p.add_argument("--swd_num_images", type=int, default=8192)
    p.add_argument("--swd_save_images", action="store_true",
                   help="dump the generated SWD sample set under "
                        "eval_dir/swd_debug/<ts>/ (needs PIL)")
    p.add_argument("--output_single_file_name", default="embeddings.csv")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    return p


def restore_trainer(inferer: ImageInferer, stage_dir: str, device: torch.device):
    """The stage's TwinGAN trainer and its latest train state."""
    trainer = TwinGANTrainer(inferer.cfg, device=device)
    state = CheckpointManager(stage_dir).restore(trainer.init_state(0))
    if state is None:
        raise FileNotFoundError(f"no checkpoint in {stage_dir}")
    return trainer, state


def random_is_head(features: int, seed: int) -> torch.Tensor:
    """The inception score's random head without a classifier: N(0, 1)
    [features, 1000] from a CPU generator seeded by ``seed``, / sqrt(features)."""
    w = torch.randn((features, 1000), generator=torch.Generator().manual_seed(int(seed)))
    return w / torch.sqrt(torch.tensor(float(features)))


def random_head_logits_fn(feats, seed: int, head=None):
    """The inception score's logits without a classifier: the batch's
    features over their std, through ``head`` (``random_is_head`` of the
    feature width and ``seed`` when None)."""
    w = {}

    def logits_fn(images: torch.Tensor) -> torch.Tensor:
        f = feats(images)
        if "w" not in w:
            drawn = head if head is not None else random_is_head(f.shape[-1], seed)
            w["w"] = torch.as_tensor(drawn).to(f.device, torch.float32)
        return (f / (torch.std(f, correction=0) + 1e-6)) @ w["w"]

    return logits_fn


def main(argv=None, inception_weights=None, is_head=None) -> dict:
    args = build_parser().parse_args(argv)
    inferer = ImageInferer(args.model_path, device=args.device)
    device = inferer.device
    hw = inferer.image_hw
    os.makedirs(args.eval_dir, exist_ok=True)

    def translate(x, direction: str = "s2t") -> np.ndarray:
        return inferer.translate(torch.as_tensor(np.asarray(x, np.float32)),
                                 direction).float().cpu().numpy()

    batches = build_batches(args, hw)
    result: dict = {"mode": args.mode}

    if args.mode == "loss":
        from twingan_tpu_torch.evals.metrics import streaming_loss_eval

        trainer, state = restore_trainer(inferer, inferer.stage_dir, device)

        def loss_fn(batch):
            # The G step on a copy of the state: metrics only.
            metrics = trainer.eval_metrics(state, {k: v.to(device) for k, v in batch.items()},
                                           0)
            return {k: v for k, v in metrics.items() if np.ndim(v) == 0}

        n = max(1, args.num_images // args.batch_size)
        results = streaming_loss_eval(loss_fn, batches, num_batches=n)
        out = os.path.join(args.eval_dir, "eval_losses.txt")
        with open(out, "w") as f:
            for k, v in sorted(results.items()):
                f.write(f"{k}\t{v:.6f}\n")
        print({k: round(v, 4) for k, v in results.items()})
        print("written:", out)
        result.update(losses=results, path=out)

    elif args.mode == "swd":
        reals, fakes, n = [], [], 0
        for batch in batches:
            reals.append(np.asarray(batch["target"], np.float32))
            fakes.append(translate(batch["source"]))
            n += len(reals[-1])
            if n >= args.swd_num_images:
                break
        if args.swd_save_images:
            from twingan_tpu_torch.utils.image_io import save_image_grid

            dbg = os.path.join(args.eval_dir, "swd_debug", str(int(time.time())))
            os.makedirs(dbg, exist_ok=True)
            for bi, fb in enumerate(fakes):
                save_image_grid(os.path.join(dbg, f"batch_{bi}.png"), fb)
            print("swd debug images:", dbg)
        path = os.path.join(args.eval_dir, f"swd_eval_step_0_{n}_images.txt")
        table = swd_eval(args.seed, reals, fakes, num_images=args.swd_num_images,
                         save_path=path, device=device)
        if table is None:
            print("resolution < 16: SWD skipped (reference behavior)")
        else:
            print("SWD x1e3 per resolution:", table)
            print("written:", path)
        result.update(table=table, path=path, images=n)

    elif args.mode == "msssim":
        if hw < 16:
            # 5-level MS-SSIM box-downsamples 4x: hw//16 must be >= 1.
            print("resolution < 16: 5-level MS-SSIM does not fit; skipped")
            return result
        fakes, sources, cycles, n = [], [], [], 0
        for batch in batches:
            src = np.asarray(batch["source"], np.float32)
            t_prime = translate(src)
            sources.append(src)
            fakes.append(t_prime)
            cycles.append(translate(t_prime, "t2s"))  # back to the source domain
            n += len(src)
            if n >= args.num_images:
                break
        diversity = msssim_eval(fakes, device=device)
        fidelity = pairwise_msssim(np.concatenate(cycles)[: args.num_images],
                                   np.concatenate(sources)[: args.num_images], device=device)
        print(f"translated-set MS-SSIM diversity (lower = more diverse): {diversity:.4f}")
        print(f"cycle fidelity MS-SSIM s vs s2t2s (higher = better): {fidelity:.4f}")
        result.update(diversity=diversity, fidelity=fidelity, images=n)

    elif args.mode == "fid":
        from twingan_tpu_torch.evals.metrics import (
            classifier_features_fn,
            fid,
            inception_pool_features_fn,
        )

        if args.classifier_path:
            feats = classifier_features_fn(args.classifier_path, device=device)
            kind = "trained-classifier features"
        else:
            feats = inception_pool_features_fn(image_hw=hw, seed=args.seed,
                                               weights=inception_weights, device=device)
            draws = ("given weights" if inception_weights is not None
                     else f"the port's own draws from seed {args.seed}")
            kind = f"random-feature inception ({draws}), relative metric"
        reals, fakes, n = [], [], 0
        for batch in batches:
            reals.append(np.asarray(batch["target"], np.float32))
            fakes.append(translate(batch["source"]))
            n += len(reals[-1])
            if n >= args.num_images:
                break
        score = fid(feats, reals, fakes, device=device)
        out = os.path.join(args.eval_dir, "fid.txt")
        with open(out, "w") as f:
            f.write(f"fid\t{score:.6f}\t{n} images\t{kind}\n")
        print(f"FID ({kind}): {score:.4f} over {n} images")
        print("written:", out)
        result.update(fid=score, images=n, kind=kind, path=out)

    elif args.mode == "inception_score":
        # The reference protocol: softmax of logits over the translations,
        # 10-split exp-KL.
        from twingan_tpu_torch.evals.metrics import inception_score

        if args.classifier_path:
            from twingan_tpu_torch.evals.metrics import classifier_fn

            forward = classifier_fn(args.classifier_path, device)

            def logits_fn(images):
                return forward(images)[0]
        else:
            # Random-init logits at the deep head collapse (the score would
            # be exactly 1.0): Mixed_5b's pooled features through a fixed
            # random head instead, a relative diversity measure.
            from twingan_tpu_torch.evals.metrics import inception_pool_features_fn

            feats = inception_pool_features_fn(image_hw=hw, seed=args.seed,
                                               weights=inception_weights, device=device)
            logits_fn = random_head_logits_fn(feats, args.seed + 1, is_head)

        fakes, n = [], 0
        for batch in batches:
            fakes.append(translate(batch["source"]))
            n += len(fakes[-1])
            if n >= args.num_images:
                break
        mean, std = inception_score(logits_fn, fakes, device=device)
        out = os.path.join(args.eval_dir, "inception_score.txt")
        with open(out, "w") as f:
            f.write(f"inception_score\t{mean:.6f}\t{std:.6f}\t{n} images\n")
        print(f"inception score: {mean:.4f} +/- {std:.4f} over {n} images"
              + ("" if args.classifier_path else " (random-init logits; relative)"))
        print("written:", out)
        result.update(inception_score=mean, inception_score_std=std, images=n, path=out)

    elif args.mode == "eval_debug":
        batch = next(batches)
        items = {
            "sources": np.asarray(batch["source"], np.float32),
            "targets": np.asarray(batch["target"], np.float32),
            "t_prime": translate(batch["source"]),
        }
        path = write_html_gallery(os.path.join(args.eval_dir, "eval_debug"), items)
        print("written:", path)
        result.update(path=path)

    elif args.mode == "output":
        trainer, state = restore_trainer(inferer, inferer.stage_dir, device)
        enc = state.nets[ENC].eval()
        # A growing stage needs the fade-in alpha of its step, as translate.
        alpha = trainer._alpha(state.step)
        written = 0
        path = os.path.join(args.eval_dir, args.output_single_file_name)
        for batch in batches:
            imgs = torch.as_tensor(np.asarray(batch["source"], np.float32)).to(device)
            with torch.inference_mode():
                code, _ = enc(imgs, alpha=alpha, domain=DOMAIN_S)
            names = [f"img_{written + i}" for i in range(len(imgs))]
            write_embeddings_csv(path, names, code.float().cpu().numpy(), append=written > 0)
            written += len(imgs)
            if written >= args.num_images:
                break
        print(f"wrote {written} embeddings to {path}")
        result.update(path=path, images=written)
    return result


if __name__ == "__main__":
    main()
