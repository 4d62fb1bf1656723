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
- fid, inception_score  need the classifier zoo, which is not ported yet
              (queue item A14), and raise.

Translations go through the port's ``ImageInferer`` (the stage's
``model.pt``); ``loss`` and ``output`` restore the stage's latest
checkpoint into a ``TwinGANTrainer``, as the JAX CLI does.

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
                        "--mode=fid (both wait for the classifier zoo, queue item A14)")
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


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.mode in ("fid", "inception_score"):
        raise NotImplementedError(
            f"--mode={args.mode} needs the classifier zoo (InceptionV3 or a trained "
            "classifier), which is not ported to twingan_tpu_torch yet (queue item A14)")
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
