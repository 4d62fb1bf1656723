"""CLI entry point for progressive-growth training on the port.

Counterpart of ``twingan_tpu/runner/pggan_runner.py``: the same flags with
the same defaults (``build_parser``), the same typed configs built from
them (``config_from_args``), and one more flag, ``--device`` (the card by
default, ``cpu`` on request). Every stage writes its config to
``config.json`` in its stage directory.

Example, tfrecord shards (``data/converters.py``) from 4 to 256 px, with
the in-training SWD every 1000 steps:
    python -m twingan_tpu_torch.runner.pggan_runner \\
        --program_name=image_generation --dataset_dir=/data/faces \\
        --train_dir=/tmp/run --start_hw=4 --max_hw=256 \\
        --generator_norm_type=none --do_pixel_norm=true \\
        --equalized_learning_rate=true --dtype=bfloat16 \\
        --eval_every_n_iter_in_training=1000

Synthetic data:
    python -m twingan_tpu_torch.runner.pggan_runner \\
        --program_name=image_generation --use_synthetic_data=true \\
        --train_dir=/tmp/run --start_hw=4 --max_hw=256 \\
        --generator_norm_type=none --do_pixel_norm=true \\
        --equalized_learning_rate=true --dtype=bfloat16

Data parallel, one process per card (the batch schedule is per card):
    torchrun --nproc_per_node 4 -m twingan_tpu_torch.runner.pggan_runner \\
        --num_devices=4 ...
and on the CPU, two gloo processes:
    torchrun --nproc_per_node 2 -m twingan_tpu_torch.runner.pggan_runner \\
        --device=cpu --use_synthetic_data=true --train_dir=/tmp/run ...
"""

from __future__ import annotations

import argparse

import torch

from twingan_tpu_torch import parallel
from twingan_tpu_torch.data.datasets import get_dataset
from twingan_tpu_torch.models.config import PGGANConfig
from twingan_tpu_torch.parallel import initialize_from_env
from twingan_tpu_torch.runner.stage_runner import RunConfig, StageRunner
from twingan_tpu_torch.train.gan_trainer import GanTrainerConfig
from twingan_tpu_torch.train.losses import GanLossConfig
from twingan_tpu_torch.train.optimizers import OptimizerConfig
from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def _batch_schedule(args):
    """Per-resolution batch sizes: --hw_to_batch_size dict literal (the
    reference pggan_runner.py flag) > flat --batch_size > built-in default
    schedule (None)."""
    if args.hw_to_batch_size:
        import ast

        sched = ast.literal_eval(args.hw_to_batch_size)
        if not isinstance(sched, dict):
            raise ValueError("--hw_to_batch_size must be a dict literal")
        return {int(k): int(v) for k, v in sched.items()}
    if args.batch_size:
        return {r: args.batch_size for r in (4, 8, 16, 32, 64, 128, 256, 512)}
    return None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # Runner flags (reference pggan_runner.py).
    p.add_argument("--program_name", default="twingan", choices=["twingan", "image_generation"])
    p.add_argument("--train_dir", required=True)
    p.add_argument("--start_hw", type=int, default=4)
    p.add_argument("--max_hw", type=int, default=64)
    p.add_argument("--num_images_per_resolution", type=int, default=300000)
    p.add_argument("--batch_size", type=int, default=0, help="override the per-resolution schedule")
    p.add_argument("--hw_to_batch_size", default="",
                   help="per-resolution batch dict, e.g. '{4: 16, 256: 12}' "
                        "(reference pggan_runner.py hw_to_batch_size); "
                        "unlisted resolutions use the largest listed entry")
    # Dataset flags.
    p.add_argument("--dataset_name", default="image_only")
    p.add_argument("--dataset_dir", default="")
    p.add_argument("--dataset_split_name", default="train")
    p.add_argument("--target_dataset_name", default="image_only")
    p.add_argument("--target_dataset_dir", default="")
    p.add_argument("--use_synthetic_data", type=_bool, default=False)
    p.add_argument("--vocab_file", default="",
                   help="label vocabulary for text-tag datasets (one label "
                        "per line); needed for conditional anime_faces/"
                        "danbooru training")
    p.add_argument("--resize_mode", default="PAD")
    p.add_argument("--color_space", default="rgb")
    p.add_argument("--do_random_cropping", type=_bool, default=False)
    p.add_argument("--subtract_mean", type=_bool, default=False,
                   help="keep images on the 0-255 scale minus the RGB "
                        "channel means (vgg19 convention; reference "
                        "model_inheritor.py:243)")
    # Model flags (reference nets/pggan.py).
    p.add_argument("--generator_network", default="pggan",
                   choices=["pggan", "cyclegan", "dcgan"],
                   help="image_generation program only (reference "
                        "image_generation.py:214-227; dcgan is our addition)")
    p.add_argument("--generator_norm_type", default="batch_norm")
    p.add_argument("--pggan_max_num_channels", type=int, default=256)
    p.add_argument("--pggan_max_num_channels_dis", type=int, default=0)
    p.add_argument("--do_pixel_norm", type=_bool, default=False)
    p.add_argument("--equalized_learning_rate", type=_bool, default=False)
    p.add_argument("--spectral_norm", type=_bool, default=False)
    p.add_argument("--spectral_norm_in_non_discriminator", type=_bool, default=False)
    p.add_argument("--use_res_block", type=_bool, default=False)
    p.add_argument("--use_larger_filter_at_rgb_layer", type=_bool, default=False)
    p.add_argument("--do_self_attention", type=_bool, default=False)
    p.add_argument("--self_attention_hw", type=int, default=64)
    p.add_argument("--pggan_unet_max_concat_hw", type=int, default=0)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--fused_scale", type=_bool, default=False,
                   help="fused nearest-up2+conv in the generator (identical "
                        "function, lower HBM traffic; ops/fused_scale.py)")
    p.add_argument("--fused_scale_impl", default="dilated",
                   choices=["dilated", "parity"])
    p.add_argument("--remat", type=_bool, default=False,
                   help="rematerialize each G/D pass in the backward "
                        "(torch.utils.checkpoint): less memory, one more forward")
    # Loss flags (reference image_generation.py).
    p.add_argument("--loss_architecture", default="dragan",
                   choices=["gan", "dragan", "wgan", "wgan_gp", "hinge"])
    p.add_argument("--gan_weight", type=float, default=1.0)
    p.add_argument("--gradient_penalty_lambda", type=float, default=10.0)
    p.add_argument("--wgan_drift_loss_weight", type=float, default=0.0)
    p.add_argument("--n_critic", type=int, default=2)
    p.add_argument("--use_ttur", type=_bool, default=False)
    p.add_argument("--discriminator_learning_rate", type=float, default=0.0004)
    p.add_argument("--use_gdrop", type=_bool, default=False)
    p.add_argument("--gdrop_coef", type=float, default=0.2)
    p.add_argument("--gdrop_lim", type=float, default=0.5)
    p.add_argument("--gdrop_exp", type=float, default=2.0)
    # Conditional generation from dataset labels (reference
    # use_conditional_labels; anime_faces has 51 classes).
    p.add_argument("--use_conditional_labels", type=_bool, default=False)
    p.add_argument("--num_classes", type=int, default=0,
                   help="label vocabulary size (0 = take it from the dataset)")
    p.add_argument("--conditional_embed_dim", type=int, default=32)
    # Optimizer flags (reference model_inheritor.py).
    p.add_argument("--optimizer", default="adam")
    p.add_argument("--learning_rate", type=float, default=0.0001)
    p.add_argument("--adam_beta1", type=float, default=0.5)
    p.add_argument("--adam_beta2", type=float, default=0.99)
    p.add_argument("--opt_epsilon", type=float, default=1e-8)
    p.add_argument("--adadelta_rho", type=float, default=0.95)
    p.add_argument("--adagrad_initial_accumulator_value", type=float, default=0.1)
    p.add_argument("--ftrl_learning_rate_power", type=float, default=-0.5)
    p.add_argument("--ftrl_initial_accumulator_value", type=float, default=0.1)
    p.add_argument("--ftrl_l1", type=float, default=0.0)
    p.add_argument("--ftrl_l2", type=float, default=0.0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--rmsprop_momentum", type=float, default=0.9)
    p.add_argument("--rmsprop_decay", type=float, default=0.9)
    # TwinGAN flags (reference twingan.py).
    p.add_argument("--l_cyc_weight", type=float, default=1.0)
    p.add_argument("--do_l_cyc_gan", type=_bool, default=True)
    p.add_argument("--l_content_weight", type=float, default=0.1)
    p.add_argument("--use_style_embedding", type=_bool, default=False)
    p.add_argument("--style_embed_size", type=int, default=16)
    p.add_argument("--use_unet", type=_bool, default=False)
    p.add_argument("--do_encoder_distillation", type=_bool, default=False)
    p.add_argument("--distillation_weight", type=float, default=1.0)
    p.add_argument("--distillation_start_hw", type=int, default=16)
    p.add_argument("--source_embed_dim", type=int, default=0)
    p.add_argument("--target_embed_dim", type=int, default=0)
    # Cadence flags.
    p.add_argument("--log_every_n_steps", type=int, default=10)
    p.add_argument("--save_every_n_steps", type=int, default=2000)
    p.add_argument("--log_image_every_n_iter", type=int, default=2000)
    p.add_argument("--log_image_n_per_hw", type=int, default=8,
                   help="rows per sample grid / interpolation steps per "
                        "mosaic (reference image_generation.py:131)")
    p.add_argument("--custom_sources_np_path", default="",
                   help="npy of fixed source images shown in every sample "
                        "grid, relative to dataset_dir (reference "
                        "twingan.py:39-41)")
    p.add_argument("--eval_every_n_iter_in_training", type=int, default=0,
                   help="run the in-training SWD eval every N steps "
                        "(reference image_generation.py:139)")
    p.add_argument("--log_histograms_every_n_iter", type=int, default=0)
    p.add_argument("--keep_checkpoints", type=int, default=3)
    p.add_argument("--checkpoint_path", default="",
                   help="warm-start the FIRST stage from this external "
                        "checkpoint dir (reference checkpoint_path flag)")
    p.add_argument("--checkpoint_exclude_scopes", default="",
                   help="comma-separated param path prefixes to drop from "
                        "the warm start (reference flag of the same name)")
    p.add_argument("--max_nan_recoveries", type=int, default=3)
    p.add_argument("--max_stages_per_run", type=int, default=0,
                   help="return after N incomplete stages; the next call "
                        "resumes the plan from disk")
    p.add_argument("--profile_stage_steps", type=int, default=0)
    p.add_argument("--rounds_per_scan", type=int, default=1)
    p.add_argument("--async_probe", type=_bool, default=False,
                   help="pipelined failure detection: defer the per-chunk "
                        "NaN probe by one scan chunk (host never blocks "
                        "between dispatches; flushed before snapshots)")
    p.add_argument("--skip_start_stage", type=_bool, default=False,
                   help="with --checkpoint_path: the plan's first stage IS "
                        "the external checkpoint — grow the next stage from "
                        "it directly instead of retraining (stretch entry)")
    p.add_argument("--device_resident_gb", type=float, default=4.0,
                   help="datasets that materialize under this many GB "
                        "(uint8, post host-resize) are uploaded to HBM once "
                        "and batches drawn as on-device gathers — "
                        "steady-state training transfers only int32 sample "
                        "indices. 0 = always stream from host")
    p.add_argument("--num_devices", type=int, default=0,
                   help="data-parallel world size: the processes torchrun "
                        "starts, one per device (0 = whatever it started); "
                        "the batch schedule is per device")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default: the card, which must exist) or cpu")
    return p


def config_from_args(args: argparse.Namespace) -> RunConfig:
    is_twin = args.program_name == "twingan"
    model = PGGANConfig(
        resolution=args.start_hw,
        max_channels=args.pggan_max_num_channels,
        max_channels_dis=args.pggan_max_num_channels_dis or None,
        norm_type=args.generator_norm_type,
        do_pixel_norm=args.do_pixel_norm,
        equalized_lr=args.equalized_learning_rate,
        spectral_norm=args.spectral_norm,
        spectral_norm_in_non_discriminator=args.spectral_norm_in_non_discriminator,
        use_res_block=args.use_res_block,
        use_larger_filter_at_rgb_layer=args.use_larger_filter_at_rgb_layer,
        do_self_attention=args.do_self_attention,
        self_attention_hw=args.self_attention_hw,
        unet_max_concat_hw=args.pggan_unet_max_concat_hw or None,
        num_domains=2 if is_twin else 1,
        style_dim=args.style_embed_size if (is_twin and args.use_style_embedding) else 0,
        dtype=args.dtype,
        fused_scale=args.fused_scale,
        fused_scale_impl=args.fused_scale_impl,
    )
    loss = GanLossConfig(
        architecture=args.loss_architecture,
        gan_weight=args.gan_weight,
        gradient_penalty_lambda=args.gradient_penalty_lambda,
        wgan_drift_loss_weight=args.wgan_drift_loss_weight,
    )
    opt = OptimizerConfig(
        optimizer=args.optimizer,
        learning_rate=args.learning_rate,
        adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2,
        opt_epsilon=args.opt_epsilon,
        adadelta_rho=args.adadelta_rho,
        adagrad_initial_accumulator_value=args.adagrad_initial_accumulator_value,
        ftrl_learning_rate_power=args.ftrl_learning_rate_power,
        ftrl_initial_accumulator_value=args.ftrl_initial_accumulator_value,
        ftrl_l1=args.ftrl_l1,
        ftrl_l2=args.ftrl_l2,
        momentum=args.momentum,
        rmsprop_momentum=args.rmsprop_momentum,
        rmsprop_decay=args.rmsprop_decay,
    )
    common = dict(
        model=model, loss=loss, opt=opt, n_critic=args.n_critic,
        use_ttur=args.use_ttur, discriminator_learning_rate=args.discriminator_learning_rate,
        use_gdrop=args.use_gdrop, gdrop_coef=args.gdrop_coef,
        gdrop_lim=args.gdrop_lim, gdrop_exp=args.gdrop_exp,
        remat=args.remat,
    )
    if is_twin:
        trainer = TwinGANConfig(
            **common,
            l_cyc_weight=args.l_cyc_weight,
            do_l_cyc_gan=args.do_l_cyc_gan,
            l_content_weight=args.l_content_weight,
            use_style_embedding=args.use_style_embedding,
            style_embed_size=args.style_embed_size,
            use_unet=args.use_unet,
            do_encoder_distillation=args.do_encoder_distillation,
            distillation_weight=args.distillation_weight,
            distillation_start_hw=args.distillation_start_hw,
            source_embed_dim=args.source_embed_dim,
            target_embed_dim=args.target_embed_dim,
        )
    else:
        num_classes = args.num_classes
        if args.use_conditional_labels and not num_classes:
            num_classes = get_dataset(args.dataset_name).num_classes
        trainer = GanTrainerConfig(
            **common,
            generator_network=args.generator_network,
            use_conditional_labels=args.use_conditional_labels,
            num_classes=num_classes or 0,
            conditional_embed_dim=args.conditional_embed_dim,
        )
    return RunConfig(
        program=args.program_name,
        train_dir=args.train_dir,
        start_hw=args.start_hw,
        max_hw=args.max_hw,
        num_images_per_resolution=args.num_images_per_resolution,
        batch_schedule=_batch_schedule(args),
        dataset_name=args.dataset_name,
        dataset_dir=args.dataset_dir,
        dataset_split=args.dataset_split_name,
        target_dataset_name=args.target_dataset_name,
        target_dataset_dir=args.target_dataset_dir,
        use_synthetic_data=args.use_synthetic_data,
        vocab_file=args.vocab_file,
        resize_mode=args.resize_mode,
        color_space=args.color_space,
        do_random_cropping=args.do_random_cropping,
        subtract_mean=args.subtract_mean,
        trainer=trainer,
        log_every_n_steps=args.log_every_n_steps,
        save_every_n_steps=args.save_every_n_steps,
        log_image_every_n_iter=args.log_image_every_n_iter,
        log_image_n_per_hw=args.log_image_n_per_hw,
        custom_sources_np_path=args.custom_sources_np_path,
        eval_every_n_iter_in_training=args.eval_every_n_iter_in_training,
        log_histograms_every_n_iter=args.log_histograms_every_n_iter,
        keep_checkpoints=args.keep_checkpoints,
        checkpoint_path=args.checkpoint_path,
        checkpoint_exclude_scopes=tuple(
            s for s in args.checkpoint_exclude_scopes.split(",") if s),
        max_nan_recoveries=args.max_nan_recoveries,
        max_stages_per_run=args.max_stages_per_run,
        profile_stage_steps=args.profile_stage_steps,
        rounds_per_scan=args.rounds_per_scan,
        device_resident_gb=args.device_resident_gb,
        skip_start_stage=args.skip_start_stage,
        async_probe=args.async_probe,
        num_devices=args.num_devices,
        seed=args.seed,
    )


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    # Several processes: join the group torchrun describes (RANK,
    # WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; NCCL on the card,
    # gloo with --device=cpu); a single process runs as it is.
    if initialize_from_env(args.device):
        print(f"multi-host: process {process_info(args.device)}")
    summary = StageRunner(config_from_args(args), device=args.device).run()
    print("run complete:", summary)
    return summary


def process_info(device) -> str:
    """``rank/world (device)`` of this process."""
    group = parallel.current_group()
    where = (f"cuda:{torch.cuda.current_device()}" if device in (None, "cuda") else str(device))
    return f"{parallel.rank(group)}/{parallel.world_size(group)} ({where})"


if __name__ == "__main__":
    main()
