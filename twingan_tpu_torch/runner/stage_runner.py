"""Progressive-growth stage runner.

Counterpart of ``twingan_tpu/runner/stage_runner.py``:
- the stage plan: resolutions start_hw..max_hw doubling, a growing stage
  before the stable one at each new resolution; stage dirs ``4``,
  ``4to8``, ``8``, ...;
- the per-resolution batch schedules and steps per stage
  (``num_images_per_resolution`` / batch);
- a stage whose checkpoint reached its steps is skipped; a stage with a
  checkpoint resumes from it; otherwise it warm-starts from the last stage
  (or ``checkpoint_path``) by growth migration (``runner/migrate.py``);
- per stage: ``config.json`` in the JAX schema, ``ckpt-<step>`` train-state
  checkpoints on the save cadence and at the end (where the cadence has
  not just written the last step: the JAX runner writes it again),
  ``model.pt`` (the serving unit) beside the final one,
  ``logs/metrics.jsonl``.

Each stage builds a new trainer at its resolution and drives it with the
same loop as the JAX runner: augmented batches (synthetic, or real data
from tfrecord shards: held on the device by a ``DeviceResidentSampler``
when the stage's dataset fits ``device_resident_gb``, else streamed by a
``DevicePrefetcher``; ``UnpairedSource`` for TwinGAN's two domains),
``round_step``
(or ``scan_rounds`` over stacked batches with ``rounds_per_scan > 1``),
cadences that fire when the step crosses a multiple of their period, NaN
recovery from the last checkpoint with a budget, the optional deferred
probe (``async_probe``), the transfer bound, and a ``torch.profiler``
trace, and the in-training SWD (``eval_every_n_iter_in_training``: the
stage's first augmented batch against the model's samples or
translations of it, ``swd_in_training_<step>.txt``; a failure is printed
and never stops training). The round's seed is ``seed + 17``, the
augmentation's ``seed + 13``.

The stage summary adds the split of a stage's time: ``build_s`` (trainer
and fresh state), ``restore_s`` (resume or migration), ``data_s`` (the
data source: a device-resident dataset decoded, resized and copied to
the device; a streaming one only started, its decoding then runs beside
the rounds), ``rounds_s`` and ``saves_s`` (checkpoints and ``model.pt``,
``saves`` of them); the NaN
recoveries it took; and ``started``, where its state came from (the
migration report's counts, or the step it resumed at).

The generation program's ``generator_network`` (pggan, cyclegan, dcgan)
reaches ``GanTrainer``: a CycleGAN or DCGAN trains one fixed-resolution
stage (``start_hw == max_hw``). DCGAN's sample grids and in-training SWD
draw [B, dcgan_latent_dim] latents (seeds 314 and 9, as for PGGAN's
noise); CycleGAN's synthetic batches carry a source image, which its
grids and SWD translate as a paired PGGAN's.

Every trainer option of both programs reaches the trainers: the style
embedding (with a style-interpolation grid in the sample dumps,
``<step>_custom_t_style_roll.png``), distillation (the batches'
``source_embedding``/``target_embedding``), conditional labels (the
sample grids and the in-training SWD under the fixed batch's labels),
gdrop (its strength among the logged metrics) and remat.

Several devices: one runner per process of a ``torch.distributed`` group
(``pggan_runner`` joins the group torchrun describes; ``num_devices``,
when set, must be its size). The batch schedule is per device, so the
global batch is the entry times the processes; every process runs the
same seeded source and augmentation at the global batch and keeps its
rows, batch norm takes one group per device unless ``bn_num_groups`` says
otherwise, and the trainers all-reduce the gradients and the metrics.
Only the first process (``is_coordinator``) writes checkpoints,
``config.json``, ``model.pt``, summaries, sample grids and histograms,
and the others wait for it at a barrier after each write, at a NaN
recovery and at the stage's end. The coordinator's sample grids run
without the group (``parallel.local_only``). The fixed batch of the
grids and the in-training SWD is a single process's, so several
processes skip that SWD (with the JAX runner's message) and draw the
grids' sources at random; they never hold the dataset on the device.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from twingan_tpu_torch import parallel
from twingan_tpu_torch.data.datasets import get_dataset
from twingan_tpu_torch.data.pipeline import (
    DevicePrefetcher,
    DeviceResidentSampler,
    SyntheticSource,
    TFRecordSource,
    UnpairedSource,
)
from twingan_tpu_torch.data.preprocess import (
    PreprocessConfig,
    augment_batch,
    draw_augmentation,
    postprocess_image,
    resize_bilinear,
)
from twingan_tpu_torch.data.tfrecord import list_shards
from twingan_tpu_torch.evals.metrics import swd_eval
from twingan_tpu_torch.models.pggan import noise_shape
from twingan_tpu_torch.runner.checkpoint import (
    CheckpointManager,
    save_config_snapshot,
    save_model,
)
from twingan_tpu_torch.runner.migrate import migrate_state_dict
from twingan_tpu_torch.train import gan_trainer
from twingan_tpu_torch.train.base import resolve_device
from twingan_tpu_torch.train.gan_trainer import GanTrainer, GanTrainerConfig
from twingan_tpu_torch.train.state import serving_state_dict, state_from_dict, state_to_dict
from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig, TwinGANTrainer
from twingan_tpu_torch.utils.image_io import save_image_grid, stack_comparison
from twingan_tpu_torch.utils.summary import SummaryWriter

# The batch items the trainers consume, and the images among them.
BATCH_KEYS = ("source", "target", "source_embedding", "target_embedding", "conditional_labels")
IMAGE_KEYS = ("source", "target")
PGGAN_BATCH_SCHEDULE = {4: 16, 8: 16, 16: 16, 32: 16, 64: 12, 128: 12, 256: 12, 512: 6}
TWINGAN_BATCH_SCHEDULE = {4: 8, 8: 8, 16: 8, 32: 8, 64: 8, 128: 4, 256: 3, 512: 2}


def stage_plan(start_hw: int, max_hw: int) -> list[tuple[int, bool]]:
    """[(resolution, is_growing)]: growing first at each new resolution,
    no growing stage at start_hw."""
    plan = []
    res = start_hw
    while res <= max_hw:
        if res != start_hw:
            plan.append((res, True))
        plan.append((res, False))
        res *= 2
    return plan


def stage_dir_name(res: int, growing: bool) -> str:
    return f"{res // 2}to{res}" if growing else str(res)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The JAX ``RunConfig`` field for field (same names, order and
    defaults), so a JAX stage's ``config.json`` loads."""
    program: str = "twingan"                 # twingan | image_generation
    train_dir: str = "/tmp/twingan_tpu_train"
    start_hw: int = 4
    max_hw: int = 64
    num_images_per_resolution: int = 300000
    num_images_schedule: Optional[dict] = None   # res -> images override
    batch_schedule: Optional[dict] = None        # res -> batch size override
    dataset_name: str = "image_only"
    dataset_dir: str = ""
    dataset_split: str = "train"
    target_dataset_name: str = "image_only"
    target_dataset_dir: str = ""
    use_synthetic_data: bool = False
    vocab_file: str = ""
    resize_mode: str = "PAD"
    color_space: str = "rgb"
    do_random_cropping: bool = False
    subtract_mean: bool = False
    trainer: Any = None
    log_every_n_steps: int = 10
    save_every_n_steps: int = 2000
    log_image_every_n_iter: int = 2000
    log_image_n_per_hw: int = 8
    custom_sources_np_path: str = ""
    eval_every_n_iter_in_training: int = 0
    log_histograms_every_n_iter: int = 0
    keep_checkpoints: int = 3
    profile_stage_steps: int = 0
    rounds_per_scan: int = 1
    checkpoint_path: str = ""
    checkpoint_exclude_scopes: tuple = ()
    max_nan_recoveries: int = 3
    num_devices: int = 0
    seed: int = 0
    max_stages_per_run: int = 0
    max_transfer_gb_per_run: float = 0.0
    device_resident_gb: float = 4.0
    skip_start_stage: bool = False
    async_probe: bool = False

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def run_group():
    """The process group a run spans: the registered one, else the default
    group where one is initialized, else None."""
    group = parallel.current_group()
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    return group


def augment_rows(x: torch.Tensor, global_shape, cfg: PreprocessConfig,
                 generator: torch.Generator, parts: int = 1, group=None) -> torch.Tensor:
    """``x``, this process's rows of images of ``global_shape`` (``parts``
    global batches end to end), augmented with its rows of the draws made
    for all of them (``parallel.local_rows``; a shared draw, a 0-dim flip
    or the colour ordering, stays whole): every process draws what one
    process draws for the whole batch, and augments only its own rows."""
    draws = draw_augmentation(cfg, tuple(global_shape), generator)

    def rows(t):
        return t if t is None or t.dim() == 0 else parallel.local_rows(t, parts, group)

    draws = dataclasses.replace(draws, crop_y=rows(draws.crop_y), crop_x=rows(draws.crop_x),
                                flip=rows(draws.flip),
                                color=tuple(rows(f) for f in draws.color))
    return augment_batch(x, cfg, draws=draws)


def require_ported_run(cfg: RunConfig) -> None:
    """Raise ``ValueError`` where ``num_devices`` is not the run's process
    count (``run_group``; 0 takes it): the port runs one process per
    device, which torchrun starts."""
    processes = parallel.world_size(run_group())
    if cfg.num_devices and cfg.num_devices != processes:
        raise ValueError(
            f"num_devices={cfg.num_devices} but the run has {processes} process(es): the "
            "port runs one process per device; start them with torchrun --nproc_per_node "
            f"{cfg.num_devices} -m twingan_tpu_torch.runner.pggan_runner ...")


class _NullWriter:
    """The summary sink of the processes other than the coordinator."""

    def scalars(self, step, values) -> None:
        pass

    def histograms(self, step, values) -> None:
        pass

    def close(self) -> None:
        pass


class StageRunner:
    """Runs the stage plan of ``cfg`` on the CUDA card unless ``device`` says
    otherwise (``device="cpu"``), as one process of the run's process
    group when there is one (``run_group``)."""

    def __init__(self, cfg: RunConfig, device: Optional[str | torch.device] = None):
        require_ported_run(cfg)
        if cfg.trainer is None:
            trainer = TwinGANConfig() if cfg.program == "twingan" else GanTrainerConfig()
            cfg = cfg.replace(trainer=trainer)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.metrics_log: list = []
        # The group the attention layers and the trainers look up.
        self.group = run_group()
        parallel.set_current_group(self.group)
        self.n_devices = parallel.world_size(self.group)

    @property
    def is_coordinator(self) -> bool:
        """Only the first process writes checkpoints, summaries and samples:
        every process holds the same replicated state."""
        return parallel.rank(self.group) == 0

    def _barrier(self) -> None:
        """Every process waits here, so none reads what another still
        writes."""
        parallel.barrier(self.group)

    def batch_size(self, res: int) -> int:
        """The global batch: the per-device schedule entry times the
        processes."""
        sched = self.cfg.batch_schedule or (
            TWINGAN_BATCH_SCHEDULE if self.cfg.program == "twingan" else PGGAN_BATCH_SCHEDULE)
        return (sched.get(res) or sched[max(sched)]) * self.n_devices

    def steps_for_stage(self, res: int) -> int:
        images = self.cfg.num_images_per_resolution
        if self.cfg.num_images_schedule:
            images = self.cfg.num_images_schedule.get(res, images)
        return max(1, images // self.batch_size(res))

    def _build_trainer(self, res: int, growing: bool, steps: int):
        model = self.cfg.trainer.model.replace(resolution=res, is_growing=growing)
        if self.n_devices > 1 and model.bn_num_groups == 0:
            # Batch norm's moments per device, as the reference's clones
            # take them.
            model = model.replace(bn_num_groups=self.n_devices)
        tcfg = self.cfg.trainer.replace(model=model, batch_size=self.batch_size(res),
                                        max_steps=steps, grow_start_step=0)
        if self.cfg.program == "twingan":
            return TwinGANTrainer(tcfg, device=self.device), tcfg
        return GanTrainer(tcfg, device=self.device), tcfg

    def _preprocess_cfg(self, res: int) -> PreprocessConfig:
        return PreprocessConfig(
            output_hw=res, resize_mode=self.cfg.resize_mode, color_space=self.cfg.color_space,
            do_random_cropping=self.cfg.do_random_cropping,
            subtract_mean=self.cfg.subtract_mean, is_training=True)

    def _build_sources(self, res: int, batch: int):
        """The real-data TFRecordSource pair ((a, b); b is None for
        single-dataset programs), yielding uint8 images."""
        cfg = self.cfg
        needs_pair = cfg.program == "twingan"
        pp = self._preprocess_cfg(res)
        # The trainer's label space sizes the dataset's one-hots.
        num_classes = int(getattr(cfg.trainer, "num_classes", 0) or 0)
        a = TFRecordSource(
            # Single-dataset generation: the images are the real-data
            # distribution ('target') and the generator input stays noise.
            get_dataset(cfg.dataset_name, num_classes=num_classes,
                        vocab_file=cfg.vocab_file or None, use_target=not needs_pair),
            list_shards(cfg.dataset_dir, cfg.dataset_split),
            pp, batch, seed=cfg.seed, yield_uint8=True,
        )
        b = None
        if needs_pair:
            b = TFRecordSource(
                get_dataset(cfg.target_dataset_name, use_target=False),
                list_shards(cfg.target_dataset_dir or cfg.dataset_dir, cfg.dataset_split),
                pp, batch, seed=cfg.seed + 1, yield_uint8=True,
            )
        return a, b

    def _build_resident(self, res: int, batch: int) -> Optional[DeviceResidentSampler]:
        """A DeviceResidentSampler over the stage's datasets, or None where
        the resident path does not apply (budget 0, synthetic data, random
        host resize, ragged, oversized or undecodable datasets): the caller
        then streams."""
        cfg = self.cfg
        if (not cfg.device_resident_gb or cfg.use_synthetic_data or not cfg.dataset_dir
                or self.n_devices > 1):
            return None
        budget = int(cfg.device_resident_gb * (1 << 30))
        a, b = self._build_sources(res, batch)
        arrs_a = a.materialize(budget)
        if arrs_a is None:
            return None
        img_a = next((k for k in ("source", "target", "image") if k in arrs_a), None)
        if img_a is None:
            return None
        if b is not None:
            used = sum(v.nbytes for v in arrs_a.values())
            arrs_b = b.materialize(max(budget - used, 1))
            if arrs_b is None:
                return None
            img_b = next((k for k in ("source", "target", "image") if k in arrs_b), None)
            if img_b is None:
                return None
            # UnpairedSource's key map: a_* -> the source side, b_* -> target.
            domains = [
                (arrs_a, {"source": img_a, "source_embedding": "embedding",
                          "conditional_labels": "conditional_labels"}, cfg.seed),
                (arrs_b, {"target": img_b, "target_embedding": "embedding"}, cfg.seed + 1),
            ]
        else:
            domains = [(arrs_a, {"target": img_a, "conditional_labels": "conditional_labels"},
                        cfg.seed)]
        try:
            sampler = DeviceResidentSampler(domains, batch, self.device)
        except ValueError:
            return None
        print(f"[data {res}px] device-resident: {sampler.resident_bytes / 1e6:.1f} MB "
              "copied once; a round moves its sample indices only")
        return sampler

    def _build_data(self, res: int, batch: int, to_device: bool = True):
        """(iterator over batches, close function). Synthetic batches are
        host arrays; real ones come through a DevicePrefetcher, as device
        tensors, or as host arrays with ``to_device=False`` (the caller
        stacks a scan chunk's batches into one copy)."""
        cfg = self.cfg
        needs_pair = cfg.program == "twingan"
        if cfg.use_synthetic_data or not cfg.dataset_dir:
            # CycleGAN translates a source image: synthetic data gives it
            # one, as a paired dataset does.
            paired = getattr(cfg.trainer, "generator_network", "pggan") == "cyclegan"
            keys = ("source", "target") if needs_pair or paired else ("target",)
            num_classes = 0
            if getattr(cfg.trainer, "use_conditional_labels", False):
                keys = keys + ("conditional_labels",)
                num_classes = cfg.trainer.num_classes
            src = SyntheticSource(batch, self._preprocess_cfg(res).host_hw, seed=cfg.seed,
                                  keys=keys, num_classes=num_classes)
            return iter(src), lambda: None
        a, b = self._build_sources(res, batch)
        if needs_pair:
            pf = DevicePrefetcher(
                UnpairedSource(a, b), depth=2, device=self.device, to_device=to_device,
                # Only what the trainer consumes, not the a_*/b_* duplicates.
                keys=("source", "target", "source_embedding", "target_embedding",
                      "conditional_labels"))
            return iter(pf), pf.close

        def to_target(it):
            for item in it:
                item = dict(item)
                if item.get("target") is None and item.get("source") is not None:
                    item["target"] = item["source"]
                yield item

        pf = DevicePrefetcher(to_target(iter(a)), depth=2, device=self.device,
                              to_device=to_device)
        return iter(pf), pf.close

    @staticmethod
    def _serving_state_dict(trainer, state) -> dict:
        """``model.pt``'s content: the translator (TwinGAN) or the generator,
        with the Polyak average where it is kept."""
        flat = state_to_dict(state)
        if isinstance(trainer, TwinGANTrainer):
            return serving_state_dict(flat, trainer.translator_keys)
        return serving_state_dict(flat, (gan_trainer.GEN,), ema_net=gan_trainer.GEN)

    # ------------------------------------------------------------------ #
    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        os.makedirs(cfg.train_dir, exist_ok=True)
        prev_stage_dir: Optional[str] = None
        summary: Dict[str, Any] = {}
        executed = 0
        for i, (res, growing) in enumerate(stage_plan(cfg.start_hw, cfg.max_hw)):
            tag = stage_dir_name(res, growing)
            if i == 0 and cfg.skip_start_stage and cfg.checkpoint_path:
                # The external checkpoint is the plan's first stage: the next
                # stage grows from it directly.
                print(f"[stage {tag}] supplied by --checkpoint_path {cfg.checkpoint_path}; "
                      "skipping")
                prev_stage_dir = cfg.checkpoint_path
                summary[tag] = {"skipped": True, "external": cfg.checkpoint_path}
                continue
            stage_dir = os.path.join(cfg.train_dir, tag)
            steps = self.steps_for_stage(res)
            cm = CheckpointManager(stage_dir)
            latest = cm.latest_step()
            if latest is not None and latest >= steps:
                print(f"[stage {tag}] complete at step {latest}; skipping")
                prev_stage_dir = stage_dir
                summary[tag] = {"skipped": True, "step": latest}
                continue
            if cfg.max_stages_per_run and executed >= cfg.max_stages_per_run:
                summary["_incomplete"] = True
                return summary
            info = self._run_stage(res, growing, steps, stage_dir, prev_stage_dir, cm)
            if self.device.type == "cuda":
                torch.cuda.empty_cache()  # the last stage's state is gone
            summary[tag] = info
            if info.get("partial"):
                summary["_incomplete"] = True
                return summary
            prev_stage_dir = stage_dir
            executed += 1
        return summary

    def _run_stage(self, res: int, growing: bool, steps: int, stage_dir: str,
                   prev_stage_dir: Optional[str], cm: CheckpointManager) -> Dict[str, Any]:
        cfg = self.cfg
        tag = stage_dir_name(res, growing)
        t_build = time.perf_counter()
        trainer, tcfg = self._build_trainer(res, growing, steps)
        if self.is_coordinator:
            save_config_snapshot(stage_dir, {"run": cfg.replace(trainer=None), "trainer": tcfg})
        state = trainer.init_state(cfg.seed)
        writer = (SummaryWriter(os.path.join(stage_dir, "logs")) if self.is_coordinator
                  else _NullWriter())
        if self.n_devices > 1:
            print(f"[stage {tag}] data parallel over {self.n_devices} processes, global "
                  f"batch {tcfg.batch_size}")
        t_restore = time.perf_counter()

        start_step = 0
        started = {"from": None}  # where the stage's state came from
        latest = cm.latest_step()
        if latest is not None:
            state = cm.restore(state, latest)
            start_step = state.step
            started = {"from": stage_dir, "resumed_at": start_step}
            print(f"[stage {tag}] resumed at step {start_step}")
        elif prev_stage_dir is not None or cfg.checkpoint_path:
            source = prev_stage_dir or cfg.checkpoint_path
            raw = CheckpointManager(source).restore_dict()
            if raw is not None:
                migrated, report = migrate_state_dict(
                    state_to_dict(state), raw,
                    exclude_scopes=(tuple(cfg.checkpoint_exclude_scopes)
                                    if prev_stage_dir is None else ()))
                state = state_from_dict(state, migrated)
                del raw, migrated
                started = {"from": source, **{k: len(v) for k, v in report.items()}}
                print(f"[stage {tag}] warm start from {source}: "
                      f"{len(report['carried'])} carried, {len(report['fresh'])} fresh, "
                      f"{len(report['shape_mismatch'])} shape-mismatched")
        state = parallel.replicate(state, self.group)
        t_start = time.perf_counter()
        times = {"build_s": t_restore - t_build, "restore_s": t_start - t_restore,
                 "saves_s": 0.0, "saves": 0}
        last_saved = {"step": None}

        def save(step: int, st) -> None:
            t0 = time.perf_counter()
            cm.save(step, st, keep=cfg.keep_checkpoints)
            times["saves_s"] += time.perf_counter() - t0
            times["saves"] += 1
            last_saved["step"] = step

        t_data = time.perf_counter()
        resident = self._build_resident(res, trainer.cfg.batch_size)
        if resident is not None:
            data_iter, close_data = None, (lambda: None)
        else:
            # Under a group the host arrays come as they are, so that each
            # process copies only its rows.
            data_iter, close_data = self._build_data(
                res, trainer.cfg.batch_size,
                to_device=cfg.rounds_per_scan <= 1 and self.n_devices == 1)
        times["data_s"] = time.perf_counter() - t_data
        pp = self._preprocess_cfg(res)
        aug_gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 13)
        rng = cfg.seed + 17
        n_critic = trainer.cfg.n_critic
        # The fixed batch of the sample grids and the in-training SWD is a
        # single process's (each process holds only its rows of a batch).
        want_fixed = (bool(cfg.log_image_every_n_iter or cfg.eval_every_n_iter_in_training)
                      and self.n_devices == 1)
        fixed_batch: Dict[str, np.ndarray] = {}
        # Bytes this stage copied to the device for its batches: images, or
        # only sample indices on the device-resident path.
        staged = {"bytes": 0}

        def put(x) -> torch.Tensor:
            if isinstance(x, torch.Tensor):  # staged by the prefetcher or resident
                if resident is None:
                    staged["bytes"] += x.nbytes
                return x.to(self.device)
            staged["bytes"] += x.nbytes
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        def prepare(raw) -> Dict[str, torch.Tensor]:
            # sorted: the draw order must not depend on dict order. Each
            # process copies and augments only its rows of the global batch.
            keys = [k for k in sorted(raw) if k in BATCH_KEYS]
            local = parallel.shard_batch({k: raw[k] for k in keys}, self.group)
            return {k: (augment_rows(put(local[k]), raw[k].shape, pp, aug_gen, group=self.group)
                        if k in IMAGE_KEYS else put(local[k])) for k in keys}

        def next_batches():
            if resident is not None:
                raws = resident.sample_batches(n_critic)
                staged["bytes"] += resident.last_index_bytes
            else:
                raws = [next(data_iter) for _ in range(n_critic)]
            batches = [prepare(raw) for raw in raws]
            if want_fixed and not fixed_batch:
                fixed_batch.update({k: v.float().cpu().numpy() for k, v in batches[0].items()})
            return batches

        def scan_chunk(state, n_rounds):
            """n_rounds rounds through ``scan_rounds``: every batch of the
            chunk stacked ([R, n_critic, B, ...]), staged and augmented at
            once per key."""
            if resident is not None:
                stacked_raw = resident.sample_chunk(n_rounds, n_critic)
                staged["bytes"] += resident.last_index_bytes
            else:
                raw = [[next(data_iter) for _ in range(n_critic)] for _ in range(n_rounds)]
                stacked_raw = {k: np.stack([np.stack([np.asarray(raw[r][c][k])
                                                      for c in range(n_critic)])
                                            for r in range(n_rounds)])
                               for k in sorted(raw[0][0]) if k in BATCH_KEYS}
            stacked = {}
            for k in sorted(stacked_raw):
                # Each process copies and augments only its rows of each batch.
                full = stacked_raw[k]
                x = put(full[:, :, parallel.local_batch_slice(full.shape[2], self.group)])
                if k in IMAGE_KEYS:
                    parts = full.shape[0] * full.shape[1]
                    flat = augment_rows(x.reshape((-1,) + x.shape[3:]),
                                        (parts * full.shape[2],) + full.shape[3:], pp, aug_gen,
                                        parts, self.group)
                    x = flat.reshape(x.shape[:3] + flat.shape[1:])
                stacked[k] = x
            if want_fixed and not fixed_batch:
                fixed_batch.update({k: v[0, 0].float().cpu().numpy() for k, v in stacked.items()})
            state, metrics = trainer.scan_rounds(state, stacked, rng)
            return state, {k: v[-1] for k, v in metrics.items()}

        last_log = time.perf_counter()
        last_log_step = start_step
        nan_recoveries = 0
        profiler = None
        profiled = False
        cadence_idx: dict = {}
        paused = False
        pending_probe = None

        def nonfinite(m) -> bool:
            probe = float(m.get("generator_loss", 0.0)) + float(m.get("discriminator_loss", 0.0))
            return not np.isfinite(probe)

        def recover_from_nan(at_step: int):
            """Restore the last checkpoint into a fresh state (raises once the
            budget is spent)."""
            nonlocal nan_recoveries
            nan_recoveries += 1
            if nan_recoveries > cfg.max_nan_recoveries:
                raise FloatingPointError(
                    f"[stage {tag}] non-finite loss at step {at_step}; recovery budget exhausted")
            self._barrier()
            fresh = trainer.init_state(cfg.seed + nan_recoveries)
            restored = cm.restore(fresh)
            st = parallel.replicate(restored if restored is not None else fresh, self.group)
            print(f"[stage {tag}] non-finite loss; restored checkpoint at step {st.step} "
                  f"(recovery {nan_recoveries}/{cfg.max_nan_recoveries})")
            return st, st.step

        try:
            step = start_step
            while step < steps:
                if (cfg.profile_stage_steps and not profiled and profiler is None
                        and self.is_coordinator
                        and step >= start_step + 2):  # past the first rounds' warm-up
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if self.device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                if cfg.rounds_per_scan > 1 and min(cfg.rounds_per_scan,
                                                   steps - step) == cfg.rounds_per_scan:
                    state, metrics = scan_chunk(state, cfg.rounds_per_scan)
                    step += cfg.rounds_per_scan
                else:
                    state, metrics = trainer.round_step(state, next_batches(), rng)
                    step += 1
                if profiler is not None and step >= start_step + 2 + cfg.profile_stage_steps:
                    self._stop_profiler(profiler, stage_dir)
                    profiler, profiled = None, True
                if cfg.async_probe:
                    cur = step
                    to_check, pending_probe = pending_probe, (cur, metrics)
                else:
                    cur = state.step
                    to_check = (cur, metrics)
                if to_check is not None and cfg.max_nan_recoveries > 0 and nonfinite(to_check[1]):
                    state = None  # free it before the fresh one is built
                    state, step = recover_from_nan(to_check[0])
                    pending_probe = None
                    continue

                # A cadence fires when cur crosses a multiple of its period:
                # scan strides that do not divide the period still fire.
                def due(every: int, attr: str) -> bool:
                    if not every:
                        return False
                    idx = cur // every
                    if idx > cadence_idx.get(attr, start_step // every):
                        cadence_idx[attr] = idx
                        return True
                    return False

                def would_fire(every: int, attr: str) -> bool:
                    return bool(every) and (cur // every) > cadence_idx.get(
                        attr, start_step // every)

                if cfg.async_probe and pending_probe is not None and (
                        cur >= steps
                        or would_fire(cfg.save_every_n_steps, "save")
                        or would_fire(cfg.log_image_every_n_iter, "image")
                        or would_fire(cfg.eval_every_n_iter_in_training, "swd_train")
                        or would_fire(cfg.log_histograms_every_n_iter, "hist")):
                    # The deferred probe runs before anything snapshots state:
                    # a non-finite state is never persisted.
                    chk_step, chk_m = pending_probe
                    pending_probe = None
                    if cfg.max_nan_recoveries > 0 and nonfinite(chk_m):
                        state = None
                        state, step = recover_from_nan(chk_step)
                        continue

                if due(cfg.log_every_n_steps, "log") or cur >= steps:
                    g = float(metrics.get("generator_loss", np.nan))
                    d = float(metrics.get("discriminator_loss", np.nan))
                    now = time.perf_counter()
                    rate = (cur - last_log_step) / max(now - last_log, 1e-9)
                    last_log_step, last_log = cur, now
                    rec = {"stage": tag, "step": cur, "g_loss": g, "d_loss": d,
                           "rounds_per_sec": round(rate, 3)}
                    if trainer.cfg.use_gdrop:
                        rec["gdrop_strength"] = float(metrics["gdrop_strength"])
                    self.metrics_log.append(rec)
                    writer.scalars(cur, {k: v for k, v in metrics.items() if np.ndim(v) == 0})
                    writer.scalars(cur, {"rounds_per_sec": rate})
                    print(f"[stage {tag}] step {cur}/{steps} g={g:.4f} d={d:.4f} "
                          f"{rate:.2f} rounds/s")
                if due(cfg.save_every_n_steps, "save"):
                    save(cur, state)
                # The coordinator's own work, on its own: no collective.
                with parallel.local_only():
                    if due(cfg.log_image_every_n_iter, "image") and self.is_coordinator:
                        self._dump_samples(trainer, state, stage_dir, cur, fixed_batch)
                    if (due(cfg.eval_every_n_iter_in_training, "swd_train")
                            and self.is_coordinator):
                        self._in_training_swd(trainer, state, stage_dir, cur, fixed_batch,
                                              writer)
                    if due(cfg.log_histograms_every_n_iter, "hist") and self.is_coordinator:
                        writer.histograms(cur, {k[len("params/"):]: v.float().cpu().numpy()
                                                for k, v in state_to_dict(state).items()
                                                if k.startswith("params/")})
                if (cfg.max_transfer_gb_per_run
                        and staged["bytes"] >= cfg.max_transfer_gb_per_run * 1e9
                        and cur < steps):
                    paused = True
                    print(f"[stage {tag}] pausing at step {cur} after staging "
                          f"{staged['bytes'] / 1e9:.1f} GB; re-run to resume")
                    break
            if (pending_probe is not None and cfg.max_nan_recoveries > 0
                    and nonfinite(pending_probe[1])):
                # A pause with an unchecked chunk: roll back rather than
                # persist a non-finite state.
                state = None
                state, step = recover_from_nan(pending_probe[0])
            if last_saved["step"] != state.step:  # the cadence may have just written it
                save(state.step, state)
            if not paused:
                t0 = time.perf_counter()
                if self.is_coordinator:
                    save_model(stage_dir, self._serving_state_dict(trainer, state), state.step)
                times["saves_s"] += time.perf_counter() - t0
                times["saves"] += 1
            self._barrier()  # the stage's files are whole for every process
        finally:
            if profiler is not None:
                self._stop_profiler(profiler, stage_dir)
            close_data()
            writer.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        done = state.step - start_step
        info = {"steps": state.step, "wall_time_sec": round(wall, 1),
                "rounds_per_sec": round(done / max(wall, 1e-9), 3),
                "rounds_s": wall - times["saves_s"] - times["data_s"], **times,
                "nan_recoveries": nan_recoveries, "started": started}
        if paused:
            info["partial"] = True
        return info

    @staticmethod
    def _stop_profiler(profiler, stage_dir: str) -> None:
        profiler.stop()
        out = os.path.join(stage_dir, "profile")
        os.makedirs(out, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(out, "trace.json"))

    # ------------------------------------------------------------------ #
    def _display(self, x) -> np.ndarray:
        """Training-space batch -> [0,1] RGB display space."""
        return postprocess_image(torch.as_tensor(np.asarray(x, np.float32)),
                                 self.cfg.color_space,
                                 subtract_mean=self.cfg.subtract_mean).numpy()

    def _in_training_swd(self, trainer, state, stage_dir: str, step: int, fixed_batch,
                         writer) -> None:
        """The in-training SWD: the stage's fixed batch (its first augmented
        batch) as the reals against the model's generations or s2t
        translations of it, the table in ``swd_in_training_<step>.txt`` and
        the levels' means logged. A failure is printed and never stops
        training."""
        try:
            real = (fixed_batch or {}).get("target")
            if real is None:
                if self.n_devices > 1 and not getattr(self, "_warned_swd_multihost", False):
                    # The fixed batch is a single process's: say so once.
                    print("[in-training swd skipped on multi-host: run "
                          "evals.run_eval against checkpoints instead]")
                    self._warned_swd_multihost = True
                return
            real = np.asarray(real, np.float32)
            if real.shape[1] < 16:
                return  # reference: 'Not doing swd on small images.'
            if isinstance(trainer, TwinGANTrainer):
                src = fixed_batch.get("source")
                if src is None:
                    return
                fake = trainer.translate(state, torch.from_numpy(np.asarray(src, np.float32)),
                                         "s2t")
            elif trainer.cfg.generator_network == "dcgan":
                # DCGAN takes [B, dcgan_latent_dim] latents, never an image.
                rng = np.random.RandomState(9)
                z = rng.standard_normal((len(real), trainer.cfg.dcgan_latent_dim))
                fake = trainer.sample(state, torch.from_numpy(z.astype(np.float32)))
            else:
                src = fixed_batch.get("source")
                if src is not None:
                    inp = np.asarray(src, np.float32)
                else:
                    rng = np.random.RandomState(9)
                    inp = rng.standard_normal(
                        noise_shape(trainer.cfg.model, len(real))).astype(np.float32)
                labels = fixed_batch.get("conditional_labels")
                if labels is not None:
                    labels = torch.from_numpy(np.asarray(labels)[:len(inp)])
                fake = trainer.sample(state, torch.from_numpy(inp), labels=labels)
            fake = fake.float().cpu().numpy()
            out = os.path.join(stage_dir, f"swd_in_training_{step}.txt")
            # Display space, so scores compare across colour spaces.
            table = swd_eval(step, [self._display(real)], [self._display(fake)],
                             num_images=min(len(real), len(fake)), save_path=out,
                             device=self.device)
            if table:
                vals = list(table.values())
                writer.scalars(step, {"swd_real": float(np.mean([v[0] for v in vals])),
                                      "swd_fake": float(np.mean([v[1] for v in vals]))})
        except Exception as e:  # eval must never kill training
            print(f"[in-training swd failed: {e}]")

    def _fixed_custom_sources(self, res: int, n: int):
        """The ``custom_sources_np_path`` npy at this stage's resolution in
        [0, 1] RGB (resolved against dataset_dir when relative), cached."""
        path = self.cfg.custom_sources_np_path
        if not path:
            return None
        if not os.path.isabs(path):
            path = os.path.join(self.cfg.dataset_dir, path)
        cache_key = (path, res)
        cached = getattr(self, "_custom_sources_cache", None)
        if cached and cached[0] == cache_key:
            return cached[1][:n]
        try:
            arr = np.load(path)
        except Exception as e:
            print(f"[custom sources unavailable ({e}); using data batch]")
            return None
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 2:
            arr = arr[None, ..., None]
        elif arr.ndim == 3:
            arr = arr[None] if arr.shape[-1] in (1, 3, 4) else arr[..., None]
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        elif arr.shape[-1] == 4:
            arr = arr[..., :3]
        if arr.shape[1:3] != (res, res):
            arr = resize_bilinear(torch.from_numpy(np.ascontiguousarray(arr)), res).numpy()
        self._custom_sources_cache = (cache_key, arr)
        return arr[:n]

    def _dump_samples(self, trainer, state, stage_dir: str, step: int,
                      fixed_batch=None) -> None:
        """Sample grids of the fixed batch: TwinGAN translations both ways
        (and of the custom sources), a PGGAN noise interpolation, or a
        DCGAN latent interpolation. A
        failure is printed and never stops training."""
        try:
            out_dir = os.path.join(stage_dir, "generated_samples")
            fixed_batch = fixed_batch or {}
            n_show = max(2, self.cfg.log_image_n_per_hw)

            def as_np(t):
                return t.float().cpu().numpy()

            if isinstance(trainer, TwinGANTrainer):
                res = trainer.cfg.model.resolution
                src, tgt = fixed_batch.get("source"), fixed_batch.get("target")
                if src is None:
                    rng = np.random.RandomState(31415)
                    src = rng.rand(n_show, res, res, 3).astype(np.float32)
                    tgt = rng.rand(n_show, res, res, 3).astype(np.float32)
                src, tgt = np.asarray(src)[:n_show], np.asarray(tgt)[:n_show]
                t_prime = as_np(trainer.translate(state, torch.from_numpy(src), "s2t"))
                s_prime = as_np(trainer.translate(state, torch.from_numpy(tgt), "t2s"))
                save_image_grid(os.path.join(out_dir, f"{step}_source_t_prime.png"),
                                self._display(stack_comparison([src, t_prime])))
                save_image_grid(os.path.join(out_dir, f"{step}_target_s_prime.png"),
                                self._display(stack_comparison([tgt, s_prime])))
                if trainer.cfg.use_style_embedding:
                    # Style interpolation: one fixed source, the style lerped
                    # between two fixed N(0, 1) embeddings across the columns.
                    rng = np.random.RandomState(31415)
                    dim = trainer.cfg.style_embed_size
                    a = rng.standard_normal(dim).astype(np.float32)
                    b = rng.standard_normal(dim).astype(np.float32)
                    ts = np.linspace(0.0, 1.0, n_show, dtype=np.float32)[:, None]
                    styles = torch.from_numpy(a[None] * ts + b[None] * (1 - ts))
                    one_src = np.broadcast_to(src[:1], (n_show,) + src.shape[1:])
                    rolled = as_np(trainer.translate(state, torch.from_numpy(one_src.copy()),
                                                     "s2t", style=styles))
                    save_image_grid(os.path.join(out_dir, f"{step}_custom_t_style_roll.png"),
                                    self._display(stack_comparison([one_src, rolled])))
                custom = self._fixed_custom_sources(res, n_show)
                if custom is not None:
                    pp_eval = dataclasses.replace(self._preprocess_cfg(res), is_training=False)
                    csrc = augment_batch(torch.from_numpy(custom), pp_eval)
                    cout = as_np(trainer.translate(state, csrc, "s2t"))
                    save_image_grid(os.path.join(out_dir, f"{step}_sources_ph.png"), custom)
                    save_image_grid(os.path.join(out_dir, f"{step}_custom_t_style_rand.png"),
                                    self._display(cout))
            elif trainer.cfg.generator_network == "dcgan":
                # DCGAN: the interpolation between two fixed latents (seed
                # 314, lerp z2 -> z1), as for PGGAN's noise.
                rng = np.random.RandomState(314)
                dim = trainer.cfg.dcgan_latent_dim
                z1 = rng.standard_normal((1, dim)).astype(np.float32)
                z2 = rng.standard_normal((1, dim)).astype(np.float32)
                ts = np.linspace(0.0, 1.0, n_show, dtype=np.float32)[:, None]
                rows = [as_np(trainer.sample(state, torch.from_numpy(z1 * ts + z2 * (1 - ts))))]
                if fixed_batch.get("target") is not None:
                    rows.append(np.asarray(fixed_batch["target"])[:n_show])
                k = min(len(r) for r in rows)
                save_image_grid(os.path.join(out_dir, f"{step}.png"),
                                self._display(stack_comparison([r[:k] for r in rows])))
            elif fixed_batch.get("source") is not None:
                # Conditional or paired generation: the fixed source, its
                # output and the real target, in rows.
                src = np.asarray(fixed_batch["source"], np.float32)[:n_show]
                labels = fixed_batch.get("conditional_labels")
                if labels is not None:
                    labels = torch.from_numpy(np.asarray(labels)[:len(src)])
                rows = [src, as_np(trainer.sample(state, torch.from_numpy(src), labels=labels))]
                if fixed_batch.get("target") is not None:
                    rows.append(np.asarray(fixed_batch["target"])[:n_show])
                k = min(len(r) for r in rows)
                save_image_grid(os.path.join(out_dir, f"{step}.png"),
                                self._display(stack_comparison([r[:k] for r in rows])))
            else:
                # Noise interpolation (seed 314, lerp z2 -> z1), under the
                # first fixed example's labels for a conditional model.
                rng = np.random.RandomState(314)
                shape = noise_shape(trainer.cfg.model, 1)
                z1 = rng.standard_normal(shape).astype(np.float32)
                z2 = rng.standard_normal(shape).astype(np.float32)
                ts = np.linspace(0.0, 1.0, n_show, dtype=np.float32).reshape(-1, 1, 1, 1)
                labels = fixed_batch.get("conditional_labels")
                if labels is not None:
                    labels = torch.from_numpy(np.asarray(labels)[:1].repeat(n_show, 0))
                img = as_np(trainer.sample(state, torch.from_numpy(z1 * ts + z2 * (1 - ts)),
                                           labels=labels))
                rows = [img]
                if fixed_batch.get("target") is not None:
                    rows.append(np.asarray(fixed_batch["target"])[:n_show])
                k = min(len(r) for r in rows)
                save_image_grid(os.path.join(out_dir, f"{step}.png"),
                                self._display(stack_comparison([r[:k] for r in rows])))
        except Exception as e:  # sample dumps must never kill training
            print(f"[sample dump failed: {e}]")
