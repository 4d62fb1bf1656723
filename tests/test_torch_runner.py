"""The port's stage runner on the CPU, both programs, 4 -> 8 px: stage
directories and files, skipping, a split run bit-equal to an uninterrupted
one, the resume refusal, the save cadence under a scan stride, NaN
recovery, the options that raise, the trainer options through the CLI with
a resume, and the pieces it is built from
(migration, checkpoints, the flat train state, summaries, sample grids,
the CLI). Widths 8, batch 2, 3 steps a stage. No JAX function runs here
but the optimizer factory whose state layout ``state_paths`` names; the
parity of these modules with the JAX package is in
``test_torch_runner_migration.py`` and ``test_torch_runner_data.py``.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

from twingan_tpu_torch.infer.translate import ImageInferer  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.runner import pggan_runner  # noqa: E402
from twingan_tpu_torch.runner.checkpoint import (  # noqa: E402
    STATE_FILE,
    CheckpointManager,
    load_model,
)
from twingan_tpu_torch.runner.config_io import (  # noqa: E402
    load_stage_config,
    run_config_from_dict,
)
from twingan_tpu_torch.runner.migrate import RESET_PATHS, migrate_state_dict  # noqa: E402
from twingan_tpu_torch.runner.stage_runner import (  # noqa: E402
    PGGAN_BATCH_SCHEDULE,
    TWINGAN_BATCH_SCHEDULE,
    RunConfig,
    StageRunner,
    stage_dir_name,
    stage_plan,
)
from twingan_tpu_torch.train.gan_trainer import GanTrainer, GanTrainerConfig  # noqa: E402
from twingan_tpu_torch.train.optimizers import OptimizerConfig, state_paths  # noqa: E402
from twingan_tpu_torch.train.state import state_from_dict, state_to_dict  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig, TwinGANTrainer  # noqa: E402
from twingan_tpu_torch.utils.image_io import save_image_grid, stack_comparison  # noqa: E402
from twingan_tpu_torch.utils.summary import SummaryWriter  # noqa: E402

PROGRAMS = ("image_generation", "twingan")
STAGES = ("4", "4to8", "8")


def trainer_cfg(program, res=4, max_channels=8):
    opt = OptimizerConfig(learning_rate=1e-3)
    if program == "twingan":
        return TwinGANConfig(model=PGGANConfig(resolution=res, max_channels=max_channels,
                                               num_domains=2),
                             batch_size=2, opt=opt, moving_average_decay=0.9)
    return GanTrainerConfig(model=PGGANConfig(resolution=res, max_channels=max_channels,
                                              norm_type="none", do_pixel_norm=True,
                                              equalized_lr=True),
                            batch_size=2, opt=opt, moving_average_decay=0.9)


def run_cfg(tmp_path, program="image_generation", name="run", **kw):
    defaults = dict(program=program, train_dir=str(tmp_path / name), start_hw=4, max_hw=8,
                    num_images_per_resolution=6, batch_schedule={4: 2, 8: 2},
                    use_synthetic_data=True, trainer=trainer_cfg(program),
                    log_every_n_steps=1, save_every_n_steps=2, keep_checkpoints=2,
                    log_image_every_n_iter=0)
    defaults.update(kw)
    return RunConfig(**defaults)


def run(cfg):
    return StageRunner(cfg, device="cpu").run()


def load_state_file(stage_dir, step):
    return torch.load(os.path.join(stage_dir, f"ckpt-{step}", STATE_FILE),
                      weights_only=True)


# ---------------------------------------------------------------------- #
# The plan


def test_stage_plan_and_schedules():
    assert stage_plan(4, 16) == [(4, False), (8, True), (8, False), (16, True), (16, False)]
    assert stage_plan(128, 256) == [(128, False), (256, True), (256, False)]
    assert [stage_dir_name(r, g) for r, g in stage_plan(4, 8)] == list(STAGES)
    assert PGGAN_BATCH_SCHEDULE[256] == 12 and TWINGAN_BATCH_SCHEDULE[256] == 3
    runner = StageRunner(RunConfig(program="image_generation", num_images_per_resolution=48),
                         device="cpu")
    assert [runner.steps_for_stage(r) for r in (4, 32, 64, 256)] == [3, 3, 4, 4]
    runner = StageRunner(RunConfig(num_images_schedule={128: 8, 256: 6}), device="cpu")
    assert [runner.steps_for_stage(r) for r in (128, 256)] == [2, 2]


# ---------------------------------------------------------------------- #
# Whole runs


@pytest.mark.parametrize("program", PROGRAMS)
def test_progressive_run_writes_every_stage_and_skips_when_done(tmp_path, program):
    cfg = run_cfg(tmp_path, program, log_image_every_n_iter=2)
    summary = run(cfg)
    assert list(summary) == list(STAGES)
    for stage in STAGES:
        stage_dir = os.path.join(cfg.train_dir, stage)
        info = summary[stage]
        assert info["steps"] == 3
        assert {"build_s", "restore_s", "rounds_s", "saves_s"} <= set(info)
        assert info["saves"] == 3  # steps 2 and 3, and model.pt
        assert CheckpointManager(stage_dir).all_steps() == [2, 3]
        assert sorted(os.listdir(stage_dir)) == ["ckpt-2", "ckpt-3", "config.json",
                                                 "generated_samples", "logs", "model.pt"]
        run_dict, tcfg = load_stage_config(stage_dir)
        assert run_config_from_dict(run_dict, tcfg) == cfg.replace(trainer=tcfg)
        res = int(stage.split("to")[-1])
        assert tcfg.model.resolution == res and tcfg.model.is_growing == ("to" in stage)
        assert tcfg.max_steps == 3
        _, step = load_model(stage_dir)
        assert step == 3
        records = [json.loads(ln) for ln in open(os.path.join(stage_dir, "logs",
                                                              "metrics.jsonl"))]
        assert [r["step"] for r in records if "generator_loss" in r] == [1, 2, 3]
        assert all(np.isfinite(r["generator_loss"]) for r in records if "generator_loss" in r)
        assert os.listdir(os.path.join(stage_dir, "generated_samples"))
    assert all(info.get("skipped") for info in run(cfg).values())


def test_trained_twingan_stage_serves(tmp_path):
    cfg = run_cfg(tmp_path, "twingan", max_hw=4)
    run(cfg)
    inferer = ImageInferer(cfg.train_dir, device="cpu")
    assert inferer.step == 3 and inferer.image_hw == 4
    out = inferer.infer_batch([np.full((4, 4, 3), 128, np.uint8)])
    assert out.shape == (1, 4, 4, 3) and np.isfinite(out).all()


@pytest.mark.parametrize("program", PROGRAMS)
def test_run_split_by_max_stages_is_bit_equal(tmp_path, program):
    whole = run_cfg(tmp_path, program, name="whole")
    run(whole)
    split = run_cfg(tmp_path, program, name="split", max_stages_per_run=1)
    calls = 0
    while True:
        calls += 1
        summary = run(split)
        executed = [s for s, info in summary.items() if s in STAGES and not info.get("skipped")]
        assert len(executed) <= 1
        if not summary.get("_incomplete"):
            break
    assert calls == 3
    for stage in STAGES:
        for step in (2, 3):
            a = load_state_file(os.path.join(whole.train_dir, stage), step)
            b = load_state_file(os.path.join(split.train_dir, stage), step)
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), (stage, step, k)
        a, b = (load_model(os.path.join(c.train_dir, stage))[0] for c in (whole, split))
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_resume_mid_stage_continues_from_the_checkpoint(tmp_path):
    first = run_cfg(tmp_path, max_hw=4, num_images_per_resolution=4)  # 2 steps
    run(first)
    summary = run(first.replace(num_images_per_resolution=8))  # 4 steps
    assert summary["4"]["steps"] == 4
    assert CheckpointManager(os.path.join(first.train_dir, "4")).all_steps() == [2, 4]


def test_resume_into_a_changed_model_refuses(tmp_path):
    """A stage dir resumed under another model: nothing under ``params``
    matches by path and shape, and the restore refuses a silent fresh
    start (as the JAX manager does)."""
    first = run_cfg(tmp_path, "twingan", max_hw=4, num_images_per_resolution=4)
    run(first)
    changed = run_cfg(tmp_path, "image_generation", max_hw=4,
                      trainer=trainer_cfg("image_generation", max_channels=16))
    with pytest.raises(ValueError, match="matches no parameter"):
        run(changed)


def test_external_warm_start_with_excluded_scopes(tmp_path):
    pre = run_cfg(tmp_path, name="pre", max_hw=4)
    run(pre)
    external = os.path.join(pre.train_dir, "4")
    cfg = run_cfg(tmp_path, max_hw=4, checkpoint_path=external,
                  checkpoint_exclude_scopes=("block_4_conv0",))
    started = run(cfg)["4"]["started"]
    assert started["from"] == external
    assert started["carried"] > 0 and started["dropped"] == 0
    # block_4_conv0's kernel and bias, their Adam slots (mu, nu) and
    # average, and the 4 counters.
    assert started["fresh"] == 2 + 2 * 2 + 2 + 4


def test_skip_start_stage_grows_from_the_external_checkpoint(tmp_path):
    pre = run_cfg(tmp_path, name="pre", max_hw=4)
    run(pre)
    external = os.path.join(pre.train_dir, "4")
    summary = run(run_cfg(tmp_path, checkpoint_path=external, skip_start_stage=True))
    assert summary["4"] == {"skipped": True, "external": external}
    assert summary["4to8"]["started"]["from"] == external
    assert not os.path.exists(os.path.join(tmp_path, "run", "4"))


def test_transfer_bound_pauses_and_the_next_run_resumes(tmp_path):
    cfg = run_cfg(tmp_path, max_hw=4, max_transfer_gb_per_run=1e-9)
    summary = run(cfg)
    assert summary["_incomplete"] and summary["4"]["partial"] and summary["4"]["steps"] == 1
    assert not os.path.exists(os.path.join(cfg.train_dir, "4", "model.pt"))
    for _ in range(2):
        summary = run(cfg)
    assert "_incomplete" not in summary and summary["4"]["steps"] == 3
    assert summary["4"]["started"] == {"from": os.path.join(cfg.train_dir, "4"),
                                       "resumed_at": 2}


def test_save_cadence_with_non_dividing_scan_stride(tmp_path):
    """Strides of 4 never land on a multiple of 10; the cadence fires on
    crossing 10 and 20 (at 12 and 20), then the final save at 21."""
    cfg = run_cfg(tmp_path, start_hw=8, max_hw=8, num_images_per_resolution=42,
                  rounds_per_scan=4, save_every_n_steps=10, keep_checkpoints=3,
                  trainer=trainer_cfg("image_generation", res=8))
    summary = run(cfg)
    assert summary["8"]["steps"] == 21
    assert CheckpointManager(os.path.join(cfg.train_dir, "8")).all_steps() == [12, 20, 21]


def test_final_save_skips_the_step_the_cadence_just_wrote(tmp_path):
    """4 steps saving every 2: checkpoints at 2 and 4, each written once,
    and model.pt."""
    cfg = run_cfg(tmp_path, max_hw=4, num_images_per_resolution=8)
    info = run(cfg)["4"]
    assert info["steps"] == 4 and info["saves"] == 3
    assert CheckpointManager(os.path.join(cfg.train_dir, "4")).all_steps() == [2, 4]


def test_profile_stage_steps_writes_a_trace(tmp_path):
    cfg = run_cfg(tmp_path, max_hw=4, profile_stage_steps=1)
    run(cfg)
    assert os.path.isfile(os.path.join(cfg.train_dir, "4", "profile", "trace.json"))


# ---------------------------------------------------------------------- #
# NaN recovery


def _poison(monkeypatch, method, when):
    real = getattr(GanTrainer, method)
    fired = {"n": 0}

    def poisoned(self, state, batches, rng):
        state, metrics = real(self, state, batches, rng)
        if when(state, fired["n"]):
            fired["n"] += 1
            metrics = dict(metrics)
            loss = metrics["generator_loss"]
            metrics["generator_loss"] = torch.full_like(loss, float("nan"))
        return state, metrics

    monkeypatch.setattr(GanTrainer, method, poisoned)
    return fired


def test_nan_restores_the_last_checkpoint_and_finishes(tmp_path, monkeypatch, capsys):
    cfg = run_cfg(tmp_path, max_hw=4, num_images_per_resolution=8, max_nan_recoveries=2)
    fired = _poison(monkeypatch, "round_step", lambda s, n: s.step == 3 and n == 0)
    summary = run(cfg)
    assert fired["n"] == 1
    assert summary["4"]["steps"] == 4
    assert "restored checkpoint at step 2 (recovery 1/2)" in capsys.readouterr().out


def test_nan_recovery_budget_runs_out(tmp_path, monkeypatch):
    cfg = run_cfg(tmp_path, max_hw=4, num_images_per_resolution=8, max_nan_recoveries=1)
    _poison(monkeypatch, "round_step", lambda s, n: True)
    with pytest.raises(FloatingPointError, match="recovery budget exhausted"):
        run(cfg)


def test_async_probe_recovers_and_never_saves_a_nan(tmp_path, monkeypatch):
    cfg = run_cfg(tmp_path, max_hw=4, num_images_per_resolution=32, rounds_per_scan=2,
                  save_every_n_steps=4, keep_checkpoints=0, max_nan_recoveries=2,
                  async_probe=True)
    fired = _poison(monkeypatch, "scan_rounds", lambda s, n: s.step == 6 and n == 0)
    summary = run(cfg)
    assert fired["n"] == 1 and summary["4"]["steps"] == 16
    stage_dir = os.path.join(cfg.train_dir, "4")
    for step in CheckpointManager(stage_dir).all_steps():
        for k, v in load_state_file(stage_dir, step).items():
            assert torch.isfinite(v.float()).all(), (step, k)


# ---------------------------------------------------------------------- #
# Several devices without their processes


@pytest.mark.parametrize("kw,item", [
    (dict(num_devices=2), "torchrun --nproc_per_node 2"),
    (dict(num_devices=4, dataset_dir="/data/records", eval_every_n_iter_in_training=100),
     "torchrun --nproc_per_node 4"),
])
def test_unported_options_raise(tmp_path, kw, item):
    # Several devices are ported (A9): one process each, which torchrun
    # starts (test_torch_multihost.py runs two). A num_devices that the
    # run's process group does not match, here none, raises naming
    # torchrun. Real data (A10) and the in-training SWD (A11) run
    # (test_torch_runner_realdata.py).
    with pytest.raises(ValueError, match=item):
        StageRunner(run_cfg(tmp_path, use_synthetic_data=False, **kw), device="cpu")


def test_runner_runs_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StageRunner(run_cfg(tmp_path))


# ---------------------------------------------------------------------- #
# Migration, checkpoints, the flat state


def test_migration_report():
    t = {"params/g/a/kernel": torch.zeros(2, 3), "params/g/b/kernel": torch.zeros(4),
         "params/g/new/kernel": torch.zeros(1), "step": torch.tensor(0),
         "gen_opt_state/0/count": torch.tensor(0)}
    r = {"params/g/a/kernel": torch.ones(2, 3), "params/g/b/kernel": torch.ones(5),
         "params/g/gone/kernel": torch.ones(1), "step": torch.tensor(7),
         "gen_opt_state/0/count": torch.tensor(7)}
    out, report = migrate_state_dict(t, r)
    assert torch.equal(out["params/g/a/kernel"], r["params/g/a/kernel"])
    assert torch.equal(out["params/g/b/kernel"], t["params/g/b/kernel"])
    assert int(out["step"]) == 0 and int(out["gen_opt_state/0/count"]) == 7
    assert report == {"carried": ["params/g/a/kernel", "gen_opt_state/0/count"],
                      "fresh": ["params/g/new/kernel", "step"],
                      "dropped": ["params/g/gone/kernel"],
                      "shape_mismatch": ["params/g/b/kernel: (5,) -> (4,)"]}
    assert set(RESET_PATHS) == {"step", "critic_step", "gen_loss_ema", "gdrop_strength"}
    with pytest.raises(ValueError, match="no destination"):
        migrate_state_dict(t, r, strict_unused=True)


@pytest.mark.parametrize("scope,fresh", [
    ("params/generator", {"params/generator/block_4_conv0/conv/kernel",
                          "params/generator/to_rgb_4/conv/kernel"}),
    ("block_4_conv0", {"params/generator/block_4_conv0/conv/kernel",
                       "gen_opt_state/0/mu/block_4_conv0/conv/kernel"}),
    ("conv0", set()),  # a bare substring excludes nothing
])
def test_migration_exclude_scopes(scope, fresh):
    paths = ["params/generator/block_4_conv0/conv/kernel", "params/generator/to_rgb_4/conv/kernel",
             "gen_opt_state/0/mu/block_4_conv0/conv/kernel"]
    flat = {p: torch.ones(2) for p in paths}
    _, report = migrate_state_dict({p: torch.zeros(2) for p in paths}, flat,
                                   exclude_scopes=(scope,))
    assert set(report["fresh"]) == fresh
    assert set(report["carried"]) == set(paths) - fresh


def test_checkpoint_keep_never_prunes_the_step_just_written(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    for step in (5, 6, 7):
        cm.save(step, {"step": torch.tensor(step)}, keep=2)
    assert cm.all_steps() == [6, 7]
    cm.save(3, {"step": torch.tensor(3)}, keep=2)  # sorts below the others
    assert cm.all_steps() == [3, 7]
    assert int(cm.restore_dict()["step"]) == 7 and int(cm.restore_dict(3)["step"]) == 3
    cm.save(9, {"step": torch.tensor(9)}, keep=0)
    assert cm.all_steps() == [3, 7, 9]
    assert CheckpointManager(str(tmp_path / "empty")).restore_dict() is None


@pytest.mark.parametrize("opt,counts,slots", [
    (dict(optimizer="adam"), ("0/count", "1/count"), {"mu": "0/mu", "nu": "0/nu"}),
    (dict(optimizer="sgd"), ("1/count",), {}),
    (dict(optimizer="momentum", weight_decay=0.1, clip_global_norm=1.0, frozen_scopes=("x",)),
     ("0/1/1/1/count",), {"trace": "0/1/1/0/trace"}),
    (dict(optimizer="momentum"), ("1/count",), {"trace": "0/trace"}),
    (dict(optimizer="adam", frozen_scopes=("x",)), ("0/0/count", "0/1/count"),
     {"mu": "0/0/mu", "nu": "0/0/nu"}),
    (dict(optimizer="adam", weight_decay=0.1, clip_global_norm=1.0),
     ("1/1/0/count", "1/1/1/count"), {"mu": "1/1/0/mu", "nu": "1/1/0/nu"}),
    (dict(optimizer="sgd", clip_global_norm=1.0), ("1/1/count",), {}),
])
def test_optimizer_state_paths(opt, counts, slots):
    """Where optax's chain keeps the counts and slots: the paths of
    ``to_state_dict`` of the state that the JAX package's factory builds
    for the same config, frozen scopes included."""
    import flax
    import jax.numpy as jnp
    from twingan_tpu.train.optimizers import OptimizerConfig as JaxOptimizerConfig
    from twingan_tpu.train.optimizers import build_optimizer

    assert state_paths(OptimizerConfig(**opt)) == (counts, slots)
    params = {"x": {"kernel": jnp.zeros(2)}, "y": {"kernel": jnp.zeros(3), "bias": jnp.zeros(3)}}
    tx = build_optimizer(JaxOptimizerConfig(**opt))
    flat = flax.traverse_util.flatten_dict(flax.serialization.to_state_dict(tx.init(params)),
                                           sep="/")
    assert tuple(sorted(k for k in flat if k.endswith("count"))) == counts
    found = {}
    for key in flat:
        parts = key.split("/")
        for i, part in enumerate(parts):
            if part in ("mu", "nu", "trace"):
                found.setdefault(part, set()).add("/".join(parts[:i + 1]))
                assert "/".join(parts[i + 1:]) in ("x/kernel", "y/kernel", "y/bias"), key
    assert found == {slot: {prefix} for slot, prefix in slots.items()}


@pytest.mark.parametrize("program", PROGRAMS)
def test_flat_state_round_trip(program):
    cfg = trainer_cfg(program, res=8).replace(max_steps=10)
    trainer = (GanTrainer if program == "image_generation" else TwinGANTrainer)(cfg, device="cpu")
    state = trainer.init_state(0)
    rng = np.random.RandomState(0)
    keys = ("target",) if program == "image_generation" else ("source", "target")
    batch = {k: torch.from_numpy(rng.rand(2, 8, 8, 3).astype(np.float32)) for k in keys}
    state, _ = trainer.round_step(state, [batch, batch])
    flat = {k: v.clone() for k, v in state_to_dict(state).items()}
    assert int(flat["step"]) == 1 and int(flat["critic_step"]) == 2
    assert int(flat["gen_opt_state/0/count"]) == int(flat["gen_opt_state/1/count"]) == 1
    assert any(k.startswith("gen_ema_params/") for k in flat)
    assert any(k.startswith("gen_opt_state/0/nu/") and v.abs().sum() > 0
               for k, v in flat.items())
    fresh = state_from_dict(trainer.init_state(1), flat)
    again = state_to_dict(fresh)
    assert again.keys() == flat.keys()
    for k in flat:
        assert torch.equal(again[k], flat[k]), k
    assert (fresh.step, fresh.critic_step, fresh.gen_opt.count) == (1, 2, 1)


# ---------------------------------------------------------------------- #
# Summaries, grids, the CLI


def test_summary_writer_logs_scalars_only(tmp_path):
    w = SummaryWriter(str(tmp_path))
    w.scalars(3, {"loss": torch.tensor(1.5), "alpha": 0.25, "vec": torch.zeros(2)})
    w.histograms(3, {"w": np.zeros(4)})
    w.close()
    (rec,) = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert rec["step"] == 3 and rec["loss"] == 1.5 and rec["alpha"] == 0.25
    assert "vec" not in rec


def test_image_grid_and_comparison(tmp_path):
    a, b = np.zeros((3, 4, 5, 3), np.float32), np.ones((3, 4, 5, 3), np.float32)
    s = stack_comparison([a, b])
    assert s.shape == (3, 8, 5, 3)
    assert (s[:, :4] == 0).all() and (s[:, 4:] == 1).all()
    pytest.importorskip("PIL")
    save_image_grid(str(tmp_path / "g.png"), s)
    assert os.path.getsize(tmp_path / "g.png") > 0


def test_cli_trains_on_the_cpu(tmp_path):
    summary = pggan_runner.main([
        f"--train_dir={tmp_path / 'cli'}", "--device=cpu", "--use_synthetic_data=true",
        "--program_name=image_generation", "--start_hw=4", "--max_hw=8",
        "--num_images_per_resolution=4", "--batch_size=2", "--pggan_max_num_channels=8",
        "--generator_norm_type=none", "--do_pixel_norm=true",
        "--equalized_learning_rate=true", "--log_image_every_n_iter=0"])
    assert [summary[s]["steps"] for s in STAGES] == [2, 2, 2]
    assert os.path.isfile(tmp_path / "cli" / "8" / "model.pt")


OPTION_FLAGS = {
    "twingan": ["--use_style_embedding=true", "--style_embed_size=4",
                "--do_encoder_distillation=true", "--source_embed_dim=6", "--optimizer=rmsprop"],
    "image_generation": ["--generator_norm_type=batch_norm", "--use_conditional_labels=true",
                         "--num_classes=5", "--optimizer=adagrad"],
}


@pytest.mark.parametrize("program", PROGRAMS)
def test_cli_trains_with_the_options_and_resumes(tmp_path, program):
    """The trainer options' flags through the training command, 4 -> 8 px
    on synthetic data, in two calls on one train dir (the second skips the
    finished stages and grows 8 from disk): gdrop, remat, the style
    embedding with distillation and rmsprop (TwinGAN), conditional labels
    with conditional batch norm and adagrad (generation). Sample grids at
    every step (the style-interpolation grid for TwinGAN), the gdrop
    strength among the logged metrics, and the last stage served."""
    train_dir = tmp_path / "opts"
    flags = [f"--train_dir={train_dir}", "--device=cpu", "--use_synthetic_data=true",
             f"--program_name={program}", "--start_hw=4", "--max_hw=8",
             "--num_images_per_resolution=4", "--batch_size=2", "--pggan_max_num_channels=8",
             "--use_gdrop=true", "--remat=true", "--log_image_every_n_iter=1",
             "--save_every_n_steps=1", "--log_every_n_steps=1"] + OPTION_FLAGS[program]
    first = pggan_runner.main(flags + ["--max_stages_per_run=2"])
    assert first.get("_incomplete") and "8" not in first
    second = pggan_runner.main(flags)
    assert second["4"]["skipped"] and second["4to8"]["skipped"]
    assert second["8"]["steps"] == 2 and second["8"]["started"]["carried"] > 0
    _, tcfg = load_stage_config(str(train_dir / "8"))
    assert tcfg.use_gdrop and tcfg.remat
    for stage in STAGES:
        records = [json.loads(ln) for ln in open(train_dir / stage / "logs" / "metrics.jsonl")]
        assert all(np.isfinite(r["generator_loss"]) and "gdrop_strength" in r
                   for r in records if "generator_loss" in r)
        grids = os.listdir(train_dir / stage / "generated_samples")
        assert len(grids) >= 2
        if program == "twingan":
            assert any(g.endswith("_custom_t_style_roll.png") for g in grids), grids
    state_dict, step = load_model(str(train_dir / "8"))
    if program == "twingan":
        assert tcfg.use_style_embedding and tcfg.opt.optimizer == "rmsprop"
        assert any(k.startswith("encoder_style.") for k in state_dict)
        assert not any(k.startswith("distill_") for k in state_dict)
        inferer = ImageInferer(str(train_dir / "8"), device="cpu")
        images = [np.random.RandomState(1).randint(0, 256, (8, 8, 3)).astype(np.uint8)] * 2
        out = inferer.infer_batch(images)
        styled = inferer.infer_batch(images, style=torch.zeros(2, 4))
        assert out.shape == (2, 8, 8, 3) and np.isfinite(out).all()
        assert not np.allclose(out, styled)
    else:
        # The trainer takes style_dim from num_classes; the config keeps the
        # flags' values, as the JAX runner writes it.
        assert tcfg.use_conditional_labels and tcfg.num_classes == 5
        assert any("beta_fc_kernel" in k for k in state_dict)
