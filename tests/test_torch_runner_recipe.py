"""The reference's headline TwinGAN recipe (``docs/USAGE.md``, "Train
TwinGAN from scratch") through the port's training command on the CPU,
and a batch-renorm and spectral-norm train state through the bridge and
the port's checkpoints.

- The CLI with the recipe's flags (batch renorm, UNet, pixel norm,
  max_channels 256, DRAGAN with lambda 0.25, lr 1e-4, the recipe's
  ``hw_to_batch_size``, RESHAPE with random cropping, bfloat16) trains
  4 -> 8 px on synthetic data, one round a stage: every loss finite, every
  renorm EMA moved from its zero init, the stage configs saying
  ``batch_renorm``, and the last stage served.
- A JAX TwinGAN state (8 px, max_channels 8, batch renorm, spectral norm
  in and out of the discriminator) crosses the bridge into the port and
  back exactly; the port trains it two rounds, and a run saved by the
  port's ``CheckpointManager`` after the first round, restored into a
  fresh state and resumed, ends bit for bit where the uninterrupted run
  does (the check ``test_torch_runner.py`` makes for batch norm).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer as JaxTwinGANTrainer  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.infer.translate import ImageInferer  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.runner import pggan_runner  # noqa: E402
from twingan_tpu_torch.runner.checkpoint import CheckpointManager  # noqa: E402
from twingan_tpu_torch.runner.config_io import load_stage_config  # noqa: E402
from twingan_tpu_torch.train.state import state_to_dict  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig, TwinGANTrainer  # noqa: E402

RECIPE_FLAGS = [
    "--program_name=twingan", "--dataset_split_name=train",
    "--resize_mode=RESHAPE", "--do_random_cropping=true", "--learning_rate=0.0001",
    "--generator_network=pggan", "--use_unet=true",
    "--loss_architecture=dragan", "--gradient_penalty_lambda=0.25",
    "--pggan_max_num_channels=256", "--generator_norm_type=batch_renorm",
    "--hw_to_batch_size={4: 8, 8: 8, 16: 8, 32: 8, 64: 8, 128: 4, 256: 3, 512: 2}",
    "--do_pixel_norm=true", "--l_content_weight=0.1", "--l_cyc_weight=1.0",
    "--dtype=bfloat16",
]
STAGES = ("4", "4to8", "8")


def test_cli_runs_the_headline_recipe_on_the_cpu(tmp_path):
    train_dir = tmp_path / "recipe"
    summary = pggan_runner.main(RECIPE_FLAGS + [
        f"--train_dir={train_dir}", "--device=cpu", "--use_synthetic_data=true",
        "--start_hw=4", "--max_hw=8", "--num_images_per_resolution=8",
        "--log_image_every_n_iter=0", "--log_every_n_steps=1"])
    assert [summary[s]["steps"] for s in STAGES] == [1, 1, 1]
    for stage in STAGES:
        stage_dir = train_dir / stage
        _, tcfg = load_stage_config(str(stage_dir))
        m = tcfg.model
        assert (m.norm_type, m.max_channels, m.dtype, m.do_pixel_norm) == (
            "batch_renorm", 256, "bfloat16", True)
        assert tcfg.use_unet and tcfg.loss.gradient_penalty_lambda == 0.25
        assert tcfg.batch_size == 8 and not tcfg.fuse
        records = [json.loads(ln) for ln in open(stage_dir / "logs" / "metrics.jsonl")]
        losses = [v for r in records for k, v in r.items() if k.endswith("_loss")]
        assert losses and all(np.isfinite(losses))
        flat = CheckpointManager(str(stage_dir)).restore_dict()
        renorm = {k: v for k, v in flat.items() if "/renorm_" in k}
        assert renorm and all(bool(torch.isfinite(v).all()) for v in renorm.values())
        weights = [v for k, v in renorm.items() if "_weight_" in k]
        # One G step: each bank's weight EMA left zero in the passes that use it.
        assert any(float(v) > 0 for v in weights)
    out = ImageInferer(str(train_dir), device="cpu").infer_batch(
        [np.full((8, 8, 3), 100, np.uint8)])
    assert out.shape == (1, 8, 8, 3) and np.isfinite(out).all()


MODEL_KW = dict(resolution=8, max_channels=8, num_domains=2, norm_type="batch_renorm",
                do_pixel_norm=True, spectral_norm=True, spectral_norm_in_non_discriminator=True)
TRAINER_KW = dict(batch_size=2, moving_average_decay=0.9, use_unet=True)


@pytest.fixture(scope="module")
def jax_state():
    jtrainer = JaxTwinGANTrainer(JaxTwinGANConfig(model=JaxPGGANConfig(**MODEL_KW),
                                                  **TRAINER_KW))
    return jax.device_get(jax.jit(jtrainer.init_state)(jax.random.PRNGKey(3)))


def _trainer():
    return TwinGANTrainer(TwinGANConfig(model=PGGANConfig(**MODEL_KW), **TRAINER_KW),
                          device="cpu")


def _rounds(n):
    rng = np.random.RandomState(8)
    return [[{k: torch.from_numpy(rng.rand(2, 8, 8, 3).astype(np.float32))
              for k in ("source", "target")} for _ in range(2)] for _ in range(n)]


def test_renorm_and_spectral_state_crosses_the_bridge(jax_state):
    pstate = bridge.state_from_flax(_trainer(), jax_state)
    ref = bridge.flat_from_flax(jax_state)
    got = bridge.flat_from_flax(bridge.flax_state_dict(pstate))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert any(k.endswith("renorm_stddev_weight_1") and got[k].shape == () for k in got)
    assert sum(k.endswith("/u") for k in got) > 0
    assert {k.split("/")[2] for k in got if k.startswith("model_state/")} == {
        "batch_stats", "spectral"}


def test_checkpoint_resume_is_bit_equal(jax_state, tmp_path):
    trainer = _trainer()
    rounds = _rounds(2)
    whole = bridge.state_from_flax(trainer, jax_state)
    for batches in rounds:
        whole, _ = trainer.round_step(whole, batches, rng=5)

    split = bridge.state_from_flax(trainer, jax_state)
    split, _ = trainer.round_step(split, rounds[0], rng=5)
    cm = CheckpointManager(str(tmp_path / "stage"))
    cm.save(split.step, split)
    resumed = cm.restore(trainer.init_state(seed=11))
    assert (resumed.step, resumed.critic_step) == (1, 2)
    resumed, _ = trainer.round_step(resumed, rounds[1], rng=5)

    a, b = state_to_dict(whole), state_to_dict(resumed)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    start = bridge.torch_flat(bridge.flat_from_flax(jax_state))
    moved = [k for k in a if "/renorm_" in k or k.endswith("/u")]
    assert moved and all(not torch.equal(a[k], start[k]) for k in moved
                         if "discriminator" not in k and a[k].numel() > 1)


def _chip_smoke():
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_recipe_config_is_the_cli_recipe():
    smoke = _chip_smoke()
    cfg = smoke.recipe_config()
    m = cfg.model
    assert (m.resolution, m.max_channels, m.norm_type, m.dtype) == (256, 256, "batch_renorm",
                                                                    "bfloat16")
    assert m.do_pixel_norm and not m.equalized_lr and (m.do_self_attention,
                                                       m.self_attention_hw) == (True, 64)
    assert cfg.use_unet and cfg.loss.gradient_penalty_lambda == 0.25
    assert cfg.opt.learning_rate == 0.0001 and cfg.batch_size == smoke.TRAIN_BATCH
    assert set(RECIPE_FLAGS) <= set(smoke.RECIPE_FLAGS)


def test_chip_smoke_recipe_comparison_on_the_cpu():
    """chip_smoke.py's recipe step comparison, with the CPU standing in for
    the card at 32 px: from the seeded renorm state at step 10001 (He-scaled
    kernels, see ``he_scale_kernels``) the clip bites; bf16 against fp32
    stays within the limits the script holds the card to, the renorm EMAs
    and moving statistics after the step too; fp32 against fp32 agrees
    exactly."""
    smoke = _chip_smoke()
    cfg = smoke.recipe_config()
    cfg = cfg.replace(model=cfg.model.replace(resolution=32, max_channels=16,
                                              self_attention_hw=16))
    trainer = TwinGANTrainer(cfg, device="cpu")
    state = trainer.init_state(smoke.SEED)
    smoke.set_attention_gamma(state.nets)
    smoke.he_scale_kernels(state.nets, smoke.SEED + 8)
    smoke.seed_renorm_state(state.nets, smoke.SEED + 8)
    weights = {k: v.detach().clone() for k, v in state.nets.state_dict().items()}
    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    noise = {d: {"alpha": torch.rand(smoke.TRAIN_BATCH, 1, 1, 1, generator=gen),
                 "noise": torch.rand(smoke.TRAIN_BATCH, 32, 32, 3, generator=gen) * 2 - 1}
             for d in ("s", "t")}
    counts, restore = smoke.clip_counter()
    try:
        rows = smoke.compare_steps(cfg, weights, [smoke._train_batch(rng, cfg, "cpu")
                                                  for _ in range(2)], noise, card="cpu",
                                   step=smoke.RECIPE_STEP,
                                   held_buffers={"renorm_": None, "moving_": None})
    finally:
        restore()
    assert counts["clipped"] > 0
    for row in rows:
        assert row["ok"], row["check"]
        assert row["buffers_after_step"]["renorm_"]["held"] > 0
        if "float32 vs" in row["check"]:
            assert max(row["loss_abs_err"].values()) == 0.0
            assert row["buffers_after_step"]["renorm_"]["max_abs_err"] == 0.0
