"""Cross-package growth migration: a 4 px TwinGAN stage trained and
checkpointed (Orbax) by the JAX ``StageRunner``, converted to the port's
layout by ``tools/orbax_to_torch_stage.py``, then migrated into the 4to8
template by both packages' ``migrate_state_dict``: the JAX function on the
Orbax checkpoint, the port's on the converted one, into the same template
(the JAX 4to8 state, bridged). They agree leaf for leaf, exactly,
optimizer counts and slots included, and their reports are equal as sets,
with no exclusion and with ``exclude_scopes=("block_4_conv0",)``. Then the
port's ``StageRunner`` finishes the 4 -> 8 plan from the converted stage:
it skips ``4`` and grows ``4to8`` from it. The converted state also
crosses whole through the bridge and back, and the converted ``model.pt``
serves what the JAX method translates.

Widths 8, batch 2, 3 steps, Adam, a Polyak average (decay 0.9).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501

from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.runner.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from twingan_tpu.runner.migrate import migrate_state_dict as jax_migrate  # noqa: E402
from twingan_tpu.runner.stage_runner import RunConfig as JaxRunConfig  # noqa: E402
from twingan_tpu.runner.stage_runner import StageRunner as JaxStageRunner  # noqa: E402
from twingan_tpu.train.optimizers import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.infer.translate import ImageInferer  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.runner.checkpoint import CheckpointManager  # noqa: E402
from twingan_tpu_torch.runner.migrate import migrate_state_dict  # noqa: E402
from twingan_tpu_torch.runner.stage_runner import RunConfig, StageRunner  # noqa: E402
from twingan_tpu_torch.train.optimizers import OptimizerConfig  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig, TwinGANTrainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_KW = dict(resolution=4, max_channels=8, num_domains=2)
TRAINER_KW = dict(batch_size=2, moving_average_decay=0.9)
RUN_KW = dict(program="twingan", start_hw=4, max_hw=8, num_images_per_resolution=6,
              batch_schedule={4: 2, 8: 2}, use_synthetic_data=True, log_every_n_steps=1,
              save_every_n_steps=2, keep_checkpoints=2, log_image_every_n_iter=0)


def load_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch_stage", os.path.join(REPO, "tools", "orbax_to_torch_stage.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """The JAX 4 px stage, its conversion, and the JAX 4to8 template."""
    root = tmp_path_factory.mktemp("migration")
    jcfg = JaxRunConfig(train_dir=str(root / "jax"), num_devices=1, **dict(RUN_KW, max_hw=4),
                        trainer=JaxTwinGANConfig(
                            model=JaxPGGANConfig(**MODEL_KW), **TRAINER_KW,
                            opt=JaxOptimizerConfig(learning_rate=1e-3)))
    jrunner = JaxStageRunner(jcfg)
    assert jrunner.run()["4"]["steps"] == 3
    jax_stage = os.path.join(jcfg.train_dir, "4")
    port_stage = str(root / "port" / "4")
    steps = load_tool().convert_stage(jax_stage, port_stage)
    jtrainer, _ = jrunner._build_trainer(8, True, 3)
    template = flax.serialization.to_state_dict(
        jtrainer.init_state(jax.random.PRNGKey(jcfg.seed)))
    jtrainer4, _ = jrunner._build_trainer(4, False, 3)
    return dict(root=root, jax_stage=jax_stage, port_stage=port_stage, steps=steps,
                template=jax.device_get(template), jtrainer4=jtrainer4)


def test_conversion_keeps_every_checkpoint(stages):
    assert stages["steps"] == JaxCheckpointManager(stages["jax_stage"]).all_steps() == [2, 3]
    assert CheckpointManager(stages["port_stage"]).all_steps() == [2, 3]
    raw = JaxCheckpointManager(stages["jax_stage"]).restore_dict()
    converted = bridge.flax_flat(CheckpointManager(stages["port_stage"]).restore_dict())
    assert converted.keys() == bridge.flat_from_flax(raw).keys()
    for k, v in bridge.flat_from_flax(raw).items():
        np.testing.assert_array_equal(converted[k], v, err_msg=k)
    assert int(converted["gen_opt_state/0/count"]) == 3
    assert int(converted["dis_opt_state/1/count"]) == 3


@pytest.mark.parametrize("exclude", [(), ("block_4_conv0",)], ids=["all", "exclude"])
def test_migration_matches_jax(stages, exclude):
    raw = JaxCheckpointManager(stages["jax_stage"]).restore_dict()
    jax_out, jax_report = jax_migrate(stages["template"], raw, exclude_scopes=exclude)
    template = bridge.torch_flat(bridge.flat_from_flax(stages["template"]))
    port_out, port_report = migrate_state_dict(
        template, CheckpointManager(stages["port_stage"]).restore_dict(), exclude_scopes=exclude)
    ref = bridge.flat_from_flax(jax_out)
    got = bridge.flax_flat(port_out)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for kind in ("carried", "fresh", "dropped", "shape_mismatch"):
        assert set(port_report[kind]) == set(jax_report[kind]), kind
    carried = set(port_report["carried"])
    # The optimizers' update counts carry (they are not top-level paths);
    # the counters restart.
    assert {"gen_opt_state/0/count", "gen_opt_state/1/count",
            "dis_opt_state/0/count", "dis_opt_state/1/count"} <= carried
    assert int(got["gen_opt_state/0/count"]) == 3 and int(got["step"]) == 0
    assert any(k.startswith("gen_opt_state/0/mu/generator/block_4_conv1") for k in carried)
    assert any(k.startswith("gen_ema_params/") for k in carried)
    assert any("block_8" in k for k in port_report["fresh"])
    excluded = [k for k in port_report["fresh"] if "block_4_conv0" in k]
    assert bool(excluded) == bool(exclude)


def test_whole_state_crosses_the_bridge(stages):
    """The checkpoint as a JAX state -> the port's state (counts, slots,
    counters, average) -> the JAX state dict again, exactly."""
    raw = JaxCheckpointManager(stages["jax_stage"]).restore_dict()
    jstate = flax.serialization.from_state_dict(
        stages["jtrainer4"].init_state(jax.random.PRNGKey(0)), raw)
    ptrainer = TwinGANTrainer(TwinGANConfig(model=PGGANConfig(**MODEL_KW), **TRAINER_KW,
                                            opt=OptimizerConfig(learning_rate=1e-3)),
                              device="cpu")
    pstate = bridge.state_from_flax(ptrainer, jax.device_get(jstate))
    assert (pstate.step, pstate.critic_step, pstate.gen_opt.count) == (3, 6, 3)
    ref = bridge.flat_from_flax(flax.serialization.to_state_dict(jax.device_get(jstate)))
    got = bridge.flat_from_flax(bridge.flax_state_dict(pstate))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_converted_model_serves_what_jax_translates(stages):
    raw = JaxCheckpointManager(stages["jax_stage"]).restore_dict()
    jtrainer = stages["jtrainer4"]
    jstate = flax.serialization.from_state_dict(jtrainer.init_state(jax.random.PRNGKey(0)), raw)
    images = [np.random.RandomState(3).randint(0, 256, (4, 4, 3)).astype(np.uint8)
              for _ in range(2)]
    inferer = ImageInferer(stages["port_stage"], device="cpu")
    out = inferer.infer_batch(images)
    x = np.stack([inferer.preprocess(im) for im in images])
    ref = np.asarray(jtrainer.translate(jstate, jnp.asarray(x), "s2t"))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=2e-4)


def test_port_runner_finishes_the_plan_from_the_converted_stage(stages):
    cfg = RunConfig(train_dir=str(stages["root"] / "port"), **RUN_KW,
                    trainer=TwinGANConfig(model=PGGANConfig(**MODEL_KW), **TRAINER_KW,
                                          opt=OptimizerConfig(learning_rate=1e-3)))
    summary = StageRunner(cfg, device="cpu").run()
    assert summary["4"] == {"skipped": True, "step": 3}
    started = summary["4to8"]["started"]
    assert started["from"] == stages["port_stage"]
    raw = JaxCheckpointManager(stages["jax_stage"]).restore_dict()
    _, jax_report = jax_migrate(stages["template"], raw)
    assert started["carried"] == len(jax_report["carried"])
    assert started["fresh"] == len(jax_report["fresh"])
    assert summary["4to8"]["steps"] == summary["8"]["steps"] == 3


# A batch-renorm stage (the headline recipe's norm) with spectral norm in
# the discriminators: the renorm EMAs (their 0-d weights included) and the
# spectral vectors cross the conversion and both packages' migrations.
RENORM_KW = dict(MODEL_KW, norm_type="batch_renorm", spectral_norm=True)


@pytest.fixture(scope="module")
def renorm_stages(tmp_path_factory):
    root = tmp_path_factory.mktemp("migration_renorm")
    jcfg = JaxRunConfig(train_dir=str(root / "jax"), num_devices=1, **dict(RUN_KW, max_hw=4),
                        trainer=JaxTwinGANConfig(
                            model=JaxPGGANConfig(**RENORM_KW), **TRAINER_KW,
                            opt=JaxOptimizerConfig(learning_rate=1e-3)))
    jrunner = JaxStageRunner(jcfg)
    assert jrunner.run()["4"]["steps"] == 3
    jax_stage = os.path.join(jcfg.train_dir, "4")
    port_stage = str(root / "port" / "4")
    load_tool().convert_stage(jax_stage, port_stage)
    jtrainer, _ = jrunner._build_trainer(8, True, 3)
    template = flax.serialization.to_state_dict(
        jtrainer.init_state(jax.random.PRNGKey(jcfg.seed)))
    return dict(jax_stage=jax_stage, port_stage=port_stage, template=jax.device_get(template))


def test_renorm_migration_matches_jax(renorm_stages):
    raw = JaxCheckpointManager(renorm_stages["jax_stage"]).restore_dict()
    jax_out, jax_report = jax_migrate(renorm_stages["template"], raw)
    template = bridge.torch_flat(bridge.flat_from_flax(renorm_stages["template"]))
    port_out, port_report = migrate_state_dict(
        template, CheckpointManager(renorm_stages["port_stage"]).restore_dict())
    ref = bridge.flat_from_flax(jax_out)
    got = bridge.flax_flat(port_out)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for kind in ("carried", "fresh", "dropped", "shape_mismatch"):
        assert set(port_report[kind]) == set(jax_report[kind]), kind
    carried = set(port_report["carried"])
    weight = "model_state/generator/batch_stats/block_4_conv0/norm/renorm_mean_weight_1"
    assert weight in carried and got[weight].shape == ()
    # Three G steps moved the weight EMA from 0: 1 - 0.99 ** (passes that updated).
    assert 0 < float(got[weight]) < 1
    assert "model_state/discriminator_s/spectral/block_4_conv0/conv/u" not in ref
    assert any("/spectral/" in k and k.endswith("/u") for k in carried)
    assert any("/spectral/" in k and "block_8" in k for k in port_report["fresh"])


def test_renorm_stage_serves_what_jax_translates(renorm_stages):
    """The converted renorm stage's ``model.pt`` in eval mode: the moving
    statistics the renorm EMAs set."""
    from twingan_tpu.runner.stage_runner import StageRunner as JaxRunner

    raw = JaxCheckpointManager(renorm_stages["jax_stage"]).restore_dict()
    jcfg = JaxRunConfig(train_dir="unused", num_devices=1, **dict(RUN_KW, max_hw=4),
                        trainer=JaxTwinGANConfig(model=JaxPGGANConfig(**RENORM_KW),
                                                 **TRAINER_KW))
    jtrainer, _ = JaxRunner(jcfg)._build_trainer(4, False, 3)
    jstate = flax.serialization.from_state_dict(jtrainer.init_state(jax.random.PRNGKey(0)), raw)
    images = [np.random.RandomState(4).randint(0, 256, (4, 4, 3)).astype(np.uint8)
              for _ in range(2)]
    inferer = ImageInferer(renorm_stages["port_stage"], device="cpu")
    out = inferer.infer_batch(images)
    x = np.stack([inferer.preprocess(im) for im in images])
    ref = np.asarray(jtrainer.translate(jstate, jnp.asarray(x), "s2t"))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=2e-4)
