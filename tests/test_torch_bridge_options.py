"""Whole train states with the trainer options through the bridge, and
across a growth stage, against the JAX package.

A JAX TwinGAN state with the style embedding (``encoder_style``),
distillation (``distill_s``/``distill_t``) and gdrop under rmsprop, and
JAX generation states with conditional labels and gdrop under adagrad,
adadelta and ftrl, at 4 px (max_channels 8), every leaf (parameters,
moving statistics, optimizer slots, counters, the gdrop state) drawn
from a seed: each bridges into the port (``bridge.state_from_flax``) and
back (``bridge.flax_state_dict``) unchanged, and migrates into the 4to8
template with both packages' ``migrate_state_dict`` to the same leaves
and the same report. Exact equality throughout.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501

import flax.serialization  # noqa: E402
import jax  # noqa: E402

from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.runner.migrate import migrate_state_dict as jax_migrate  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainer as JaxGanTrainer  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainerConfig as JaxGanTrainerConfig  # noqa: E402
from twingan_tpu.train.optimizers import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer as JaxTwinGANTrainer  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.runner.migrate import migrate_state_dict  # noqa: E402
from twingan_tpu_torch.train.gan_trainer import GanTrainer, GanTrainerConfig  # noqa: E402
from twingan_tpu_torch.train.optimizers import OptimizerConfig  # noqa: E402
from twingan_tpu_torch.train.state import state_from_dict, state_to_dict  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig, TwinGANTrainer  # noqa: E402

TWINGAN_KW = dict(use_style_embedding=True, style_embed_size=4, do_encoder_distillation=True,
                  source_embed_dim=6, use_gdrop=True, moving_average_decay=0.9, batch_size=2)
GENERATION_KW = dict(use_gdrop=True, use_conditional_labels=True, num_classes=5,
                     conditional_embed_dim=3, moving_average_decay=0.9, batch_size=2)


def build(program, optimizer, res, growing):
    """(JAX trainer, port trainer) at one stage."""
    model = dict(resolution=res, is_growing=growing, max_channels=8,
                 num_domains=2 if program == "twingan" else 1,
                 style_dim=4 if program == "twingan" else 0)
    if program == "twingan":
        return (JaxTwinGANTrainer(JaxTwinGANConfig(
                    model=JaxPGGANConfig(**model),
                    opt=JaxOptimizerConfig(optimizer=optimizer), **TWINGAN_KW)),
                TwinGANTrainer(TwinGANConfig(model=PGGANConfig(**model),
                                             opt=OptimizerConfig(optimizer=optimizer),
                                             **TWINGAN_KW), device="cpu"))
    model["norm_type"] = "none"
    return (JaxGanTrainer(JaxGanTrainerConfig(model=JaxPGGANConfig(**model),
                                              opt=JaxOptimizerConfig(optimizer=optimizer),
                                              **GENERATION_KW)),
            GanTrainer(GanTrainerConfig(model=PGGANConfig(**model),
                                        opt=OptimizerConfig(optimizer=optimizer),
                                        **GENERATION_KW), device="cpu"))


def seeded_state_dict(jtrainer, seed):
    """The JAX init state's state dict with every float leaf redrawn (and
    accumulators kept positive) and the counters set."""
    state = jax.device_get(jtrainer.init_state(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(seed)

    def draw(path, v):
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.integer):
            return np.full(v.shape, 7, v.dtype)
        positive = any(k in str(path) for k in ("moving_var", "nu", "sum_of_squares", "accum",
                                                 "e_g", "e_x"))
        x = rs.rand(*v.shape) + 0.1 if positive else rs.randn(*v.shape)
        return np.asarray(x, v.dtype)

    sd = flax.serialization.to_state_dict(state)
    return jax.tree_util.tree_map_with_path(draw, sd), state


@pytest.fixture(scope="module", params=[("twingan", "rmsprop"), ("generation", "adagrad"),
                                        ("generation", "adadelta"), ("generation", "ftrl")],
                ids=lambda p: "-".join(p))
def stages(request):
    program, optimizer = request.param
    jtrainer, ptrainer = build(program, optimizer, 4, False)
    sd, state = seeded_state_dict(jtrainer, 3)
    jtemplate, ptemplate = build(program, optimizer, 8, True)
    template = flax.serialization.to_state_dict(
        jax.device_get(jtemplate.init_state(jax.random.PRNGKey(1))))
    return dict(program=program, optimizer=optimizer, sd=sd, state=state, ptrainer=ptrainer,
                template=template, ptemplate=ptemplate)


def test_state_bridges_in_and_out_unchanged(stages):
    jstate = flax.serialization.from_state_dict(stages["state"], stages["sd"])
    port = bridge.state_from_flax(stages["ptrainer"], jstate)
    ref = bridge.flat_from_flax(stages["sd"])
    got = bridge.flat_from_flax(bridge.flax_state_dict(port))
    assert got.keys() == ref.keys(), sorted(set(got) ^ set(ref))
    names = {k.split("/")[1] for k in ref if k.startswith("params/")}
    if stages["program"] == "twingan":
        assert {"encoder_style", "distill_s", "distill_t"} <= names
    slot = {"rmsprop": "/nu/", "adagrad": "/sum_of_squares/", "adadelta": "/e_x/",
            "ftrl": "/linear/"}[stages["optimizer"]]
    assert any(slot in k for k in ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


def test_growth_migration_matches_jax(stages):
    jstate = flax.serialization.from_state_dict(stages["state"], stages["sd"])
    port = bridge.state_from_flax(stages["ptrainer"], jstate)
    jax_out, jax_report = jax_migrate(stages["template"], stages["sd"])
    template = bridge.torch_flat(bridge.flat_from_flax(stages["template"]))
    port_out, port_report = migrate_state_dict(template, state_to_dict(port))
    ref = bridge.flat_from_flax(jax_out)
    got = bridge.flax_flat(port_out)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    for kind in ("carried", "fresh", "dropped", "shape_mismatch"):
        assert set(port_report[kind]) == set(jax_report[kind]), kind
    assert any(p.startswith(("gen_opt_state", "dis_opt_state")) for p in port_report["carried"])
    # The migrated dict loads into the port's 4to8 state.
    ptemplate = stages["ptemplate"]
    state_from_dict(ptemplate.state_from_nets(ptemplate.build_nets()), port_out)
