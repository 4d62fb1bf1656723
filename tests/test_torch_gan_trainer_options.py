"""GanTrainer's gdrop and conditional labels: one G step and one D step of
the port against the JAX package's, from the same bridged state, z,
gradient-penalty draws and gdrop draws.

16 px, max_channels 16, batch 2, fp32 on the CPU, DRAGAN, Adam, n_critic
2, a Polyak average, at global step 101 with gdrop strength 0.3 (at step
100 or below the schedule keeps the strength at 0 and gdrop would test
nothing). Conditional labels with 5 classes and a 4-wide embedding: as
integer class ids under norm "none" with pixel norm (pggan's
configuration, where the labels reach only the discriminator's 4x4 concat),
and as multi-hot vectors under batch norm, where they also drive the
generator's conditional norms (whose moving statistics are compared after
the G step). The gdrop draws are the Flax discriminator's own, recomputed
from the step's key (``test_torch_discriminator.jax_gdrop_noise``) and
injected per pass: the G step's, and the D step's fake, real and penalty
passes (``fold_in(k_gdrop, 0/1/2)``). ``sample`` runs under the same
labels.

Tolerances are ``tests/test_torch_gan_trainer.py``'s: losses atol 1e-4,
gradient norms rtol 1e-3, gradients (from Adam's slots) rtol 1e-3 plus a
share of the network's largest one, parameters 1e-5 where the gradient's
sign is settled, moving statistics and the gdrop state 1e-5; samples
1e-4, the generator's tolerance in that file.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_twingan_step import _unoptimized_jax_reference  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_discriminator import jax_gdrop_noise  # noqa: E402
from test_torch_gan_trainer import (  # noqa: E402,F401
    BATCH,
    DIS_GRAD_SHARE,
    GEN_GRAD_SHARE,
    STATE_ATOL,
    TRAINER_KW,
    _two_torch_threads,
    check_metrics,
    check_side,
    gp_draws,
    initial_state,
)
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainer as JaxGanTrainer  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainerConfig as JaxGanTrainerConfig  # noqa: E402
from twingan_tpu.train.losses import GanLossConfig as JaxGanLossConfig  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.train.gan_trainer import DIS, GanTrainer, GanTrainerConfig  # noqa: E402
from twingan_tpu_torch.train.losses import GanLossConfig  # noqa: E402
from twingan_tpu_torch.train.state import state_to_dict  # noqa: E402

RES = 16
STEP = 101
STRENGTH = 0.3
NUM_CLASSES, EMBED_DIM = 5, 4
OPTIONS = dict(use_gdrop=True, use_conditional_labels=True, num_classes=NUM_CLASSES,
               conditional_embed_dim=EMBED_DIM)


def configs(norm_type):
    kw = dict(resolution=RES, max_channels=16, norm_type=norm_type, do_pixel_norm=True,
              equalized_lr=True)
    jcfg = JaxGanTrainerConfig(model=JaxPGGANConfig(**kw),
                               loss=JaxGanLossConfig(architecture="dragan"),
                               **TRAINER_KW, **OPTIONS)
    pcfg = GanTrainerConfig(model=PGGANConfig(**kw), loss=GanLossConfig(architecture="dragan"),
                            **TRAINER_KW, **OPTIONS)
    return jcfg, pcfg


def labels_for(kind, rs):
    if kind == "ids":
        return np.array([3, 0], np.int32)
    return (rs.rand(BATCH, NUM_CLASSES) < 0.5).astype(np.float32)


def run_steps(norm_type, label_kind):
    jcfg, pcfg = configs(norm_type)
    jtrainer = JaxGanTrainer(jcfg)
    state0 = initial_state(jtrainer, STEP).replace(gdrop_strength=np.float32(STRENGTH))
    rs = np.random.RandomState(8)
    shape = (BATCH, 1, 1, jcfg.model.noise_dim)
    z_g, z_d, z_s = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    images = rs.rand(2, BATCH, RES, RES, 3).astype(np.float32)
    labels = labels_for(label_kind, rs)
    rng = jax.random.PRNGKey(1)

    def jbatch(img, z):
        return {"target": jnp.asarray(img), "source": jnp.asarray(z),
                "conditional_labels": jnp.asarray(labels)}

    state1, jm_g = jtrainer.g_step(jax.tree_util.tree_map(jnp.asarray, state0),
                                   jbatch(images[0], z_g), rng)
    state1 = jax.device_get(state1)
    state2, jm_d = jtrainer.d_step(jax.tree_util.tree_map(jnp.asarray, state1),
                                   jbatch(images[1], z_d), rng)
    state2 = jax.device_get(state2)
    sample = np.asarray(jtrainer.sample(jax.tree_util.tree_map(jnp.asarray, state2),
                                        jnp.asarray(z_s), labels=jnp.asarray(labels)))

    ptrainer = GanTrainer(pcfg, device="cpu")
    shapes = ptrainer.build_nets()[DIS].gdrop_shapes(BATCH)
    _, k_gdrop = jax.random.split(jax.random.fold_in(rng, STEP * 2))
    pbatch = lambda img: {"target": torch.from_numpy(img),  # noqa: E731
                          "conditional_labels": torch.from_numpy(labels)}
    g_port, pm_g = ptrainer.g_step(bridge.state_from_flax(ptrainer, state0), pbatch(images[0]),
                                   z=torch.from_numpy(z_g),
                                   gdrop_noise={"fake": jax_gdrop_noise(k_gdrop, shapes)})
    critic = int(state1.critic_step)
    _, k_gdrop, _ = jax.random.split(jax.random.fold_in(rng, critic), 3)
    gdrop = {k: jax_gdrop_noise(jax.random.fold_in(k_gdrop, i), shapes)
             for i, k in enumerate(("fake", "real", "gp"))}
    d_port, pm_d = ptrainer.d_step(bridge.state_from_flax(ptrainer, state1),
                                   {**pbatch(images[1]), "source": torch.from_numpy(z_d)},
                                   gp_noise=gp_draws(rng, critic, images[1].shape),
                                   gdrop_noise=gdrop)
    psample = ptrainer.sample(d_port, torch.from_numpy(z_s), labels=torch.from_numpy(labels))
    return dict(jtrainer=jtrainer, ptrainer=ptrainer, state1=state1, state2=state2,
                jm_g=jax.device_get(jm_g), jm_d=jax.device_get(jm_d), g_port=g_port,
                d_port=d_port, pm_g=pm_g, pm_d=pm_d, sample=sample, psample=psample.numpy())


@pytest.fixture(scope="module", params=[("none", "ids"), ("batch_norm", "multi_hot")],
                ids=["norm none, class ids", "batch norm, multi-hot"])
def steps(request):
    return run_steps(*request.param)


def test_g_step_losses_and_gdrop_strength(steps):
    check_metrics(steps["jm_g"], steps["pm_g"])
    assert float(steps["jm_g"]["gdrop_strength"]) > 0  # the schedule's strength after step 100
    np.testing.assert_allclose(float(steps["g_port"].gdrop_strength),
                               float(steps["state1"].gdrop_strength), atol=STATE_ATOL, rtol=0)


def test_g_step_generator(steps):
    check_side(steps["state1"], steps["g_port"], "gen", GEN_GRAD_SHARE)


def test_g_step_moving_statistics(steps):
    ref = {k: np.asarray(v) for k, v in bridge.flat_from_flax(steps["state1"]).items()
           if k.startswith("model_state/")}
    got = {k: v.numpy() for k, v in state_to_dict(steps["g_port"]).items()
           if k.startswith("model_state/")}
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=STATE_ATOL, rtol=0, err_msg=k)


def test_d_step_losses(steps):
    check_metrics(steps["jm_d"], steps["pm_d"])


def test_d_step_discriminator(steps):
    check_side(steps["state2"], steps["d_port"], "dis", DIS_GRAD_SHARE)


def test_sample_under_labels(steps):
    np.testing.assert_allclose(steps["psample"], steps["sample"], rtol=1e-4, atol=1e-4)


def test_conditional_labels_are_checked(steps):
    trainer, state = steps["ptrainer"], steps["d_port"]
    images = torch.rand(BATCH, RES, RES, 3)
    with pytest.raises(ValueError, match="conditional_labels"):
        trainer.d_step(state, {"target": images})
    with pytest.raises(ValueError, match="width"):
        trainer.d_step(state, {"target": images,
                               "conditional_labels": torch.zeros(BATCH, NUM_CLASSES + 1)})
    # Out-of-range class ids give all-zero rows, as the JAX one-hot does.
    labels, embed = trainer._cond({"conditional_labels": torch.tensor([NUM_CLASSES, -1])})
    assert not labels.any() and not embed.any()
