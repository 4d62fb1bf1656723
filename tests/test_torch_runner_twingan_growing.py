"""The checks of ``test_torch_twingan_step.py`` on a growing stage, and
``TwinGANTrainer.translate`` against the JAX method there.

The same model (batch norm, the unfused passes, UNet, SAGAN at 16 px with
sa_gamma 0.7) at 32 px, growing from 16: the G step runs at global step 3
of max_steps 10, so alpha 0.3 blends the new resolution's output with the
upsampled to_rgb of the last one and the real images with their
low-resolution selves (``growing_image``); the D step follows from the
JAX state after it (step 4, alpha 0.4). Same draws, helpers and
tolerances as that file: losses atol 1e-4, moving statistics and
post-step parameters atol 1e-5, gradients within rtol 1e-3 plus a share
of the largest (1e-2 generator side, 1e-3 discriminator side).
``test_torch_runner_twingan_growing64.py`` runs the same steps at 64 px,
where the cycle GAN term is on.

``translate`` runs on the state after the G step (alpha 0.3), in both
directions, with a Polyak average drawn at random (so that using it or
not shows): eval-mode statistics and the average's parameters, outputs
within the file's 1e-4 (measured: 1.03e-5 at most on outputs up to 4.7).
A file of its own, so that its JAX compilation runs on another test
worker.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_twingan_step as base  # noqa: E402
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501

from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.train.losses import GanLossConfig as JaxGanLossConfig  # noqa: E402
from twingan_tpu.train.optimizers import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANConfig as JaxTwinGANConfig  # noqa: E402
from twingan_tpu.train.twingan_trainer import TwinGANTrainer as JaxTwinGANTrainer  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.train.losses import GanLossConfig  # noqa: E402
from twingan_tpu_torch.train.optimizers import OptimizerConfig  # noqa: E402
from twingan_tpu_torch.train.twingan_trainer import (  # noqa: E402
    ENC,
    GEN,
    TwinGANConfig,
    TwinGANTrainer,
)

START_STEP = 3
MAX_STEPS = 10
RES = 32
MODEL_KW = dict(base.MODEL_KW, resolution=RES, norm_type="batch_norm", is_growing=True)
TRAINER_KW = dict(base.TRAINER_KW, max_steps=MAX_STEPS)
TRANSLATE_ATOL = base.LOSS_ATOL


def configs(res=RES, **kw):
    model_kw = dict(MODEL_KW, resolution=res)
    jcfg = JaxTwinGANConfig(model=JaxPGGANConfig(**model_kw),
                            loss=JaxGanLossConfig(architecture="dragan"),
                            opt=JaxOptimizerConfig(optimizer="sgd", learning_rate=base.LR),
                            **TRAINER_KW, **kw)
    pcfg = TwinGANConfig(model=PGGANConfig(**model_kw), loss=GanLossConfig(architecture="dragan"),
                         opt=OptimizerConfig(optimizer="sgd", learning_rate=base.LR),
                         **TRAINER_KW, **kw)
    return jcfg, pcfg


def initial_state(jtrainer, res=RES):
    """The JAX init_state with the norm banks and moving statistics drawn
    from a seed, at START_STEP, and four batches of images from the same
    seed: (state0, params0, model_state0, images)."""
    state0 = jax.jit(jtrainer.init_state)(jax.random.PRNGKey(0))
    rs = np.random.RandomState(5)
    params0 = base.randomize(jax.device_get(state0.params), rs)
    model_state0 = base.randomize(jax.device_get(state0.model_state), rs)
    state0 = state0.replace(params=params0, model_state=model_state0,
                            step=jnp.asarray(START_STEP, jnp.int32),
                            critic_step=jnp.asarray(2 * START_STEP, jnp.int32))
    images = rs.rand(4, base.BATCH, res, res, 3).astype(np.float32)
    return state0, params0, model_state0, images


def run_steps(res=RES):
    """Both trainers' G step and D step from the same state at ``res``."""
    jcfg, pcfg = configs(res)
    jtrainer = JaxTwinGANTrainer(jcfg)
    jtrainer.gen_tx = base.recording_sgd(base.LR)
    jtrainer.dis_tx = base.recording_sgd(base.LR)
    state0, params0, model_state0, images = initial_state(jtrainer, res)
    batch_g = {"source": images[0], "target": images[1]}
    batch_d = {"source": images[2], "target": images[3]}
    rng = jax.random.PRNGKey(1)
    state1, jm_g = jtrainer.g_step(state0, jax.tree_util.tree_map(jnp.asarray, batch_g), rng)
    state1 = jax.device_get(state1)
    state2, jm_d = jtrainer.d_step(state1, jax.tree_util.tree_map(jnp.asarray, batch_d), rng)
    state2 = jax.device_get(state2)

    ptrainer = TwinGANTrainer(pcfg, device="cpu")
    torch_batch = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}  # noqa: E731
    pstate = base._port_state(ptrainer, params0, model_state0, START_STEP, 2 * START_STEP)
    g_port, pm_g = ptrainer.g_step(pstate, torch_batch(batch_g))
    pstate = base._port_state(ptrainer, state1.params, state1.model_state,
                              int(state1.step), int(state1.critic_step))
    noise = base.gp_draws(rng, int(state1.critic_step), batch_d["source"].shape)
    d_port, pm_d = ptrainer.d_step(pstate, torch_batch(batch_d), gp_noise=noise)
    return dict(state1=state1, state2=state2, jm_g=jax.device_get(jm_g),
                jm_d=jax.device_get(jm_d), g_port=g_port, d_port=d_port, pm_g=pm_g, pm_d=pm_d,
                images=images, params0=params0, model_state0=model_state0, batch_g=batch_g,
                pcfg=pcfg)


@pytest.fixture(scope="module")
def steps():
    return run_steps()


def test_alpha(steps):
    assert float(steps["jm_g"]["alpha"]) == pytest.approx(0.3)
    assert steps["pm_g"]["alpha"] == pytest.approx(0.3)
    assert steps["d_port"].step == START_STEP + 1


def test_g_step_losses(steps):
    base.check_metrics(steps["jm_g"], steps["pm_g"])


def test_g_step_gradients(steps):
    base.check_grads(steps["state1"].gen_opt_state, steps["g_port"].gen_opt, base.GEN_SIDE,
                     base.GEN_GRAD_SHARE)


def test_g_step_state(steps):
    s1 = steps["state1"]
    base.check_state(s1.params, s1.model_state, steps["g_port"], base.GEN_SIDE)
    assert steps["g_port"].step == int(s1.step) == START_STEP + 1
    assert steps["g_port"].critic_step == int(s1.critic_step) == 2 * START_STEP + 1


def test_d_step_losses(steps):
    base.check_metrics(steps["jm_d"], steps["pm_d"])


def test_d_step_gradients(steps):
    base.check_grads(steps["state2"].dis_opt_state, steps["d_port"].dis_opt, base.DIS_SIDE,
                     base.DIS_GRAD_SHARE)


def test_d_step_state(steps):
    s2 = steps["state2"]
    base.check_state(s2.params, s2.model_state, steps["d_port"], base.GEN_SIDE + base.DIS_SIDE)
    assert steps["d_port"].critic_step == int(s2.critic_step) == 2 * START_STEP + 2


@pytest.fixture(scope="module")
def translate_trainers():
    jcfg, pcfg = configs(moving_average_decay=0.5)
    return JaxTwinGANTrainer(jcfg), TwinGANTrainer(pcfg, device="cpu")


@pytest.mark.parametrize("direction", ["s2t", "t2s"])
def test_translate_matches_jax(steps, translate_trainers, direction):
    """``translate`` on the state after the G step (alpha 0.3): eval-mode
    statistics and the Polyak average's parameters."""
    jtrainer, ptrainer = translate_trainers
    s1 = steps["state1"]
    pstate = base._port_state(ptrainer, s1.params, s1.model_state, int(s1.step),
                              int(s1.critic_step))
    average = {k: jax.tree_util.tree_map(
        lambda v: np.asarray(v) * 0.9, base.randomize(s1.params[k], np.random.RandomState(9)))
        for k in (ENC, GEN)}
    pstate.gen_ema_params = dict(bridge.train_state_dict(average, {}, (ENC, GEN)))
    images = steps["images"][0]
    ref = np.asarray(jtrainer.translate(s1.replace(gen_ema_params=average),
                                        jnp.asarray(images), direction))
    out = ptrainer.translate(pstate, torch.from_numpy(images), direction)
    assert pstate.nets[ENC].training and pstate.nets[GEN].training  # modes restored
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TRANSLATE_ATOL)
    # The comparison sees the average and the alpha: the live parameters,
    # or step 0, move the output by far more than the tolerance.
    for step, ema in ((int(s1.step), None), (0, pstate.gen_ema_params)):
        other = base._port_state(ptrainer, s1.params, s1.model_state, step, 0)
        other.gen_ema_params = ema
        moved = ptrainer.translate(other, torch.from_numpy(images), direction).numpy()
        assert np.abs(moved - ref).max() > 10 * TRANSLATE_ATOL
