"""The growing-stage TwinGAN G and D steps of
``test_torch_runner_twingan_growing.py`` at 64 px, where the cycle GAN
term is on: the same model, state, draws and checks, growing from 32 px at
alpha 0.3.

Losses, gradients, moving statistics and the D step's state are held to
that file's tolerances. The generator-side state after the G step is held
to 4e-5 against JAX's, not 1e-5, and the reason is measured here and by
``tools/twingan_step_rounding.py``:

- in float64 the two packages' G steps agree to 4.4e-16 on every
  post-step parameter, so they compute the same function;
- against that exact step, the port's float32 step lands 4.5e-6 away (held
  below 1e-5 here), and the JAX package's own float32 step 2.97e-5 away
  (an encoder batch-norm beta of ``from_rgb_32``, the fade-in branch);
- so two float32 steps may differ by up to 2.97e-5 + 4.5e-6 = 3.4e-5, and
  do by 2.67e-5. The tolerance is that sum, rounded up.

At 64 px on a stable stage both packages' float32 steps land 1.6e-5 to
1.8e-5 from the exact one, but in the same direction, 1.4e-6 apart.
A file of its own, so that its JAX compilation runs on another test
worker.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_runner_twingan_growing as growing  # noqa: E402
import test_torch_twingan_step as base  # noqa: E402
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501

sys.path.insert(0, os.path.join(base.REPO, "tools"))
import twingan_step_rounding as rounding  # noqa: E402

RES = 64
STATE_ATOL_64 = 4e-5


@pytest.fixture(scope="module")
def steps():
    return growing.run_steps(RES)


def test_g_step_losses(steps):
    assert steps["pm_g"]["alpha"] == pytest.approx(0.3)
    base.check_metrics(steps["jm_g"], steps["pm_g"])


def test_g_step_gradients(steps):
    base.check_grads(steps["state1"].gen_opt_state, steps["g_port"].gen_opt, base.GEN_SIDE,
                     base.GEN_GRAD_SHARE)


def test_g_step_state(steps):
    s1 = steps["state1"]
    base.check_state(s1.params, s1.model_state, steps["g_port"], base.GEN_SIDE,
                     atol=STATE_ATOL_64)
    assert steps["g_port"].step == int(s1.step) == growing.START_STEP + 1


def test_g_step_float32_rounding(steps):
    """The port's float32 G step within 1e-5 of its float64 one (the exact
    step: JAX's float64 step agrees to 4.4e-16, see the tool), and the JAX
    float32 step beyond 1e-5 of it, within STATE_ATOL_64."""
    exact = rounding.port_g_step(steps["pcfg"], steps["params0"], steps["model_state0"],
                                 steps["batch_g"], growing.START_STEP, float64=True)
    port = {k: v.double().numpy() for k, v in steps["g_port"].nets.state_dict().items()
            if k in exact}
    s1 = steps["state1"]
    jax32 = {k: v.numpy().astype(np.float64) for k, v in base.bridge.train_state_dict(
        s1.params, s1.model_state, base.GEN_SIDE).items()}
    assert port.keys() == exact.keys() == jax32.keys()
    assert rounding.largest_gap(port, exact)[0] <= base.STATE_ATOL
    assert base.STATE_ATOL < rounding.largest_gap(jax32, exact)[0] <= STATE_ATOL_64
    assert torch.get_default_dtype() == torch.float32  # the float64 run leaves nothing behind


def test_d_step_losses(steps):
    base.check_metrics(steps["jm_d"], steps["pm_d"])


def test_d_step_gradients(steps):
    base.check_grads(steps["state2"].dis_opt_state, steps["d_port"].dis_opt, base.DIS_SIDE,
                     base.DIS_GRAD_SHARE)


def test_d_step_state(steps):
    s2 = steps["state2"]
    base.check_state(s2.params, s2.model_state, steps["d_port"], base.GEN_SIDE + base.DIS_SIDE)
    assert steps["d_port"].critic_step == int(s2.critic_step) == 2 * growing.START_STEP + 2
