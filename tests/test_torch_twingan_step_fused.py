"""The checks of ``test_torch_twingan_step.py`` on the fused path: instance
norm, where ``TwinGANConfig.fuse`` concatenates the four generator passes
into one per output domain and the discriminator's real/prime/cycle passes
into one per domain with aligned minibatch-stddev groups. Same model,
inputs, noise and tolerances; a file of its own so that its JAX
compilation runs on another test worker.
"""

import pytest

torch = pytest.importorskip("torch")

import test_torch_twingan_step as base  # noqa: E402
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401


@pytest.fixture(scope="module")
def steps():
    return base.run_steps("instance_norm")


def test_g_step_losses(steps):
    base.check_metrics(steps["jm_g"], steps["pm_g"])


def test_g_step_gradients(steps):
    base.check_grads(steps["state1"].gen_opt_state, steps["g_port"].gen_opt, base.GEN_SIDE,
                     base.GEN_GRAD_SHARE)


def test_g_step_state(steps):
    base.check_g_state(steps)


def test_d_step_losses(steps):
    base.check_metrics(steps["jm_d"], steps["pm_d"])


def test_d_step_gradients(steps):
    base.check_grads(steps["state2"].dis_opt_state, steps["d_port"].dis_opt, base.DIS_SIDE,
                     base.DIS_GRAD_SHARE)


def test_d_step_state(steps):
    base.check_d_state(steps)


def test_generator_gradient_rounding_sensitivity(steps):
    base.check_rounding_sensitivity(steps)
