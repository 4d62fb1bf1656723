"""The checks of ``test_torch_gan_trainer.py`` on a growing stage: 8 -> 16
px at global step 3 of max_steps 10, so alpha 0.3 blends the new
resolution's output with the upsampled to_rgb of the last one and the real
images with their low-resolution selves (``growing_image``). Same model
widths, draws and tolerances; a file of its own so that its JAX
compilation runs on another test worker.
"""

import pytest

torch = pytest.importorskip("torch")

import test_torch_gan_trainer as base  # noqa: E402
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

from twingan_tpu_torch.ops import fused_conv  # noqa: E402


@pytest.fixture(scope="module")
def steps():
    return base.run_steps(res=16, growing=True, step=3)


def test_alpha(steps):
    assert float(steps["jm_g"]["alpha"]) == pytest.approx(0.3)
    assert steps["pm_g"]["alpha"] == pytest.approx(0.3)


def test_g_step_losses(steps):
    base.check_metrics(steps["jm_g"], steps["pm_g"])


def test_g_step_gradients_and_state(steps):
    base.check_g_step(steps)


def test_d_step_losses(steps):
    base.check_metrics(steps["jm_d"], steps["pm_d"])


def test_d_step_gradients_and_state(steps):
    base.check_d_step(steps)


def test_sample(steps):
    base.check_sample(steps)


def test_routes_per_step(steps):
    """5 fusable steps at 16 px (block_4_conv1, conv0 and conv1 at 8 and
    16 px): the autograd route in the G step, none in the D step."""
    assert steps["g_routes"] == {fused_conv.KERNEL_NAME: 0, fused_conv.AUTOGRAD_ROUTE: 5}
    assert steps["d_routes"] == {fused_conv.KERNEL_NAME: 0, fused_conv.AUTOGRAD_ROUTE: 0}
