"""TwinGANTrainer's G step with the style embedding, distillation and
gdrop on the fused passes (instance norm), against the JAX package's: the
helpers and tolerances of ``tests/test_torch_twingan_step_options.py``.
Fused, each output domain's generator pass takes the concatenated
(random style, own style) and each discriminator one gdrop draw for its
concatenated batch, as the JAX step lays them out. Distillation starts at
64 px here, above the 32 px stage: its heads and losses do not run."""

import pytest

pytest.importorskip("torch")

from test_torch_twingan_step_options import _two_torch_threads, check_g_step, run_g_step  # noqa: E402,F401,E501


@pytest.fixture(scope="module")
def steps():
    return run_g_step("instance_norm", distillation_start_hw=64)


def test_g_step(steps):
    check_g_step(steps, distilled=False)
