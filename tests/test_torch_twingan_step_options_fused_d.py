"""TwinGANTrainer's D step with the style embedding, distillation (from
64 px: off at 32 px) and gdrop on the fused passes (instance norm: one
discriminator pass over [real; prime] per domain, one gdrop draw for it),
against the JAX package's, with the helpers and tolerances of
``tests/test_torch_twingan_step_options.py``; then ``translate`` of the
stepped state with the style encoder's style and with a given one."""

import pytest

pytest.importorskip("torch")

from test_torch_twingan_step_options import (  # noqa: E402,F401
    _two_torch_threads,
    check_d_step,
    check_translate,
    run_d_step,
)


@pytest.fixture(scope="module")
def steps():
    return run_d_step("instance_norm", distillation_start_hw=64)


def test_d_step(steps):
    check_d_step(steps)


def test_translate_with_the_style_encoder(steps):
    check_translate(steps)
