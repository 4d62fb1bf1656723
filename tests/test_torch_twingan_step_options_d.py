"""TwinGANTrainer's D step with the style embedding, distillation and
gdrop, unfused (batch norm), against the JAX package's: the helpers and
tolerances of ``tests/test_torch_twingan_step_options.py``, in a file of
its own so that its JAX compilation runs on another test worker. The D
step starts from the seeded state at step 101 (gdrop strength 0.3), with
the JAX step's random style, gdrop draws for the real, prime and penalty
passes of each domain (``fold_in(k_gdrop, 4 b + i)``) and penalty draws
injected."""

import pytest

pytest.importorskip("torch")

from test_torch_twingan_step_options import _two_torch_threads, check_d_step, run_d_step  # noqa: E402,F401,E501


@pytest.fixture(scope="module")
def steps():
    return run_d_step("batch_norm", distillation_start_hw=16)


def test_d_step(steps):
    check_d_step(steps)
