"""The classifier zoo against the JAX package's, on the CPU: inception_v4
and inception_resnet_v2 at 75 px.

Each network's eval-mode logits and end points (fp32) and one train-mode
forward (float64 where it has batch norm: logits and updated statistics),
with the same JAX-drawn weights bridged; the tolerances and why are in
``tests/torch_classifier_parity.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_classifier_parity as parity  # noqa: E402
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

SIZES = dict(inception_v4=(75, 2), inception_resnet_v2=(75, 2))
CACHE = parity.PairCache(SIZES)


@pytest.mark.parametrize("name,mode", parity.cases(SIZES))
def test_network_matches_jax(name, mode):
    parity.run_case(CACHE, name, mode)
