"""The classifier zoo against the JAX package's, on the CPU: resnet_v1_101
and resnet_v2_101 at 64 px.

Each network's eval-mode logits and end points (fp32) and one train-mode
forward (float64 where it has batch norm: logits and updated statistics),
with the same JAX-drawn weights bridged; the tolerances and why are in
``tests/torch_classifier_parity.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_classifier_parity as parity  # noqa: E402
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

SIZES = dict(resnet_v1_101=(64, 2), resnet_v2_101=(64, 2))
CACHE = parity.PairCache(SIZES)


@pytest.mark.parametrize("name,mode", parity.cases(SIZES))
def test_network_matches_jax(name, mode):
    parity.run_case(CACHE, name, mode)
