"""The classifier zoo against the JAX package's, on the CPU: the largest
nets with VALID fully connected convs, at the exact sizes those need
(batch 1): overfeat, vgg_16, vgg_19 (alexnet_v2 and vgg_a are in
``test_torch_zoo_small.py``).

Each network's eval-mode logits and end points (fp32) and one train-mode
forward (float64 where it has batch norm: logits and updated statistics),
with the same JAX-drawn weights bridged; the tolerances and why are in
``tests/torch_classifier_parity.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_classifier_parity as parity  # noqa: E402
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

SIZES = dict(overfeat=(231, 1), vgg_16=(224, 1), vgg_19=(224, 1))
CACHE = parity.PairCache(SIZES)


@pytest.mark.parametrize("name,mode", parity.cases(SIZES))
def test_network_matches_jax(name, mode):
    parity.run_case(CACHE, name, mode)
