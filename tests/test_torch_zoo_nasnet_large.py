"""nasnet_large (88M parameters) against the JAX package's, on the CPU, at
64 px: eval mode as the rest of the zoo (``tests/torch_classifier_parity.
py``), and the train-mode forward at ``progress=0`` in float64 against the
JAX network built with drop path off: at progress 0 every keep probability
is 1, so drop path is the identity (``test_torch_zoo_nasnet.py`` shows it
for the port), and the JAX side then compiles no random draws, which halves
its float64 compile.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_classifier_parity as parity  # noqa: E402
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

from twingan_tpu.models.nasnet import NASNet as JaxNASNet  # noqa: E402

SIZES = dict(nasnet_large=(64, 2))
CACHE = parity.PairCache(SIZES)


def test_eval_matches_jax():
    parity.run_case(CACHE, "nasnet_large", "eval")


def test_train_forward_at_progress_0_matches_jax():
    _, variables, tnet = CACHE.get("nasnet_large")
    jnet = JaxNASNet(num_classes=parity.NUM_CLASSES, num_cells=18, initial_filters=168,
                     stem_filters=96, drop_path_keep_prob=1.0)
    parity.check_train(jnet, variables, tnet, parity.images(2, 64), progress=0.0,
                       generator=torch.Generator().manual_seed(3))
