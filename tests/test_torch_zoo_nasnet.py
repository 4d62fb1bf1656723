"""NASNet against the JAX package's, on the CPU: nasnet_mobile at 80 px
(the least size at which the auxiliary head exists: its 5x5/3 pool needs a
5 px map before the second reduction), eval and train mode as the rest of
the zoo (``tests/torch_classifier_parity.py``), the train-mode forward at
``progress=0``; and drop path, on nasnet_large (keep 0.7) with the port's
own weights:

- at ``progress=0`` every keep probability is 1, so a train-mode forward is
  the same whatever generator draws;
- at ``progress=1`` two generators drop other branches (other logits), one
  generator seed gives the same logits twice, and each cell's keep
  probability follows the JAX schedule.

nasnet_large against JAX is ``test_torch_zoo_nasnet_large.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch_classifier_parity as parity  # noqa: E402
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

from twingan_tpu.models import nasnet as jnasnet  # noqa: E402

from twingan_tpu_torch.models.classifiers import get_network_fn, reset_parameters  # noqa: E402

SIZES = dict(nasnet_mobile=(80, 2))
CACHE = parity.PairCache(SIZES)


@pytest.mark.parametrize("name,mode", parity.cases(SIZES))
def test_network_matches_jax(name, mode):
    kw = {"progress": 0.0, "generator": torch.Generator().manual_seed(3)} if mode == "train" else {}
    errs = parity.run_case(CACHE, name, mode, **kw)
    if mode == "eval":
        assert "AuxLogits" in errs


def _train_logits(net, x, progress, seed):
    with torch.no_grad():
        return net.train()(torch.from_numpy(x), progress=progress,
                           generator=torch.Generator().manual_seed(seed))[0].numpy()


def test_drop_path_ramp_and_generators():
    net = reset_parameters(get_network_fn("nasnet_large", 10, image_hw=64),
                           torch.Generator().manual_seed(0))
    x = parity.images(4, 64)
    np.testing.assert_array_equal(_train_logits(net, x, 0.0, 1), _train_logits(net, x, 0.0, 2))
    a, b = _train_logits(net, x, 1.0, 1), _train_logits(net, x, 1.0, 2)
    assert parity.rel_err(a, b) > 1e-3
    np.testing.assert_array_equal(a, _train_logits(net, x, 1.0, 1))
    jnet = jnasnet.NASNet(num_cells=18, initial_filters=168, stem_filters=96,
                          drop_path_keep_prob=0.7)
    for cell in (0, 5, 21):
        for progress in (0.0, 0.3, 1.0):
            ours = float(net.cell_keep_prob(cell, progress))
            theirs = float(jnet._cell_keep_prob(cell, jnp.float32(progress)))
            assert ours == pytest.approx(theirs, abs=1e-7)
    with pytest.raises(ValueError, match="generator"):
        net.train()(torch.from_numpy(x))
