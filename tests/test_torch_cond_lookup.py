"""The port's numpy threefry2x32 (``utils/threefry.py``) against the JAX
PRNG, bit for bit.

``GanTrainer.cond_lookup``, the fixed label-embedding matrix of
conditional generation, is ``jax.random.uniform(PRNGKey(num_classes *
1000003 + conditional_embed_dim), (num_classes, conditional_embed_dim))``
in the JAX package, regenerated from the config and never checkpointed: a
JAX state bridged into the port trains against the same matrix only if
the port draws the same bits. These tests run under the installed JAX's
default ``jax_threefry_partitionable`` (True since JAX 0.5), the layout
the port reproduces.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainer as JaxGanTrainer  # noqa: E402
from twingan_tpu.train.gan_trainer import GanTrainerConfig as JaxGanTrainerConfig  # noqa: E402

from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.train.gan_trainer import GanTrainer, GanTrainerConfig  # noqa: E402
from twingan_tpu_torch.utils import threefry  # noqa: E402


def test_partitionable_threefry_is_the_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 7, 51 * 1000003 + 32, 2**31 - 1])
def test_prng_key_matches(seed):
    ref = tuple(int(v) for v in jax.random.key_data(jax.random.PRNGKey(seed)))
    assert threefry.prng_key(seed) == ref
    # A 64-bit seed splits into its high and low words.
    assert threefry.prng_key(2**33 + seed) == (2, seed)


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 4), (2, 3, 5), (1000,)])
def test_random_bits_match(shape):
    key = jax.random.PRNGKey(42)
    ref = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    np.testing.assert_array_equal(threefry.random_bits(threefry.prng_key(42), shape), ref)


@pytest.mark.parametrize("num_classes,dim", [(51, 32), (4, 8), (10, 3), (1, 1), (200, 64)])
def test_cond_lookup_is_bit_exact(num_classes, dim):
    """The port's GanTrainer draws the JAX GanTrainer's matrix exactly."""
    model = dict(resolution=8, max_channels=8, norm_type="none")
    jtrainer = JaxGanTrainer(JaxGanTrainerConfig(
        model=JaxPGGANConfig(**model), use_conditional_labels=True, num_classes=num_classes,
        conditional_embed_dim=dim))
    ptrainer = GanTrainer(GanTrainerConfig(
        model=PGGANConfig(**model), use_conditional_labels=True, num_classes=num_classes,
        conditional_embed_dim=dim), device="cpu")
    ref = np.asarray(jtrainer.cond_lookup)
    assert ref.shape == (num_classes, dim) and ptrainer.cond_lookup.dtype == torch.float32
    np.testing.assert_array_equal(ptrainer.cond_lookup.numpy(), ref)
    assert ptrainer.cfg.model.style_dim == num_classes == jtrainer.cfg.model.style_dim


def test_uniform_floor_and_range():
    u = threefry.uniform(threefry.prng_key(3), (4096,))
    assert u.dtype == np.float32 and u.min() >= 0.0 and u.max() < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
