"""The port's Discriminator against the Flax one, on bridged weights.

32 px and 64 px, self-attention at 16 px (sa_gamma 0.7), a stable and a
growing stage (alpha 0.3), minibatch-stddev groups 1 and 3, batch 6, fp32;
conv kernels as Flax draws them, biases drawn from a seed so none is zero.
Tolerance rtol 1e-4 / atol 1e-4: about 15 conv layers and an N-term
softmax average whose fp32 sums XLA and ATen take in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.models import pggan as jpggan  # noqa: E402
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402

from twingan_tpu_torch.bridge import flax_from_state_dict, state_dict_from_flax  # noqa: E402
from twingan_tpu_torch.models import pggan  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.ops import attention  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the tier-1 run puts six test workers on the
    machine's cores, and PyTorch's default of one spinning thread per core
    in each of them starves the others (this module's CPU steps ran 100
    times slower in the full run than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(v, rng)
        elif k == "sa_gamma":
            out[k] = np.full(v.shape, 0.7, np.float32)
        elif k == "bias":
            out[k] = rng.normal(0.0, 0.3, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}.") if hasattr(v, "items") else {prefix + k: v})
    return out


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("growing", [False, True])
@pytest.mark.parametrize("res", [32, 64])
def test_discriminator_matches(res, growing, groups):
    kw = dict(resolution=res, max_channels=16, equalized_lr=True, do_self_attention=True,
              self_attention_hw=16, is_growing=growing, use_res_block=growing)
    jdis = jpggan.Discriminator(JaxPGGANConfig(**kw))
    x = np.random.RandomState(res + groups).rand(6, res, res, 3).astype(np.float32)
    variables = jax.device_get(jax.jit(jdis.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    assert set(variables) == {"params"}  # no norms: no batch_stats
    params = randomize(variables["params"], np.random.RandomState(1))
    pred, _ = jax.jit(lambda p, x_: jdis.apply({"params": p}, x_, alpha=0.3, train=True,
                                               stddev_groups=groups))(params, jnp.asarray(x))

    dis = pggan.Discriminator(PGGANConfig(**kw))
    dis.load_state_dict(state_dict_from_flax(params), strict=True)
    attention.reset_launch_counts()
    with torch.no_grad():
        out = dis(torch.from_numpy(x), alpha=0.3, stddev_groups=groups)
        plain = dis(torch.from_numpy(x), alpha=0.3, stddev_groups=groups, attention="plain")
    assert out.shape == (6, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(pred), **TOL)
    np.testing.assert_array_equal(plain.numpy(), out.numpy())
    assert attention.launch_counts[attention.PLAIN_ROUTE] == 1
    # The bridge covers every leaf, both ways.
    back, stats = flax_from_state_dict(dis.state_dict())
    assert stats == {}
    assert _leaves(back).keys() == _leaves(params).keys()
    for k, v in _leaves(params).items():
        np.testing.assert_array_equal(_leaves(back)[k], v)


def test_discriminator_casts_to_the_config_dtype():
    cfg = PGGANConfig(resolution=8, max_channels=8, dtype="bfloat16")
    out = pggan.Discriminator(cfg)(torch.rand(2, 8, 8, 3))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 1)
    with pytest.raises(ValueError, match="8 px"):
        pggan.Discriminator(cfg)(torch.rand(2, 16, 16, 3))


@pytest.mark.parametrize("kw,call_kw,name", [
    ({}, {"cond_embed": torch.zeros(2, 4)}, "conditional"),
    ({}, {"cond_image": torch.zeros(2, 8, 8, 1)}, "conditional"),
    ({"quantized_inference": "int8"}, {}, "quantized_inference"),
])
def test_discriminator_refuses_unported_options(kw, call_kw, name):
    cfg = PGGANConfig(resolution=8, max_channels=8, **kw)
    with pytest.raises(NotImplementedError, match=name):
        pggan.Discriminator(cfg)(torch.rand(2, 8, 8, 3), **call_kw)
    with pytest.raises(NotImplementedError, match="gdrop"):
        pggan.Discriminator(PGGANConfig(resolution=8, max_channels=8), do_gdrop=True)
