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

from test_torch_twingan_step import _unoptimized_jax_reference  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen as nn  # noqa: E402

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
    """quantized_inference raises, as inference-only. The conditional
    inputs and gdrop are ported (``test_discriminator_gdrop_and_cond_embed_
    match``): a discriminator built without an input refuses it, and one
    built with gdrop takes its noise from the caller in train mode."""
    cfg = PGGANConfig(resolution=8, max_channels=8)
    if name == "conditional":
        with pytest.raises(ValueError, match="width 0"):
            pggan.Discriminator(cfg)(torch.rand(2, 8, 8, 3), **call_kw)
    else:
        with pytest.raises(ValueError, match=f"{name}.*inference-only"):
            pggan.Discriminator(cfg.replace(**kw))
    dis = pggan.Discriminator(cfg, do_gdrop=True).train()
    with pytest.raises(ValueError, match="gdrop_noise"):
        dis(torch.rand(2, 8, 8, 3))
    with torch.no_grad():  # eval mode: no gdrop, no noise needed
        assert dis.eval()(torch.rand(2, 8, 8, 3)).shape == (2, 1)


class _GdropKeys(nn.Module):
    """The keys the Flax discriminator's ``maybe_gdrop`` draws with: the
    i-th ``make_rng("gdrop")`` of the root scope folded with i."""

    n: int

    @nn.compact
    def __call__(self):
        return [jax.random.fold_in(self.make_rng("gdrop"), i) for i in range(self.n)]


def jax_gdrop_noise(key, shapes):
    """The JAX discriminator's gdrop draws under rng ``key`` for the sites
    of ``shapes`` ([B, C] each, ``Discriminator.gdrop_shapes``), as the
    [B, C] tensors the port's ``gdrop_noise`` takes (fp32)."""
    keys = _GdropKeys(len(shapes)).apply({}, rngs={"gdrop": key})
    return [torch.tensor(np.asarray(jax.random.normal(k, (b, 1, 1, c), jnp.float32))
                         .reshape(b, c)) for k, (b, c) in zip(keys, shapes)]


@pytest.mark.parametrize("growing", [False, True])
def test_discriminator_gdrop_and_cond_embed_match(growing):
    """gdrop (strength 0.3) on the inputs of every block's convs and the two
    before_fc convs, with the Flax module's own draws injected, and a
    label embedding concatenated at 4x4 before the minibatch stddev;
    self-attention at 16 px, batch 6 in 3 stddev groups."""
    res, dim, strength = 32, 5, 0.3
    kw = dict(resolution=res, max_channels=16, equalized_lr=True, do_self_attention=True,
              self_attention_hw=16, is_growing=growing, use_res_block=growing)
    rs = np.random.RandomState(7)
    x = rs.rand(6, res, res, 3).astype(np.float32)
    embed = rs.randn(6, dim).astype(np.float32)
    jdis = jpggan.Discriminator(JaxPGGANConfig(**kw), do_gdrop=True)
    key = jax.random.PRNGKey(11)
    variables = jax.device_get(jax.jit(
        lambda k: jdis.init({"params": k, "gdrop": key}, jnp.asarray(x),
                            cond_embed=jnp.asarray(embed)))(jax.random.PRNGKey(0)))
    params = randomize(variables["params"], rs)
    ref, _ = jdis.apply({"params": params}, jnp.asarray(x), alpha=0.3, train=True,
                        gdrop_strength=strength, cond_embed=jnp.asarray(embed),
                        stddev_groups=3, rngs={"gdrop": key})
    plain, _ = jdis.apply({"params": params}, jnp.asarray(x), alpha=0.3,
                          cond_embed=jnp.asarray(embed), stddev_groups=3)

    dis = pggan.Discriminator(PGGANConfig(**kw), do_gdrop=True, cond_embed_dim=dim)
    dis.load_state_dict(state_dict_from_flax(params), strict=True)
    noise = jax_gdrop_noise(key, dis.gdrop_shapes(6))
    assert len(noise) == 2 * 3 + 2
    with torch.no_grad():
        out = dis.train()(torch.from_numpy(x), alpha=0.3, gdrop_strength=strength,
                          gdrop_noise=noise, cond_embed=torch.from_numpy(embed),
                          stddev_groups=3)
        off = dis.eval()(torch.from_numpy(x), alpha=0.3, cond_embed=torch.from_numpy(embed),
                         stddev_groups=3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(off.numpy(), np.asarray(plain), **TOL)
    assert np.abs(np.asarray(ref) - np.asarray(plain)).max() > 100 * TOL["atol"]
