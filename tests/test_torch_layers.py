"""The port's layers against the Flax layers of twingan_tpu, on bridged
weights.

Each Flax layer is initialized by JAX, its norm banks, moving statistics
and ``sa_gamma`` are set to seeded random values (so none is an identity),
and the tree goes through ``bridge.state_dict_from_flax`` into the port's
layer. Inputs are NHWC numpy arrays from a seed; the port's layers compute
in NCHW. Tolerance rtol 1e-5 / atol 1e-5 in fp32 (one conv or norm);
rtol 1e-4 / atol 1e-4 for self-attention, which adds an N-term softmax
average to three convs and norms.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.models import layers as jlayers  # noqa: E402
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402

from twingan_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from twingan_tpu_torch.models import layers  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402


def randomize(tree, rng):
    """Seeded values for every norm/attention leaf (conv kernels kept)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(v, rng)
        elif k == "sa_gamma":
            out[k] = np.full(v.shape, 0.7, np.float32)
        elif k.startswith(("gamma_", "moving_var_")):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.startswith(("beta_", "moving_mean_", "bias")):
            out[k] = rng.normal(0.0, 0.3, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def run_both(jmodule, pmodule, x, *jargs, pcall=None, **jkw):
    """Init ``jmodule`` on x, randomize, bridge into ``pmodule``; return
    (jax output, port output) as NHWC numpy arrays."""
    variables = jax.device_get(jax.jit(lambda k, x_: jmodule.init(k, x_, *jargs, **jkw))(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.RandomState(1)
    params = randomize(variables.get("params", {}), rng)
    stats = randomize(variables.get("batch_stats", {}), rng)
    ref = jax.jit(lambda v, x_: jmodule.apply(v, x_, *jargs, **jkw))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    pmodule.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    pmodule.eval()
    with torch.no_grad():
        out = (pcall or pmodule)(torch.from_numpy(x).permute(0, 3, 1, 2))
    return np.asarray(ref), out.permute(0, 2, 3, 1).numpy()


def _x(c, hw=8, seed=0):
    return np.random.RandomState(seed).randn(2, hw, hw, c).astype(np.float32)


@pytest.mark.parametrize("k,padding,eq_lr,use_bias", [
    (1, "SAME", True, True),
    (3, "SAME", True, False),
    (3, "SAME", False, True),
    (4, "VALID", True, False),
    (4, "SAME", True, True),   # even kernel: TF SAME pads 1 before, 2 after
    (2, "SAME", False, True),
    (7, "SAME", True, False),
])
def test_eqconv(k, padding, eq_lr, use_bias):
    x = _x(5)
    j = jlayers.EqConv(features=6, kernel_size=k, padding=padding, use_bias=use_bias,
                       equalized_lr=eq_lr)
    p = layers.EqConv(5, 6, k, padding, use_bias=use_bias, equalized_lr=eq_lr)
    ref, out = run_both(j, p, x)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["batch_norm", "instance_norm", "none"])
@pytest.mark.parametrize("domain", [0, 1])
def test_domain_norm(kind, domain):
    x = _x(6) * 2 + 0.5
    j = jlayers.DomainNorm(kind=kind, num_domains=2)
    p = layers.DomainNorm(kind, 6, num_domains=2)
    ref, out = run_both(j, p, x, jlayers.NormCtx(domain=domain),
                        pcall=lambda t: p(t, domain))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_domain_norm_train_mode_raises():
    """Train mode takes batch moments per bn_num_groups group, and raises on
    a batch the groups cannot split; without update=True it leaves the
    moving statistics alone (tests/test_torch_train_ops.py holds it
    against the Flax layer)."""
    p = layers.DomainNorm("batch_norm", 4, 2, num_groups=2).train()
    with pytest.raises(ValueError, match="bn_num_groups"):
        p(torch.zeros(3, 4, 2, 2), 0)
    p(torch.randn(4, 4, 2, 2), 0)
    assert torch.equal(p.moving_mean_0, torch.zeros(4))
    assert torch.equal(p.moving_var_0, torch.ones(4))


@pytest.mark.parametrize("norm_type,activation,k", [
    ("batch_norm", "leaky", 3), ("instance_norm", "tanh", 1), ("batch_norm", None, 1)])
def test_conv_block(norm_type, activation, k):
    jcfg = JaxPGGANConfig(norm_type=norm_type, equalized_lr=True, num_domains=2)
    pcfg = PGGANConfig(norm_type=norm_type, equalized_lr=True, num_domains=2)
    x = _x(5)
    j = jlayers.ConvBlock(jcfg, 7, kernel_size=k, activation=activation)
    p = layers.ConvBlock(pcfg, 5, 7, kernel_size=k, activation=activation)
    ref, out = run_both(j, p, x, jlayers.NormCtx(domain=1), pcall=lambda t: p(t, 1))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("in_ch", [4, 6])
def test_res_block_add(in_ch):
    """Identity shortcut when channels match, 1x1 conv (with bias) when not."""
    jcfg = JaxPGGANConfig(use_res_block=True, equalized_lr=True, num_domains=2)
    pcfg = PGGANConfig(use_res_block=True, equalized_lr=True, num_domains=2)
    x = _x(in_ch)
    y = np.random.RandomState(9).randn(2, 8, 8, 4).astype(np.float32)
    j = jlayers.ResBlockAdd(jcfg, 4)
    p = layers.ResBlockAdd(pcfg, in_ch, 4)
    ref, out = run_both(j, p, x, jnp.asarray(y), jlayers.NormCtx(),
                        pcall=lambda t: p(t, torch.from_numpy(y).permute(0, 3, 1, 2), 0))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert (p.shortcut is None) == (in_ch == 4)


@pytest.mark.parametrize("norm_type,channels,domain", [
    ("batch_norm", 16, 0), ("instance_norm", 64, 1), ("batch_norm", 8, 1)])
def test_self_attention(norm_type, channels, domain):
    jcfg = JaxPGGANConfig(norm_type=norm_type, equalized_lr=True, num_domains=2)
    pcfg = PGGANConfig(norm_type=norm_type, equalized_lr=True, num_domains=2)
    x = _x(channels, hw=8, seed=channels)
    j = jlayers.SelfAttention(jcfg)
    p = layers.SelfAttention(pcfg, channels)
    ref, out = run_both(j, p, x, jlayers.NormCtx(domain=domain), pcall=lambda t: p(t, domain))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    # sa_gamma != 0, so the attention term is really in the output.
    assert np.abs(out - x).max() > 0.1
