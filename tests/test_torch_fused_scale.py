"""``fused_scale`` in the port against the JAX package's three forms of the
generator's nearest-up2 + conv3x3, in fp32 on the CPU.

The JAX generator with ``fused_scale`` computes every block's conv0 on the
upsampled input through ``ops/fused_scale.up2_conv`` (``dilated`` or
``parity``), or, without it, through the plain upsample and conv; the port
runs the plain route for all three, since they are one function. Each case
holds the port's generator with ``fused_scale=True`` against the JAX
generator in one form, on the same bridged weights (norm banks and moving
statistics drawn from a seed, eq-lr, pixel norm, batch norm in eval mode,
16 px, max_channels 8, batch 2): the output, and the gradients of a seeded
projection of it with respect to every parameter and to the input code,
as ``tests/test_fused_scale.py`` holds the JAX forms to each other. With
UNet skips (the skip channels enter conv0 beside the upsampled input), and
with ``use_res_block``, where the JAX package keeps the unfused route.
Tolerance: outputs rtol 1e-4 / atol 1e-4 (as ``tests/test_torch_pggan.py``:
about 20 layers whose fp32 sums are taken in other orders); gradients 1e-4
of each tensor's largest magnitude.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.models import pggan as jpggan  # noqa: E402
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models import pggan  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402

RES = 16
BASE = dict(resolution=RES, max_channels=8, norm_type="batch_norm", equalized_lr=True,
            do_pixel_norm=True, num_domains=2)
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_SHARE = 1e-4


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(v, rng)
        elif k.startswith(("gamma_", "moving_var_")):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.startswith(("beta_", "moving_mean_", "bias")):
            out[k] = rng.normal(0.0, 0.3, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.mark.parametrize("impl,unet,res_block", [
    ("dilated", True, False),
    ("parity", True, False),
    (None, True, False),
    ("dilated", False, False),
    ("parity", False, True),
])
def test_fused_scale_generator_matches(impl, unet, res_block):
    kw = dict(BASE, use_res_block=res_block)
    jkw = dict(kw, fused_scale=impl is not None, fused_scale_impl=impl or "dilated")
    jcfg = JaxPGGANConfig(**jkw)
    rng = np.random.RandomState(0)
    x = rng.rand(2, RES, RES, 3).astype(np.float32)
    jenc, jgen = jpggan.Encoder(jcfg), jpggan.Generator(jcfg)
    enc_vars = jax.device_get(jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    enc_vars = {k: randomize(v, rng) for k, v in enc_vars.items()}
    code, skips = jax.jit(lambda v, x_: jenc.apply(v, x_, domain=0))(enc_vars, jnp.asarray(x))
    skips = skips if unet else None
    gen_vars = jax.device_get(jax.jit(
        lambda k, c, s: jgen.init(k, c, unet_skips=s))(jax.random.PRNGKey(1), code, skips))
    gen_vars = {k: randomize(v, rng) for k, v in gen_vars.items()}
    params, stats = gen_vars["params"], gen_vars["batch_stats"]
    t = rng.randn(2, RES, RES, 3).astype(np.float32)

    def loss(p, c):
        out, _ = jgen.apply({"params": p, "batch_stats": stats}, c, domain=1,
                            unet_skips=skips)
        return jnp.sum(out * jnp.asarray(t)), out

    (_, ref), (g_params, g_code) = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(
        params, code)

    gen = pggan.Generator(PGGANConfig(**dict(kw, fused_scale=True)), unet=unet)
    gen.load_state_dict(bridge.state_dict_from_flax(params, stats), strict=True)
    pcode = torch.tensor(np.asarray(code), requires_grad=True)
    pskips = None
    if unet:
        pskips = pggan.EncoderSkips(
            blocks={hw: torch.tensor(np.asarray(v)) for hw, v in skips.blocks.items()},
            interp={hw: torch.tensor(np.asarray(v)) for hw, v in skips.interp.items()})
    out = gen(pcode, domain=1, unet_skips=pskips)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    named = dict(gen.named_parameters())
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(t)),
                                [pcode] + list(named.values()), allow_unused=True)
    ref_grads = {"code": np.asarray(g_code), **{k: v.numpy() for k, v in
                                                 bridge.state_dict_from_flax(
                                                     jax.device_get(g_params)).items()}}
    for name, g in zip(["code"] + list(named), grads):
        # The other domain's norm bank takes no part: zero on both sides.
        g = np.zeros_like(ref_grads[name]) if g is None else g.numpy()
        scale = float(np.abs(ref_grads[name]).max())
        np.testing.assert_allclose(g, ref_grads[name], rtol=0, atol=GRAD_SHARE * scale,
                                   err_msg=name)
    assert float(np.abs(ref_grads["block_16_conv0.conv.kernel"]).max()) > 0
