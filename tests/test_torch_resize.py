"""The port's bilinear resize (``ops.basic.resize_bilinear``, and the
shrinking branch of ``data.preprocess.resize_bilinear``) against
``jax.image.resize``, and the conditioning image (``cond_image``) of the
generator and the discriminator against the Flax modules, in fp32 on the
CPU.

``jax.image.resize(..., "bilinear")`` antialiases when it shrinks: its
triangle kernel widens by 1 / scale, so each output averages every input
pixel under it. Shrinks and enlargements by 2x, 3x and non-integer
factors, square and not, are held within 1e-6 (the same fp32 weights,
contracted in another order). The modules run at 16 and 32 px with
max_channels 16, batch 2, on bridged weights with biases and moving
statistics drawn from a seed; the conditioning image has 2 channels at
the full resolution, so that every block shrinks it. Tolerance 1e-4
(about a dozen conv layers whose fp32 sums XLA and ATen take in other
orders), as in ``tests/test_torch_discriminator.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_twingan_step import _unoptimized_jax_reference  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_discriminator import _two_torch_threads, randomize  # noqa: E402,F401
from twingan_tpu.models import pggan as jpggan  # noqa: E402
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402

from twingan_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from twingan_tpu_torch.data import preprocess  # noqa: E402
from twingan_tpu_torch.models import pggan  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.ops import basic  # noqa: E402

RESIZE_TOL = 1e-6
MODULE_TOL = dict(rtol=1e-4, atol=1e-4)
COND_CHANNELS = 2


@pytest.mark.parametrize("shape,out", [
    ((8, 8), (4, 4)), ((12, 12), (4, 4)), ((10, 7), (4, 5)), ((16, 16), (5, 5)),
    ((4, 4), (8, 8)), ((3, 3), (9, 9)), ((5, 7), (13, 9)), ((7, 5), (3, 11)),
    ((6, 6), (6, 6)),
])
def test_resize_matches_jax(shape, out):
    x = np.random.RandomState(sum(shape + out)).rand(2, *shape, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *out, 3), "bilinear"))
    got = basic.resize_bilinear(torch.from_numpy(x), *out).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESIZE_TOL)


def test_resize_is_differentiable_and_keeps_the_dtype():
    x = torch.rand(1, 9, 9, 2, requires_grad=True)
    basic.resize_bilinear(x, 3, 3).sum().backward()
    # Each output pixel averages a 3x3 footprint (weights summing to 1).
    assert torch.allclose(x.grad.sum(), torch.tensor(9.0 * 2))
    assert basic.resize_bilinear(torch.rand(1, 8, 8, 1, dtype=torch.bfloat16), 4, 4).dtype \
        == torch.bfloat16


@pytest.mark.parametrize("hw,out", [(8, 4), (9, 3), (10, 4), (32, 24)])
def test_data_resize_shrinks_as_jax(hw, out):
    """The data pipeline's square resize: ``jax.image.resize`` to
    (out, out), as the JAX ``augment_batch`` calls it."""
    x = np.random.RandomState(hw).rand(2, hw, hw, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, out, out, 3), "bilinear"))
    got = preprocess.resize_bilinear(torch.from_numpy(x), out).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESIZE_TOL)


def _model_kw(res, **kw):
    return dict(resolution=res, max_channels=16, norm_type="batch_norm", equalized_lr=True,
                do_pixel_norm=True, **kw)


@pytest.mark.parametrize("fused_scale", [False, True])
@pytest.mark.parametrize("noise_input", [False, True])
def test_generator_cond_image_matches(noise_input, fused_scale):
    """The generator with a conditioning image: concatenated after
    block_4_conv0 and after each upsample (before the UNet skip, which
    this config has none of; with fused_scale the JAX package's fused up2
    + conv takes it as its auxiliary input, the port the plain up2 + conv),
    eval-mode batch norm."""
    res = 16
    kw = _model_kw(res, fused_scale=fused_scale)
    rs = np.random.RandomState(3)
    src = (rs.randn(2, 1, 1, PGGANConfig(**kw).noise_dim) if noise_input
           else rs.randn(2, 4, 4, 16)).astype(np.float32)
    cond = rs.rand(2, res, res, COND_CHANNELS).astype(np.float32)
    jgen = jpggan.Generator(JaxPGGANConfig(**kw))
    variables = jax.device_get(jax.jit(jgen.init)(jax.random.PRNGKey(0), jnp.asarray(src),
                                                  cond_image=jnp.asarray(cond)))
    params = randomize(variables["params"], rs)
    stats = {k: randomize(v, rs) for k, v in variables["batch_stats"].items()}
    stats = jax.tree_util.tree_map(lambda v: np.abs(v) + 0.5, stats)
    ref, _ = jgen.apply({"params": params, "batch_stats": stats}, jnp.asarray(src),
                        cond_image=jnp.asarray(cond))

    gen = pggan.Generator(PGGANConfig(**kw), noise_input=noise_input,
                          cond_image_channels=COND_CHANNELS)
    gen.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    with torch.no_grad():
        out = gen(torch.from_numpy(src), cond_image=torch.from_numpy(cond))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODULE_TOL)
    with pytest.raises(ValueError, match="cond_image"):
        gen(torch.from_numpy(src))


@pytest.mark.parametrize("growing", [False, True])
def test_discriminator_cond_image_matches(growing):
    """The discriminator with a conditioning image concatenated to its
    input (shrunk to it from twice its resolution), on a
    stable and a growing stage (alpha 0.3, where the shrunk path pools
    the concatenated channels too)."""
    res = 32
    kw = _model_kw(res, is_growing=growing, use_res_block=growing)
    rs = np.random.RandomState(4)
    x = rs.rand(2, res, res, 3).astype(np.float32)
    cond = rs.rand(2, 2 * res, 2 * res, COND_CHANNELS).astype(np.float32)
    jdis = jpggan.Discriminator(JaxPGGANConfig(**kw))
    variables = jax.device_get(jax.jit(jdis.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                                  cond_image=jnp.asarray(cond)))
    params = randomize(variables["params"], rs)
    ref, _ = jdis.apply({"params": params}, jnp.asarray(x), alpha=0.3,
                        cond_image=jnp.asarray(cond))

    dis = pggan.Discriminator(PGGANConfig(**kw), cond_image_channels=COND_CHANNELS)
    dis.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        out = dis(torch.from_numpy(x), alpha=0.3, cond_image=torch.from_numpy(cond))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODULE_TOL)
