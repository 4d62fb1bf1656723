"""The style and distillation heads of the port (``EncoderClassifier``,
``StyleEncoder``) and ``gdrop`` against the JAX package's, in fp32 on the
CPU.

The heads run at 16 px with max_channels 8 and batch 2, on bridged weights
whose norm banks and statistics are drawn from a seed: in eval mode, and
in train mode with an updating pass (the state after it compared too),
under batch renorm with the clip of step 10001, with spectral norm outside
the discriminator (every conv and the prediction), and, for the classifier,
with conditional norms from a style vector. ``gdrop`` takes the JAX
package's own normal draw as its noise. Inputs come from numpy seeds.
Tolerance 1e-6 of the largest magnitude (``close``) for ``gdrop`` and the
classifier's three layers; 1e-5 for ``StyleEncoder``'s encoder body and
head (a dozen layers whose fp32 sums XLA and ATen take in other orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_twingan_step import _two_torch_threads, _unoptimized_jax_reference  # noqa: E402,F401,E501

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu import ops as jops  # noqa: E402
from twingan_tpu.models import pggan as jpggan  # noqa: E402
from twingan_tpu.models.config import PGGANConfig as JaxPGGANConfig  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models import pggan  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.ops import basic, norms  # noqa: E402

HEAD_TOL = 1e-6
BODY_TOL = 1e-5
OUT_DIM = 5
STYLE_DIM = 4
KW = dict(resolution=16, max_channels=8, num_domains=2, norm_type="batch_renorm",
          do_pixel_norm=True, spectral_norm=True, spectral_norm_in_non_discriminator=True)
STEP = 10001


def close(got, ref, tol, msg=""):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * scale, err_msg=msg)


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(v, rng)
        elif k.startswith(("gamma_", "moving_var_")):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.startswith(("beta_", "moving_mean_", "bias", "renorm_mean_")) and "weight" not in k:
            out[k] = rng.normal(0.0, 0.3, v.shape).astype(np.float32)
        elif k.startswith("renorm_stddev_") and "weight" not in k:
            out[k] = rng.uniform(0.3, 2.0, v.shape).astype(np.float32)
        elif k.startswith("renorm_") and "weight" in k:
            out[k] = np.asarray(rng.uniform(0.5, 0.9), np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _variables(jmod, rng, *args, **kw):
    variables = jax.device_get(jax.jit(lambda k: jmod.init(k, *args, **kw))(
        jax.random.PRNGKey(0)))
    return {k: (v if k == "spectral" else randomize(v, rng)) for k, v in variables.items()}


def _load(pmod, variables):
    pmod.load_state_dict(bridge.state_dict_from_flax(
        variables["params"], variables.get("batch_stats"),
        spectral=variables.get("spectral")), strict=True)


def _compare_state(pmod, new_vars, tol):
    ref = bridge.state_dict_from_flax({}, new_vars.get("batch_stats"),
                                      spectral=new_vars.get("spectral"))
    got = pmod.state_dict()
    assert ref and set(ref) <= set(got)
    for k, v in ref.items():
        close(got[k].numpy(), v.numpy(), tol, k)


@pytest.mark.parametrize("conditional", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_encoder_classifier_matches(conditional, train):
    kw = dict(KW, style_dim=STYLE_DIM if conditional else 0)
    rng = np.random.RandomState(1 + conditional)
    code = rng.randn(2, 4, 4, 8).astype(np.float32)
    style = rng.randn(2, STYLE_DIM).astype(np.float32) if conditional else None
    jstyle = None if style is None else jnp.asarray(style)
    jmod = jpggan.EncoderClassifier(JaxPGGANConfig(**kw), OUT_DIM)
    variables = _variables(jmod, rng, jnp.asarray(code), style=jstyle)
    jclip = jops.renorm_clipping_schedule(jnp.asarray(STEP, jnp.int32))
    out = jax.jit(lambda v: jmod.apply(v, jnp.asarray(code), domain=1, style=jstyle, train=train,
                                       renorm_clip=jclip,
                                       mutable=["batch_stats", "spectral"] if train else False)
                  )(variables)
    ref, new_vars = out if train else (out, None)

    pmod = pggan.EncoderClassifier(PGGANConfig(**kw), OUT_DIM, conditional=conditional)
    _load(pmod, variables)
    pmod.train(train)
    got = pmod(torch.from_numpy(code), domain=1, update=train,
               style=None if style is None else torch.from_numpy(style),
               renorm_clip=norms.renorm_clipping_schedule(STEP))
    assert got.shape == (2, OUT_DIM)
    close(got.detach().numpy(), ref, HEAD_TOL)
    if train:
        _compare_state(pmod, jax.device_get(new_vars), HEAD_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_style_encoder_matches(train):
    rng = np.random.RandomState(7)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    jmod = jpggan.StyleEncoder(JaxPGGANConfig(**KW), OUT_DIM)
    variables = _variables(jmod, rng, jnp.asarray(x))
    jclip = jops.renorm_clipping_schedule(jnp.asarray(STEP, jnp.int32))
    out = jax.jit(lambda v: jmod.apply(v, jnp.asarray(x), domain=0, train=train,
                                       renorm_clip=jclip,
                                       mutable=["batch_stats", "spectral"] if train else False)
                  )(variables)
    ref, new_vars = out if train else (out, None)

    pmod = pggan.StyleEncoder(PGGANConfig(**KW), OUT_DIM)
    _load(pmod, variables)
    pmod.train(train)
    got = pmod(torch.from_numpy(x), domain=0, update=train,
               renorm_clip=norms.renorm_clipping_schedule(STEP))
    close(got.detach().numpy(), ref, BODY_TOL)
    if train:
        _compare_state(pmod, jax.device_get(new_vars), BODY_TOL)
    assert {k.split(".", 1)[0] for k in pmod.state_dict()} == {"body", "head"}


@pytest.mark.parametrize("nchw", [False, True])
@pytest.mark.parametrize("strength", [0.0, 0.3])
def test_gdrop_with_jax_noise_matches(nchw, strength):
    rng = np.random.RandomState(3)
    x = rng.randn(3, 4, 5, 6).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = jops.gdrop(key, jnp.asarray(x), strength)
    noise = jax.random.normal(key, (3, 1, 1, 6), jnp.float32).reshape(3, 6)
    xt = torch.from_numpy(x)
    if nchw:
        got = basic.gdrop(xt.permute(0, 3, 1, 2), strength, noise=torch.tensor(np.asarray(noise)),
                          nchw=True).permute(0, 2, 3, 1)
    else:
        got = basic.gdrop(xt, strength, noise=torch.tensor(np.asarray(noise)))
    close(got.numpy(), ref, HEAD_TOL)
    if strength == 0.0:
        assert np.array_equal(got.numpy(), x)


def test_gdrop_draws_from_the_generator():
    x = torch.ones(64, 2, 2, 16)
    a = basic.gdrop(x, 0.5, generator=torch.Generator().manual_seed(0))
    b = basic.gdrop(x, 0.5, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    # One draw per (example, channel), shared over the spatial axes.
    assert torch.equal(a[:, 0, 0], a[:, 1, 1])
    # Multiplicative noise of std strength * sqrt(C).
    assert float((a - 1).std()) == pytest.approx(0.5 * 4, rel=0.2)
    with pytest.raises(ValueError, match="mode"):
        basic.gdrop(x, 0.5, mode="mul")
