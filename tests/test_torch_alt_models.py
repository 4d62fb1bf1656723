"""The port's DCGAN, CycleGAN and pix2pix networks against the JAX modules.

Shapes of ``tests/test_alt_models.py`` and ``tests/test_classifiers.py``'s
pix2pix case: depth or filters 8, batch 2 (3 for the CycleGAN
discriminator), 8-32 px, on the CPU. Every kernel, bias, norm scale and
bias and running moment is drawn from a seed at the shapes of the JAX
module's ``init``, and the port's network loads them through
``bridge.state_dict_from_flax``. Each case checks:

- the bridge both ways: the port's ``state_dict`` returns to the same Flax
  tree bit for bit (``bridge.flax_variables``), and its keys are the Flax
  paths;
- eval mode (running moments): the port's output and every end point in
  float32 against the JAX module's in float64, rtol 1e-4 and atol 1e-5 of
  the reference's largest magnitude (at least 1e-5), and the port's in
  float64 against the same within the float64 tolerance below;
- train mode, in float64 (both sides; the JAX one under
  ``jax.enable_x64``, one compile for eval, train and gradients): the
  output, and the running moments after one updating call
  (``update=True`` against Flax's ``mutable=["batch_stats"]``). pix2pix's train-mode dropout masks are the
  Flax module's own draws, read from its ``nn.Dropout`` calls
  (``nn.intercept_methods``) and handed to the port;
- the parameters' gradients of a seeded weighted sum of the output, in
  train mode, in float64.

Train mode runs in float64 because batch norm over batch 2 at 1x1 or 2x2
(the bottom of each network) divides by a standard deviation of two or
eight values, which magnifies float32's rounding past any fixed
tolerance (1e-5 on an output of magnitude 0.5 here). In float64 the
tolerance is rtol 1e-7 plus 1e-10 of the largest magnitude (of the
tensor, or of the network's largest gradient: a conv bias ahead of a
train-mode batch norm has a gradient of exactly 0, which both packages
give as rounding noise).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_twingan_step import _unoptimized_jax_reference  # noqa: E402,F401

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.models import cyclegan as jcyclegan  # noqa: E402
from twingan_tpu.models import dcgan as jdcgan  # noqa: E402
from twingan_tpu.models import pix2pix as jpix2pix  # noqa: E402

from twingan_tpu_torch import bridge  # noqa: E402
from twingan_tpu_torch.models import cyclegan, dcgan, pix2pix  # noqa: E402
from twingan_tpu_torch.models.layers import reset_parameters  # noqa: E402
from twingan_tpu_torch.models.plain_layers import same_pads, transpose_pads  # noqa: E402

from torch_quant_parity import as_float64, two_torch_threads  # noqa: E402

_two_torch_threads = pytest.fixture(autouse=True, scope="module")(two_torch_threads)

OUT_RTOL = 1e-4
OUT_ATOL_SHARE = 1e-5
RTOL64 = 1e-7
ATOL64_SHARE = 1e-10
GRAD64_SHARE = 1e-10


def randomize(tree, rs):
    """Every leaf of a tree of shapes drawn from ``rs``: kernels normal of
    variance 1 / fan_in, biases, norm scales and biases and running
    moments around their initial values."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(v, rs)
        elif k in ("scale", "var"):
            out[k] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = rs.normal(0.0, 0.3, v.shape).astype(np.float32)
        else:
            fan_in = int(np.prod(v.shape[:-1]))
            out[k] = rs.normal(0.0, fan_in ** -0.5, v.shape).astype(np.float32)
    return out


def close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = max(OUT_ATOL_SHARE * float(np.abs(want).max()), 1e-5)
    np.testing.assert_allclose(got, want, rtol=OUT_RTOL, atol=atol, err_msg=what)


def flat(tree, prefix=""):
    return bridge._flatten(tree, prefix)


def setup(jmod, pmod, x, seed=0):
    """The JAX module's variables, drawn from a seed at the shapes its
    ``init`` gives (``jax.eval_shape``: Flax's own draws take seconds to
    compile), and the port module loaded with them."""
    variables = jax.eval_shape(lambda x: jmod.init(jax.random.PRNGKey(seed), x), x)
    rs = np.random.RandomState(seed + 1)
    variables = {k: randomize(v, rs) for k, v in variables.items()}
    sd = bridge.state_dict_from_flax(variables["params"], variables.get("batch_stats"))
    assert set(sd) == set(pmod.state_dict()), set(sd) ^ set(pmod.state_dict())
    pmod.load_state_dict(sd, strict=True)
    back = bridge.flax_variables(pmod.state_dict())
    for name in variables:
        a, b = flat(back[name]), flat(variables[name])
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}/{k}")
    return variables


def check_all(jmod, pmod, x, variables, jax_kw=None, port_kw=None, has_stats=True):
    """One JAX compile in float64 (eval, train with the running-moment
    update, gradients); the port's eval in float32 and float64, its train
    mode and gradients in float64."""
    jax_kw, port_kw = jax_kw or {}, port_kw or {}
    mutable = ["batch_stats"] if has_stats else False
    with jax.enable_x64(True):
        v64, x64 = as_float64(variables), jnp.asarray(np.asarray(x, np.float64))
        if callable(port_kw):
            port_kw = port_kw(v64, x64)
        w = np.random.RandomState(7).randn(*jax.eval_shape(
            lambda: jmod.apply(v64, x64, train=False)[0]).shape)

        def train(v, x):
            res = jmod.apply(v, x, train=True, mutable=mutable, **jax_kw)
            return res if has_stats else (res, {})

        def loss(params):
            (out, _), new_state = train({**v64, "params": params}, x64)
            return jnp.sum(out * w), (out, new_state)

        def run(params):
            return jmod.apply({**v64, "params": params}, x64, train=False), jax.grad(
                loss, has_aux=True)(params)

        (jout, jeps), (jgrads, (jtrain, new_state)) = jax.device_get(
            jax.jit(run)(v64["params"]))
        jgrads = flat(jgrads)
    pmod.float().eval()
    with torch.no_grad():
        pout, peps = pmod(torch.from_numpy(np.array(x)), end_points=True)
    close(pout, jout, "float32 eval output")
    assert set(peps) == set(jeps)
    for k in jeps:
        close(peps[k], jeps[k], f"float32 eval {k}")
    pmod.double()
    x64 = torch.from_numpy(np.asarray(x, np.float64))
    with torch.no_grad():
        pout, peps = pmod(x64, end_points=True)
        close64(pout, jout, "eval output")
        for k in jeps:
            close64(peps[k], jeps[k], f"eval {k}")
        pmod.train()
        close64(pmod(x64, update=True, **port_kw), jtrain, "train output")
    if has_stats:
        got = flat(bridge.flax_variables(pmod.state_dict())["batch_stats"])
        want = flat(new_state["batch_stats"])
        assert set(got) == set(want) and want
        for k in want:
            close64(got[k], want[k], k)
    pmod.load_state_dict(bridge.state_dict_from_flax(v64["params"], v64.get("batch_stats")))
    pmod.zero_grad()
    torch.sum(pmod(x64, **port_kw) * torch.from_numpy(w)).backward()
    pgrads = flat(bridge.flax_variables(
        {k: p.grad for k, p in pmod.named_parameters()})["params"])
    assert set(pgrads) == set(jgrads)
    atol = GRAD64_SHARE * max(float(np.abs(g).max()) for g in jgrads.values())
    for k, want in jgrads.items():
        np.testing.assert_allclose(pgrads[k], want, rtol=RTOL64, atol=atol, err_msg=k)


def close64(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float64, (what, got.shape, want.shape)
    atol = ATOL64_SHARE * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL64, atol=atol, err_msg=what)


def images(shape, seed=0):
    return jnp.asarray(np.random.RandomState(seed).rand(*shape).astype(np.float32) * 2 - 1)


@pytest.mark.parametrize("size,stride,kernel", [(8, 2, 4), (8, 1, 4), (7, 2, 3), (1, 2, 4)])
def test_same_pads_match_lax(size, stride, kernel):
    from jax import lax

    want = lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
    assert same_pads(size, kernel, stride) == tuple(want)


@pytest.mark.parametrize("kernel,stride,padding,want", [
    (4, 2, "SAME", (2, 2)), (3, 2, "SAME", (2, 1)), (4, 1, "VALID", (3, 3))])
def test_transpose_pads(kernel, stride, padding, want):
    assert transpose_pads(kernel, stride, padding) == want


@pytest.mark.parametrize("final_size", [8, 16, 32])
def test_dcgan_generator(final_size):
    jmod = jdcgan.DCGANGenerator(depth=8, final_size=final_size)
    pmod = dcgan.DCGANGenerator(depth=8, final_size=final_size, latent_dim=10)
    z = jnp.asarray(np.random.RandomState(3).randn(2, 10).astype(np.float32))
    variables = setup(jmod, pmod, z)
    check_all(jmod, pmod, z, variables)


@pytest.mark.parametrize("size", [8, 16, 32])
def test_dcgan_discriminator(size):
    jmod = jdcgan.DCGANDiscriminator(depth=8)
    pmod = dcgan.DCGANDiscriminator(depth=8, input_size=size)
    x = images((2, size, size, 3), seed=size)
    variables = setup(jmod, pmod, x)
    assert "conv1_bn" not in variables["batch_stats"]
    assert "conv2_bn" in variables["batch_stats"]
    check_all(jmod, pmod, x, variables)


def test_dcgan_refuses_bad_sizes():
    with pytest.raises(ValueError):
        dcgan.DCGANGenerator(final_size=6)
    with pytest.raises(ValueError):
        dcgan.DCGANGenerator(final_size=4)
    with pytest.raises(ValueError):
        dcgan.DCGANDiscriminator(input_size=12)
    with pytest.raises(ValueError):
        dcgan.DCGANGenerator(depth=8, final_size=8, latent_dim=4)(torch.zeros(2, 1, 1, 4))


@pytest.mark.parametrize("method", cyclegan.UPSAMPLE_METHODS)
def test_cyclegan_generator_upsample_methods(method):
    jmod = jcyclegan.CycleGANGenerator(num_filters=8, num_resnet_blocks=1,
                                       upsample_method=method)
    pmod = cyclegan.CycleGANGenerator(num_filters=8, num_resnet_blocks=1,
                                      upsample_method=method)
    x = images((2, 16, 16, 3), seed=1)
    variables = setup(jmod, pmod, x)
    check_all(jmod, pmod, x, variables, has_stats=False)


def test_cyclegan_generator_blocks_and_nonsquare_input():
    jmod = jcyclegan.CycleGANGenerator(num_filters=8, num_resnet_blocks=2)
    pmod = cyclegan.CycleGANGenerator(num_filters=8, num_resnet_blocks=2)
    x = images((1, 32, 64, 3), seed=2)
    variables = setup(jmod, pmod, x)
    check_all(jmod, pmod, x, variables, has_stats=False)
    with torch.no_grad():
        out = pmod.float()(torch.from_numpy(np.array(x)))
    assert out.shape == (1, 32, 64, 3) and float(out.abs().max()) <= 1.0 + 1e-5


def test_cyclegan_tanh_linear_slope():
    jmod = jcyclegan.CycleGANGenerator(num_filters=8, num_resnet_blocks=1,
                                       tanh_linear_slope=0.5)
    pmod = cyclegan.CycleGANGenerator(num_filters=8, num_resnet_blocks=1,
                                      tanh_linear_slope=0.5)
    x = images((1, 16, 16, 3), seed=3) * 10
    variables = setup(jmod, pmod, x)
    check_all(jmod, pmod, x, variables, has_stats=False)
    with torch.no_grad():
        out, eps = pmod.float()(torch.from_numpy(np.array(x)), end_points=True)
    torch.testing.assert_close(out, torch.tanh(eps["logits"]) + 0.5 * eps["logits"])


def test_cyclegan_discriminator():
    jmod = jcyclegan.CycleGANDiscriminator(num_filters=8, num_resnet_blocks=2)
    pmod = cyclegan.CycleGANDiscriminator(num_filters=8, num_resnet_blocks=2)
    x = images((3, 32, 32, 3), seed=4)
    variables = setup(jmod, pmod, x)
    check_all(jmod, pmod, x, variables, has_stats=False)


def test_cyclegan_refuses_bad_inputs():
    with pytest.raises(ValueError):
        cyclegan.CycleGANGenerator(upsample_method="bicubic")
    with pytest.raises(ValueError):
        cyclegan.CycleGANGenerator(num_filters=8, num_resnet_blocks=1)(torch.zeros(1, 18, 16, 3))


def flax_dropout_masks(jmod, variables, x, key):
    """The keep masks of the Flax module's own dropout draws (and that no
    input of a dropout was 0, which would hide its mask)."""

    def run(variables, x):
        masks, inputs_nonzero = [], []

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
                inputs_nonzero.append(jnp.all(args[0] != 0))
                masks.append(out != 0)
            return out

        with fnn.intercept_methods(record):
            jmod.apply(variables, x, train=True, rngs={"dropout": key}, mutable=["batch_stats"])
        return masks, inputs_nonzero

    masks, nonzero = jax.device_get(jax.jit(run)(variables, x))
    assert all(nonzero)
    return [torch.from_numpy(np.array(m)) for m in masks]


def test_pix2pix_generator():
    jmod = jpix2pix.Pix2PixGenerator(base_filters=8)
    pmod = pix2pix.Pix2PixGenerator(base_filters=8, input_size=32)
    x = images((2, 32, 32, 3), seed=5)
    variables = setup(jmod, pmod, x)
    key = jax.random.PRNGKey(11)

    def masks(v, x):
        got = flax_dropout_masks(jmod, v, x, key)
        assert [tuple(m.shape) for m in got] == pmod.dropout_shapes(2)
        assert 0.3 < float(torch.cat([m.flatten() for m in got]).float().mean()) < 0.7
        return {"dropout_masks": got}

    check_all(jmod, pmod, x, variables, jax_kw={"rngs": {"dropout": key}}, port_kw=masks)


def test_pix2pix_discriminator():
    jmod = jpix2pix.Pix2PixDiscriminator(base_filters=8)
    pmod = pix2pix.Pix2PixDiscriminator(base_filters=8)
    x = images((2, 32, 32, 6), seed=6)
    variables = setup(jmod, pmod, x)
    check_all(jmod, pmod, x, variables)


def test_pix2pix_draws_its_own_masks_and_refuses_bad_sizes():
    pmod = pix2pix.Pix2PixGenerator(base_filters=8, input_size=32).train()
    reset_parameters(pmod, torch.Generator().manual_seed(0))
    x = torch.rand(2, 32, 32, 3)
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    with torch.no_grad():
        a, b = pmod(x, generator=gen()), pmod(x, generator=gen())
        c = pmod(x, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    with pytest.raises(ValueError):
        pix2pix.Pix2PixGenerator(base_filters=8, input_size=24)
    with pytest.raises(ValueError):
        pix2pix.Pix2PixGenerator(base_filters=8, input_size=32)(torch.zeros(1, 16, 16, 3))
