"""The flash-attention backward of the port against the JAX package's.

On the CPU, ``FlashAttention`` runs the plain versions of its three
kernels (``attention_core``/``attention_lse`` forward, then
``flash_attention_dq_plain``/``flash_attention_dkv_plain``); the CUDA
kernels themselves are checked against these on the card by
``chip_smoke.py``. Here the gradients are held against ``jax.grad``
through the JAX package's Pallas kernels in interpret mode (N divisible by
its blocks) and through its einsum VJP (divisible and ragged N), with the
tolerances of ``tests/test_ops.py``: gradients rtol 1e-3 / atol 1e-4.

Also: the backward is differentiable once only, so a second-order pass
through ``FlashAttention`` raises, also where ``torch.autograd.grad``
with explicit inputs would prune ``once_differentiable``'s own error; the
gradient penalty's route, the plain
``attention_core``, matches JAX's second-order gradient of the einsum
path; and that route is counted.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.ops import attention as jattention  # noqa: E402

from twingan_tpu_torch.ops import attention  # noqa: E402

GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _inputs(n, b=2, c_bar=4, c=8, seed=0):
    rng = np.random.RandomState(seed)
    f, g = rng.randn(b, n, c_bar).astype(np.float32), rng.randn(b, n, c_bar).astype(np.float32)
    h = rng.randn(b, n, c).astype(np.float32)
    w = rng.randn(b, n, c).astype(np.float32)  # the cotangent of the output
    return f, g, h, w


def _jax_grads(core, f, g, h, w):
    def loss(f_, g_, h_):
        return jnp.sum(core(f_, g_, h_) * w)

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (f, g, h)))]


def _port_grads(f, g, h, w):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (f, g, h)]
    o = attention.flash_attention_core(*ts)
    return [x.numpy() for x in torch.autograd.grad(torch.sum(o * torch.from_numpy(w)), ts)]


@pytest.mark.parametrize("reference,n", [
    ("pallas interpret", 256),
    ("einsum", 256),
    ("einsum", 200),  # ragged: the JAX flash kernels reject it
])
def test_flash_backward_matches_jax(reference, n):
    f, g, h, w = _inputs(n)
    if reference == "einsum":
        core = jattention.attention_core
    else:
        def core(f_, g_, h_):
            return jattention.flash_attention_core(f_, g_, h_, 128, 128)
    ref = _jax_grads(core, f, g, h, w)
    for name, out, r in zip("fgh", _port_grads(f, g, h, w), ref):
        np.testing.assert_allclose(out, r, err_msg=f"d{name}", **GRAD_TOL)


def test_plain_backward_matches_jax_blockwise_backward():
    """The two plain kernel versions against the JAX package's own
    ``_flash_backward`` (its two Pallas kernels in interpret mode), from
    the same lse and delta."""
    f, g, h, w = _inputs(256, seed=1)
    o, lse = jattention._flash_forward(*map(jnp.asarray, (f, g, h)), 128, 128)
    delta = jnp.sum(jnp.asarray(w) * o, axis=-1)
    ref = jattention._flash_backward(*map(jnp.asarray, (f, g, h, w)), lse, delta, 128, 128)
    out = attention.flash_attention_backward_plain(
        *map(torch.from_numpy, (f, g, h, w)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(np.array(delta)))
    for name, a, r in zip("fgh", out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=f"d{name}", **GRAD_TOL)


def test_backward_keeps_dtypes_and_checks_shapes():
    f, g, h, w = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(64))
    lse = attention.attention_lse(f, g)
    delta = torch.sum(w.float() * attention.attention_core(f, g, h).float(), dim=-1)
    df, dg, dh = attention.flash_attention_backward(f, g, h, w, lse, delta)
    assert df.dtype == dg.dtype == dh.dtype == torch.bfloat16
    assert df.shape == f.shape and dg.shape == g.shape and dh.shape == h.shape
    with pytest.raises(ValueError, match="shape mismatch"):
        attention.flash_attention_backward(f, g, h, w[:, :10], lse, delta)
    with pytest.raises(ValueError, match="device"):
        attention.flash_attention_backward(f, g, h, w, lse.to("meta"), delta)


def _critic(x, core, weights):
    """A discriminator's shape around attention: projections, attention,
    a readout; the penalty differentiates it twice."""
    wf, wg, wh, wo = weights
    return (torch.tanh(core(x @ wf, x @ wg, x @ wh)) @ wo).sum()


@pytest.mark.parametrize("second_pass", ["autograd.grad", "backward"])
def test_flash_attention_refuses_a_second_order_pass(second_pass):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 8, generator=gen, requires_grad=True)
    weights = [torch.randn(8, n, generator=gen, requires_grad=True) for n in (2, 2, 8)]
    weights.append(torch.randn(8, 1, generator=gen, requires_grad=True))
    with pytest.raises(RuntimeError, match="differentiable once only"):
        (gx,) = torch.autograd.grad(_critic(x, attention.flash_attention_core, weights), x,
                                    create_graph=True)
        penalty = gx.square().sum()
        if second_pass == "backward":
            penalty.backward()
        else:
            torch.autograd.grad(penalty, weights)
    # A first-order pass runs, and the plain route differentiates twice.
    (gx_flash,) = torch.autograd.grad(_critic(x, attention.flash_attention_core, weights), x)
    (gx_plain,) = torch.autograd.grad(_critic(x, attention.attention_core, weights), x,
                                      create_graph=True)
    np.testing.assert_allclose(gx_flash.numpy(), gx_plain.detach().numpy(), rtol=1e-4, atol=1e-5)
    assert all(g.abs().sum() > 0 for g in torch.autograd.grad(gx_plain.square().sum(), weights))


def test_plain_route_matches_jax_second_order():
    """The gradient penalty's shape of computation: the gradient of a
    function of d(output)/df, through the plain route."""
    f, g, h, w = _inputs(64, seed=2)

    def jpenalty(f_, g_, h_):
        inner = jax.grad(lambda f2: jnp.sum(jattention.attention_core(f2, g_, h_) * w))(f_)
        return jnp.sum(jnp.square(inner))

    ref = jax.grad(jpenalty, argnums=(0, 1, 2))(*map(jnp.asarray, (f, g, h)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (f, g, h)]
    attention.reset_launch_counts()
    o = attention.self_attention(*ts, route="plain")
    (inner,) = torch.autograd.grad(torch.sum(o * torch.from_numpy(w)), ts[0], create_graph=True)
    out = torch.autograd.grad(torch.sum(torch.square(inner)), ts)
    for name, a, r in zip("fgh", out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=f"d{name}", **GRAD_TOL)
    assert attention.launch_counts[attention.PLAIN_ROUTE] == 1


def test_routes_and_counts_on_the_cpu():
    f, g, h, _ = (torch.from_numpy(x) for x in _inputs(16))
    attention.reset_launch_counts()
    np.testing.assert_array_equal(attention.self_attention(f, g, h).numpy(),
                                  attention.self_attention(f, g, h, route="plain").numpy())
    # The CPU runs the plain versions: no kernel is launched, and only the
    # explicit plain route is counted.
    assert attention.launch_counts == {attention.KERNEL_NAME: 0, attention.DQ_KERNEL: 0,
                                       attention.DKV_KERNEL: 0, attention.PLAIN_ROUTE: 1}
    with pytest.raises(ValueError, match="route"):
        attention.self_attention(f, g, h, route="sdpa")
