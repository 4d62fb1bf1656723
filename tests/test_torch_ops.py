"""The port's ops against twingan_tpu.ops, and the attention kernel's
wrapper on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
Elementwise ops and norms agree to 1e-5 in fp32. The plain attention agrees
with the JAX einsum path and with the Pallas flash kernel run in interpret
mode (rtol 1e-4 / atol 1e-5, the tolerance of tests/test_ops.py). The CUDA
kernel itself runs only on the card (chip_smoke.py); here the wrapper's
checks, its CPU route and its refusal to build without nvcc are tested.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from twingan_tpu import ops as jops  # noqa: E402
from twingan_tpu.ops import attention as jattention  # noqa: E402
from twingan_tpu.ops import norms as jnorms  # noqa: E402

from twingan_tpu_torch.ops import attention, basic, cuda_build, norms  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape=(2, 8, 8, 6), seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_leaky_relu():
    x = _x()
    np.testing.assert_allclose(basic.leaky_relu(_t(x)).numpy(),
                               np.asarray(jops.leaky_relu(jnp.asarray(x))), **TOL)


def test_pixel_norm_nhwc_and_nchw():
    x = _x(scale=3.0)
    ref = np.asarray(jops.pixel_norm(jnp.asarray(x)))
    np.testing.assert_allclose(basic.pixel_norm(_t(x)).numpy(), ref, **TOL)
    nchw = basic.pixel_norm(_t(x).permute(0, 3, 1, 2), dim=1)
    np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), ref, **TOL)


@pytest.mark.parametrize("fan_in,k", [(3, 1), (64, 3), (512, 4), (48, 7)])
def test_equalized_lr_scale(fan_in, k):
    assert basic.equalized_lr_scale(fan_in, k) == pytest.approx(
        jops.equalized_lr_scale(fan_in, k), rel=1e-12)


@pytest.mark.parametrize("nchw", [False, True])
def test_upsample_and_pool(nchw):
    x = _x()
    tx = _t(x).permute(0, 3, 1, 2) if nchw else _t(x)
    back = (lambda t: t.permute(0, 2, 3, 1)) if nchw else (lambda t: t)
    np.testing.assert_allclose(back(basic.upsample_nearest_2x(tx, nchw=nchw)).numpy(),
                               np.asarray(jops.upsample_nearest_2x(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(back(basic.avg_pool_2x(tx, nchw=nchw)).numpy(),
                               np.asarray(jops.avg_pool_2x(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_blend(alpha):
    a, b = _x(seed=1), _x(seed=2)
    np.testing.assert_allclose(basic.blend(_t(a), _t(b), alpha).numpy(),
                               np.asarray(jops.blend(jnp.asarray(a), jnp.asarray(b), alpha)), **TOL)


def test_moments_and_normalize():
    x = _x(scale=2.0) + 0.5
    jm, jv = jnorms.moments(jnp.asarray(x), (0, 1, 2))
    pm, pv = norms.moments(_t(x), (0, 1, 2))
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **TOL)
    rng = np.random.RandomState(3)
    gamma, beta = rng.rand(6).astype(np.float32) + 0.5, rng.randn(6).astype(np.float32)
    ref = jnorms.normalize(jnp.asarray(x), jm, jv, jnp.asarray(gamma), jnp.asarray(beta), eps=1e-3)
    out = norms.normalize(_t(x), pm, pv, _t(gamma), _t(beta), eps=1e-3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    ref = jnorms.normalize(jnp.asarray(x), jm, jv, None, None, eps=1e-6)
    np.testing.assert_allclose(norms.normalize(_t(x), pm, pv, None, None, eps=1e-6).numpy(),
                               np.asarray(ref), **TOL)


def test_instance_moments():
    x = _x(scale=2.0)
    jm, jv = jnorms.instance_moments(jnp.asarray(x))
    pm, pv = norms.instance_moments(_t(x))
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **TOL)
    cm, cv = norms.instance_moments(_t(x).permute(0, 3, 1, 2), nchw=True)
    np.testing.assert_allclose(cv.permute(0, 2, 3, 1).numpy(), np.asarray(jv), **TOL)


def _fgh(b, n, cb, c, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, cb).astype(np.float32), rng.randn(b, n, cb).astype(np.float32),
            rng.randn(b, n, c).astype(np.float32))


@pytest.mark.parametrize("b,n,cb,c", [(2, 16, 4, 8), (1, 100, 1, 8), (2, 64, 8, 64)])
def test_attention_core_matches_einsum(b, n, cb, c):
    f, g, h = _fgh(b, n, cb, c, seed=n)
    ref = np.asarray(jattention.attention_core(*map(jnp.asarray, (f, g, h))))
    out = attention.attention_core(_t(f), _t(g), _t(h)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_attention_core_bf16_matches_einsum():
    f, g, h = _fgh(2, 64, 8, 16, seed=5)
    ref = jattention.attention_core(*(jnp.asarray(a, jnp.bfloat16) for a in (f, g, h)))
    out = attention.attention_core(*(_t(a).bfloat16() for a in (f, g, h)))
    assert out.dtype == torch.bfloat16
    # Both round the same fp32 accumulation to bf16: at most one unit in
    # the last place apart (1/128 of the magnitude).
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)


def test_plain_matches_pallas_flash_interpret():
    """The plain version against the Pallas kernel in interpret mode (as
    tests/test_ops.py runs it): N 512, blocks 128, output and logsumexp."""
    f, g, h = _fgh(2, 512, 8, 16, seed=1)
    jf, jg, jh = map(jnp.asarray, (f, g, h))
    ref = np.asarray(jattention.flash_attention_core(jf, jg, jh, 128, 128))
    o, lse = attention.flash_attention_forward(_t(f), _t(g), _t(h))
    np.testing.assert_allclose(o.numpy(), ref, rtol=1e-4, atol=1e-5)
    _, ref_lse = jattention._flash_forward(jf, jg, jh, 128, 128)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=1e-4, atol=1e-5)


def test_ragged_n_on_cpu_matches_naive():
    f, g, h = _fgh(1, 1000, 8, 64, seed=7)
    o, lse = attention.flash_attention_forward(_t(f), _t(g), _t(h))
    s = f[0].astype(np.float64) @ g[0].T.astype(np.float64)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = (p / p.sum(-1, keepdims=True)) @ h[0]
    np.testing.assert_allclose(o[0].numpy(), ref, rtol=1e-4, atol=1e-5)
    ref_lse = s.max(-1) + np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1))
    np.testing.assert_allclose(lse[0].numpy(), ref_lse, rtol=1e-5, atol=1e-5)


def test_cpu_route_launches_no_kernel():
    attention.reset_launch_counts()
    f, g, h = map(_t, _fgh(2, 64, 8, 16, seed=2))
    out = attention.self_attention(f, g, h)
    np.testing.assert_array_equal(out.numpy(), attention.attention_core(f, g, h).numpy())
    np.testing.assert_array_equal(attention.flash_attention_core(f, g, h).numpy(), out.numpy())
    leaves = [t.clone().requires_grad_(True) for t in (f, g, h)]
    torch.autograd.grad(attention.flash_attention_core(*leaves).sum(), leaves)
    assert attention.launch_counts == {attention.KERNEL_NAME: 0, attention.DQ_KERNEL: 0,
                                       attention.DKV_KERNEL: 0, attention.PLAIN_ROUTE: 0}


@pytest.mark.parametrize("shapes,dtypes,msg", [
    (((2, 8, 4), (2, 8, 2), (2, 8, 16)), None, "shape"),
    (((2, 8, 4), (2, 8, 4), (2, 9, 16)), None, "shape"),
    (((2, 8, 4), (2, 8, 4), (2, 8, 16)), (torch.float32, torch.float32, torch.bfloat16), "dtype"),
    (((8, 4), (8, 4), (8, 16)), None, r"\[B, N"),
])
def test_wrapper_rejects_bad_inputs(shapes, dtypes, msg):
    dtypes = dtypes or (torch.float32,) * 3
    args = [torch.zeros(s, dtype=d) for s, d in zip(shapes, dtypes)]
    with pytest.raises(ValueError, match=msg):
        attention.flash_attention_forward(*args)


def test_backward_raises():
    """The backward kernels have no second-order rule: a create_graph=True
    pass through FlashAttention raises instead of returning a gradient
    that treats their outputs as constants (a first-order pass runs)."""
    f, g, h = (_t(a).requires_grad_() for a in _fgh(1, 16, 4, 8, seed=3))
    attention.flash_attention_core(f, g, h).sum().backward()
    assert f.grad is not None and g.grad is not None and h.grad is not None
    out = attention.flash_attention_core(f, g, h)
    with pytest.raises(RuntimeError, match="differentiable once only"):
        torch.autograd.grad(out.square().sum(), f, create_graph=True)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: without the CUDA toolkit the kernel library
    cannot be built, and asking for it raises."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load(attention.KERNEL_NAME)


def test_library_path_keys_on_source(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// a\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(src))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "_build"))
    first = cuda_build.library_path("k")
    assert first == cuda_build.library_path("k")
    assert first.startswith(str(tmp_path / "_build")) and first.endswith("libk.so")
    (src / "k.cu").write_text("// b\n")
    second = cuda_build.library_path("k")
    assert second != first
    # A header of csrc/ (which a source may include) is part of the key.
    (src / "h.cuh").write_text("// h\n")
    third = cuda_build.library_path("k")
    assert third != second
    (src / "h.cuh").write_text("// h, edited\n")
    assert cuda_build.library_path("k") not in (first, second, third)


def test_kernel_source_uses_plain_c_interface():
    with open(os.path.join(cuda_build.CSRC_DIR, "flash_attn_fwd.cu")) as fh:
        src = fh.read()
    assert 'extern "C" int flash_attn_fwd(' in src
    assert "torch/extension.h" not in src
    assert "_flash_kernel" in src  # names the TPU kernel it replaces
