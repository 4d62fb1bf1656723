"""Kernel B4's plain version and dispatch against the JAX functions.

``fused_conv_plain`` (conv3x3 SAME -> + bias -> leaky 0.2 -> pixel norm,
fp32 math, output in x's dtype) is held against ``xla_block`` and against
``pallas_block`` run in interpret mode, both loaded by file path from
``tools/exp_fused_conv.py``, on inputs made with numpy from a seed, at
(B, H=W, Cin -> Cout) = (2, 16, 16 -> 16) (two 8-row tiles), (1, 8, 32 -> 16)
(Cin != Cout) and (2, 4, 8 -> 8) (one tile), in fp32 and bf16.

``pallas_block`` rounds x to bf16 for its tiles (the TPU kernel takes bf16),
so x is drawn as bf16-representable values: then fp32 and bf16 runs see
the same input. Tolerances, as a share of the output's largest magnitude:
- against ``pallas_block``: fp32, 1e-5 (both sum the same fp32 products in
  other orders); bf16, one bf16 ulp (2^-7: both round the same fp32 result
  once, so they differ by at most one unit in the last place);
- against ``xla_block`` in fp32: 1e-5; in bf16, two bf16 ulps (2^-6):
  ``xla_block`` rounds the weights to bf16 before its conv where B4
  multiplies by the fp32 weights, up to 2^-9 of every product (measured:
  at most 0.73 ulp of the output's largest magnitude), and each side
  rounds its output once.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
this plain version); here the wrapper's checks and the dispatch's routes
are tested, and models of the two variants' arithmetic. bf16: each fp32
weight split into hi = bf16(w) and lo = bf16(w - hi), bf16 x times each
half summed in fp32, the Cin chunks of 16 split across blocks and their
partial sums added in a fixed order, one rounding of the output. fp32
(3xTF32): x and w each split into hi = tf32(v) (cvt.rna) and lo = v - hi
cut to TF32, each product lo hi + hi lo + hi hi, each chunk of 8 input
channels summed apart (fresh accumulators) and added in fp32, the chunks
split across blocks as in bf16. Fed the same bf16-valued inputs, each
model stays within ``chip_smoke.py``'s ``fused_conv_tolerance`` of its
type of ``pallas_block`` (interpret mode) and of ``fused_conv_plain``; the
fp32 model also on x that bf16 does not hold, and one TF32 product in
place of three misses the fp32 tolerance.
"""

import ctypes
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_twingan_step import _two_torch_threads  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from twingan_tpu_torch.models import pggan  # noqa: E402
from twingan_tpu_torch.models.config import PGGANConfig  # noqa: E402
from twingan_tpu_torch.models.layers import ConvBlock, reset_parameters  # noqa: E402
from twingan_tpu_torch.ops import basic, fused_conv  # noqa: E402
from test_torch_attention_tf32 import split as split_tf32, tf32_rna  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(2, 16, 16, 16), (1, 8, 32, 16), (2, 4, 8, 8)]
CHUNK = 16  # input channels of one K chunk of the tensor-core variant
TF32_CHUNK = 8  # and of the TF32 variant
BF16_ULP = 2.0 ** -7
XLA_BF16_SHARE = 2.0 ** -6


@pytest.fixture(scope="module")
def exp():
    spec = importlib.util.spec_from_file_location(
        "exp_fused_conv", os.path.join(REPO, "tools", "exp_fused_conv.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(b, hw, cin, cout, seed=0):
    """x NHWC with bf16-representable values, w HWIO and bias, fp32."""
    rng = np.random.RandomState(seed)
    x = rng.rand(b, hw, hw, cin).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    w = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w, bias


def _plain(x, w, bias, dtype):
    """fused_conv_plain on the NCHW view of x, returned NHWC in fp32."""
    cin, cout = w.shape[2:]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dtype)
    w9 = torch.from_numpy(w.reshape(9, cin, cout))
    y = fused_conv.fused_conv_plain(xt, w9, torch.from_numpy(bias))
    assert y.dtype == dtype
    return y.float().permute(0, 2, 3, 1).numpy()


def _jax(fn, x, w, bias, dtype):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out = fn(jnp.asarray(x).astype(jdtype), jnp.asarray(w), jnp.asarray(bias))
    assert out.dtype == jdtype
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["16px_16to16", "8px_32to16", "4px_8to8"])
def test_plain_matches_pallas_interpret(exp, shape, dtype):
    x, w, bias = _inputs(*shape)
    ref = _jax(exp.pallas_block, x, w, bias, dtype)
    share = 1e-5 if dtype == torch.float32 else BF16_ULP
    np.testing.assert_allclose(_plain(x, w, bias, dtype), ref, rtol=0,
                               atol=share * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["16px_16to16", "8px_32to16", "4px_8to8"])
def test_plain_matches_xla_block(exp, shape, dtype):
    x, w, bias = _inputs(*shape, seed=1)
    ref = _jax(exp.xla_block, x, w, bias, dtype)
    share = 1e-5 if dtype == torch.float32 else XLA_BF16_SHARE
    np.testing.assert_allclose(_plain(x, w, bias, dtype), ref, rtol=0,
                               atol=share * np.abs(ref).max())


def test_plain_matches_xla_block_ragged(exp):
    """Any H and W (the CUDA kernel masks them; the Pallas one needs
    H % 8 == 0 above 8 rows): 5 x 7 against XLA's SAME conv."""
    rng = np.random.RandomState(2)
    x = rng.rand(1, 5, 7, 3).astype(np.float32)
    w = (rng.randn(3, 3, 3, 5) * 0.3).astype(np.float32)
    bias = (rng.randn(5) * 0.1).astype(np.float32)
    ref = _jax(exp.xla_block, x, w, bias, torch.float32)
    np.testing.assert_allclose(_plain(x, w, bias, torch.float32), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_fold_weights_matches_the_eq_lr_conv():
    """w_eff = kernel * sqrt(2 / (Cin * 9)) as [9, Cin, Cout]: the plain
    version on the folded weights equals the eager block (EqConv scaling
    its input), then pixel norm, in fp32."""
    cfg = PGGANConfig(norm_type="none", equalized_lr=True)
    block = ConvBlock(cfg, 6, 10)
    reset_parameters(block, torch.Generator().manual_seed(0))
    with torch.no_grad():
        block.conv.bias.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(1))
        x = torch.from_numpy(np.random.RandomState(3).randn(2, 6, 5, 4).astype(np.float32))
        ref = basic.pixel_norm(block(x), dim=1)
        w9 = fused_conv.fold_weights(block.conv.kernel, block.conv.input_scale)
        out = fused_conv.fused_conv(x, w9, block.conv.bias.detach())
    assert w9.shape == (9, 6, 10) and w9.is_contiguous()
    assert block.conv.input_scale == pytest.approx((2.0 / (6 * 9)) ** 0.5)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def _fusable_block(grad: bool):
    cfg = PGGANConfig(norm_type="none", equalized_lr=True, do_pixel_norm=True)
    block = ConvBlock(cfg, 4, 8)
    reset_parameters(block, torch.Generator().manual_seed(4))
    block.requires_grad_(grad)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 4, 6, 6).astype(np.float32))
    return block, x


def test_no_grad_cpu_step_runs_the_plain_version():
    block, x = _fusable_block(grad=True)
    fused_conv.reset_launch_counts()
    with torch.no_grad():
        out = block.forward_pixel_norm(x)
    ref = fused_conv.fused_conv_plain(
        x, fused_conv.fold_weights(block.conv.kernel, block.conv.input_scale),
        block.conv.bias.detach())
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert fused_conv.launch_counts == {fused_conv.KERNEL_NAME: 0, fused_conv.AUTOGRAD_ROUTE: 0}
    # Grad mode on, but nothing requires a gradient: B4's route too.
    frozen, x = _fusable_block(grad=False)
    assert frozen.forward_pixel_norm(x).grad_fn is None
    assert fused_conv.launch_counts[fused_conv.AUTOGRAD_ROUTE] == 0


def test_grad_step_takes_the_counted_autograd_route():
    block, x = _fusable_block(grad=True)
    fused_conv.reset_launch_counts()
    out = block.forward_pixel_norm(x)
    assert out.grad_fn is not None
    assert fused_conv.launch_counts == {fused_conv.KERNEL_NAME: 0, fused_conv.AUTOGRAD_ROUTE: 1}
    torch.testing.assert_close(out, basic.pixel_norm(block(x), dim=1), rtol=0, atol=0)
    with torch.no_grad():
        np.testing.assert_allclose(block.forward_pixel_norm(x).numpy(), out.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
    # An input that needs a gradient (the gradient penalty's kind) also
    # takes the autograd route.
    block.requires_grad_(False)
    block.forward_pixel_norm(x.clone().requires_grad_(True))
    assert fused_conv.launch_counts[fused_conv.AUTOGRAD_ROUTE] == 2


@pytest.mark.parametrize("kw,fusable", [
    ({}, True),
    ({"kernel_size": 1}, False),
    ({"kernel_size": 4, "padding": "VALID"}, False),
    ({"activation": None}, False),
    ({"norm": False}, True),
])
def test_which_blocks_are_fusable(kw, fusable):
    cfg = PGGANConfig(norm_type="none", equalized_lr=True)
    assert ConvBlock(cfg, 4, 8, **kw).fusable == fusable
    assert not ConvBlock(cfg.replace(norm_type="batch_norm"), 4, 8).fusable
    assert not ConvBlock(cfg.replace(norm_type="instance_norm"), 4, 8).fusable


@pytest.mark.parametrize("norm_type,expected", [("none", 7), ("batch_norm", 0)])
def test_generator_steps_by_route(norm_type, expected):
    """A 32 px generator's fusable steps: block_4_conv1 and two per stage at
    8, 16 and 32 px (block_4_conv0 of the noise input is a k4 VALID conv),
    none under batch norm. With no gradient they run B4's route (the plain
    version here), with one the counted autograd route; both agree."""
    cfg = PGGANConfig(resolution=32, max_channels=16, norm_type=norm_type, do_pixel_norm=True,
                      equalized_lr=True)
    gen = pggan.Generator(cfg, noise_input=True)
    reset_parameters(gen, torch.Generator().manual_seed(6))
    z = torch.from_numpy(np.random.RandomState(7).randn(*pggan.noise_shape(cfg, 2))
                         .astype(np.float32))
    fused_conv.reset_launch_counts()
    with torch.no_grad():
        no_grad = gen(z)
    assert fused_conv.launch_counts[fused_conv.AUTOGRAD_ROUTE] == 0
    with_grad = gen(z)
    assert fused_conv.launch_counts == {fused_conv.KERNEL_NAME: 0,
                                        fused_conv.AUTOGRAD_ROUTE: expected}
    np.testing.assert_allclose(no_grad.numpy(), with_grad.detach().numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("max_channels", [512, 1024])
def test_wide_generator_takes_the_b4_route(max_channels, monkeypatch):
    """The published PGGAN width (fmap_max 512) and the widest the config
    gives (1024 at 4 px): with no gradient, every conv-leaky-pixel-norm
    step of an 8 px generator (block_4_conv1, block_8_conv0/1) takes B4's
    route at its full width, and agrees with the autograd route."""
    cfg = PGGANConfig(resolution=8, max_channels=max_channels, norm_type="none",
                      do_pixel_norm=True, equalized_lr=True)
    gen = pggan.Generator(cfg, noise_input=True)
    reset_parameters(gen, torch.Generator().manual_seed(8))
    z = torch.from_numpy(np.random.RandomState(9).randn(*pggan.noise_shape(cfg, 2))
                         .astype(np.float32))
    couts = []
    plain = fused_conv.fused_conv_plain

    def recording_plain(x, w9, b):
        couts.append(w9.shape[2])
        return plain(x, w9, b)

    monkeypatch.setattr(fused_conv, "fused_conv_plain", recording_plain)
    fused_conv.reset_launch_counts()
    with torch.no_grad():
        no_grad = gen(z)
    assert couts == [cfg.channels(0), cfg.channels(1), cfg.channels(1)]
    assert couts[0] == max_channels
    with_grad = gen(z)
    assert fused_conv.launch_counts == {fused_conv.KERNEL_NAME: 0, fused_conv.AUTOGRAD_ROUTE: 3}
    np.testing.assert_allclose(no_grad.numpy(), with_grad.detach().numpy(), rtol=1e-4,
                               atol=1e-4)


def test_generator_wider_than_b4_is_refused_when_built(monkeypatch):
    """Once refused, now run: a generator wider than one block of B4 holds
    (Cout 1032, a ragged second tile of 8 channels) builds, and with no
    gradient its three conv-leaky-pixel-norm steps take B4's route (the
    plain version here), which agrees with the autograd route."""
    cout = fused_conv.COUT_TILE + 8
    cfg = PGGANConfig(resolution=8, min_channels=cout, norm_type="none",
                      do_pixel_norm=True, equalized_lr=True)
    gen = pggan.Generator(cfg, noise_input=True)
    reset_parameters(gen, torch.Generator().manual_seed(10))
    z = torch.from_numpy(np.random.RandomState(11).randn(*pggan.noise_shape(cfg, 1))
                         .astype(np.float32))
    couts = []
    plain = fused_conv.fused_conv_plain

    def recording_plain(x, w9, b):
        couts.append(w9.shape[2])
        return plain(x, w9, b)

    monkeypatch.setattr(fused_conv, "fused_conv_plain", recording_plain)
    fused_conv.reset_launch_counts()
    with torch.no_grad():
        no_grad = gen(z)
    assert couts == [cout] * 3
    with_grad = gen(z)
    assert fused_conv.launch_counts == {fused_conv.KERNEL_NAME: 0, fused_conv.AUTOGRAD_ROUTE: 3}
    np.testing.assert_allclose(no_grad.numpy(), with_grad.detach().numpy(), rtol=1e-4,
                               atol=1e-4)


def _args(b=2, cin=4, cout=8, h=5, w=6, dtype=torch.float32):
    return (torch.zeros(b, cin, h, w, dtype=dtype), torch.zeros(9, cin, cout),
            torch.zeros(cout))


@pytest.mark.parametrize("args,msg", [
    (_args(dtype=torch.float16), "float32 or bfloat16"),
    ((_args()[0], _args()[1].double(), _args()[2]), "float32 w9"),
    ((_args()[0].permute(0, 1, 3, 2), *_args()[1:]), "contiguous"),
    (_args(cout=0), "Cout"),
    ((_args()[0], torch.zeros(9, 3, 8), _args()[2]), "shape mismatch"),
    ((_args()[0], _args()[1], torch.zeros(7)), "shape mismatch"),
    ((_args()[0][0], *_args()[1:]), "takes x"),
    (_args(h=0), "non-empty"),
])
def test_wrapper_rejects_bad_inputs(args, msg):
    with pytest.raises(ValueError, match=msg):
        fused_conv.fused_conv(*args)


def test_kernel_source_uses_plain_c_interface():
    with open(os.path.join(REPO, "twingan_tpu_torch", "csrc", "fused_conv.cu")) as fh:
        src = fh.read()
    assert 'extern "C" int fused_conv3x3_leaky_pixel_norm(' in src
    assert "torch/" not in src and "ATen" not in src


def split_weights(w9: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """hi = bf16(w), lo = bf16(w - hi) (round to nearest even), in fp32."""
    hi = w9.to(torch.bfloat16).float()
    return hi, (w9 - hi).to(torch.bfloat16).float()


def mma_model(x: torch.Tensor, w9: torch.Tensor, b: torch.Tensor, splits: int) -> torch.Tensor:
    """y as the tensor-core variant rounds it: x (bf16 values, NCHW, fp32)
    times the weights' hi and lo halves, each product exact and summed in
    fp32; Cin's chunks of 16 cut into ``splits`` ranges whose partial sums
    are added in order; the fp32 epilogue; y rounded to bf16 once."""
    cin, cout = w9.shape[1:]
    hi, lo = split_weights(w9)
    chunks = -(-cin // CHUNK)
    per_split = -(-chunks // splits)
    total = None
    for c0 in range(0, chunks, per_split):
        ci = slice(c0 * CHUNK, (c0 + per_split) * CHUNK)
        part = sum(F.conv2d(x[:, ci], half[:, ci].reshape(3, 3, -1, cout).permute(3, 2, 0, 1),
                            padding=1) for half in (hi, lo))
        total = part if total is None else total + part
    y = total + b[:, None, None]
    y = torch.maximum(y * fused_conv.LEAKY_SLOPE, y)
    y = y * torch.rsqrt(torch.mean(torch.square(y), dim=1, keepdim=True)
                        + fused_conv.PIXEL_NORM_EPS)
    return y.to(torch.bfloat16).float()


def tf32_model(x: torch.Tensor, w9: torch.Tensor, b: torch.Tensor, splits: int,
               products: int = 3) -> torch.Tensor:
    """y as the TF32 variant rounds it: x (NCHW, fp32) and the weights each
    split into TF32 hi and lo halves, each product lo hi + hi lo + hi hi
    (``products=1``: one product of the TF32-rounded operands), each chunk
    of 8 input channels (all 9 taps) summed apart and added in fp32; Cin's
    chunks cut into ``splits`` ranges whose partial sums are added in order;
    the fp32 epilogue, y in fp32."""
    cin, cout = w9.shape[1:]
    (xh, xl), (wh, wl) = split_tf32(x), split_tf32(w9)
    chunks = -(-cin // TF32_CHUNK)
    per_split = -(-chunks // splits)

    def conv(xs, ws, ci):
        return F.conv2d(xs[:, ci], ws[:, ci].reshape(3, 3, -1, cout).permute(3, 2, 0, 1),
                        padding=1)

    total = None
    for c0 in range(0, chunks, per_split):
        for c in range(c0, min(c0 + per_split, chunks)):
            ci = slice(c * TF32_CHUNK, (c + 1) * TF32_CHUNK)
            part = ((conv(xl, wh, ci) + conv(xh, wl, ci)) + conv(xh, wh, ci) if products == 3
                    else conv(tf32_rna(x), tf32_rna(w9), ci))
            total = part if total is None else total + part
    y = total + b[:, None, None]
    y = torch.maximum(y * fused_conv.LEAKY_SLOPE, y)
    return y * torch.rsqrt(torch.mean(torch.square(y), dim=1, keepdim=True)
                           + fused_conv.PIXEL_NORM_EPS)


@pytest.mark.parametrize("shape,splits,dtype", [
    ((2, 8, 40, 20, 1), 3, torch.bfloat16),   # Cout not a multiple of 8; three chunks, one a split
    ((1, 16, 16, 16, 2), 1, torch.bfloat16),  # one chunk, the fused epilogue
    ((2, 4, 48, 12, 3), 2, torch.bfloat16),   # 4 px, a ragged Cout, chunks split 2 + 1
    ((2, 8, 40, 20, 4), 3, torch.float32),    # five chunks of 8, split 2 + 2 + 1
    ((1, 16, 16, 16, 5), 1, torch.float32),   # two chunks, the fused epilogue
    ((2, 4, 19, 13, 6), 2, torch.float32),    # 4 px, ragged Cin (a last chunk of 3) and Cout
], ids=["8px_40to20", "16px_16to16", "4px_48to12", "tf32_8px_40to20", "tf32_16px_16to16",
        "tf32_4px_19to13"])
def test_mma_model_within_chip_tolerance(exp, smoke, shape, splits, dtype):
    b, hw, cin, cout, seed = shape
    name = "float32" if dtype == torch.float32 else "bfloat16"
    x, w, bias = _inputs(b, hw, cin, cout, seed=seed)
    ref = _jax(exp.pallas_block, x, w, bias, dtype)
    w9, bt = torch.from_numpy(w.reshape(9, cin, cout)), torch.from_numpy(bias)

    def model(x_nhwc, **kw):
        xt = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous()
        y = (tf32_model(xt, w9, bt, splits, **kw) if dtype == torch.float32
             else mma_model(xt, w9, bt, splits))
        return y.permute(0, 2, 3, 1).numpy()

    y = model(x)
    tol = smoke.fused_conv_tolerance(name, float(np.abs(ref).max()))
    err = float(np.abs(y - ref).max())
    assert err <= tol, (err, tol)
    plain = _plain(x, w, bias, dtype)
    assert float(np.abs(y - plain).max()) <= smoke.fused_conv_tolerance(
        name, float(np.abs(plain).max()))
    if dtype == torch.float32:
        # x that neither bf16 nor TF32 holds (its lo halves are not 0),
        # against the plain version; one TF32 product misses.
        x = np.random.RandomState(seed + 10).randn(*x.shape).astype(np.float32)
        plain = _plain(x, w, bias, dtype)
        tol = smoke.fused_conv_tolerance(name, float(np.abs(plain).max()))
        assert float(np.abs(model(x) - plain).max()) <= tol
        assert float(np.abs(model(x, products=1) - plain).max()) > 4 * tol


def test_split_weights_reconstruct_fp32():
    """hi + lo carries each fp32 weight to 2^-16 of itself (the split's
    error is at most 2^-18), where bf16 alone keeps 2^-9; weights that bf16
    holds exactly have lo = 0."""
    rng = np.random.RandomState(10)
    w = torch.from_numpy((rng.randn(9, 24, 20) * np.exp(rng.uniform(-8, 8, (9, 24, 20))))
                         .astype(np.float32))
    hi, lo = split_weights(w)
    assert torch.all((w - (hi + lo)).abs() <= 2.0 ** -16 * w.abs())
    assert torch.any((w - hi).abs() > 2.0 ** -12 * w.abs())
    exact = w.to(torch.bfloat16).float()
    assert torch.equal(split_weights(exact)[1], torch.zeros_like(exact))


def test_tensor_core_source():
    """The bf16 variant is an implicit GEMM on mma.sync: x by ldmatrix, the
    split weights by ldmatrix.trans, staged by cp.async; a tile's split-K
    blocks (beside its channel tiles, in a one-pass layer) form a cluster
    and sum through distributed shared memory in rank order; the C entry
    point sends bf16 to it."""
    with open(os.path.join(REPO, "twingan_tpu_torch", "csrc", "fused_conv.cu")) as fh:
        src = fh.read()
    assert "_fused_kernel" in src and '#include "flash_mma.cuh"' in src
    body = src[src.index("fused_conv_mma_kernel("):src.index("#define FUSED_CONV_CONFIGS")]
    for op in ("mma16816(", "ldmatrix_x4(", "ldmatrix_x4_trans(", "cp_async16(",
               "__floats2bfloat162_rn(v.x - f01.x", "__shfl_xor_sync(",
               "v += cluster.map_shared_rank(part, me + cct * sp)[m * PS + col]"):
        assert op in body, op
    assert "atomicAdd" not in src
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "launch_tensor_core(" in src and "if (dtype == 0)" in src


def test_tf32_source():
    """The fp32 variant is the same implicit GEMM on the TF32 tensor cores:
    x and the weights split once each in shared memory, three tf32 mma.sync
    a fragment pair, each chunk's products in fresh accumulators added in
    fp32; the C entry point sends fp32 to it and reports it, and the
    CUDA-core kernel is gone."""
    with open(os.path.join(REPO, "twingan_tpu_torch", "csrc", "fused_conv.cu")) as fh:
        src = fh.read()
    body = src[src.index("fused_conv_mma_kernel("):src.index("#define FUSED_CONV_CONFIGS")]
    assert body.count("mma1688_tf32(cacc[mt][j + e], a[mt].") == 3
    for op in ("split_tf32(xraw[j * npos + pos])", "cp_async4(xraw", "split_tf32(v.x)",
               "acc[mt][nt][e] += cacc[mt][nt][e]", "*reinterpret_cast<const float2*>(xh"):
        assert op in body, op
    assert "#define FUSED_CONV_TF32_CONFIGS" in src
    assert "*variant = flash_mma::kTf32x3;" in src and "launch_tensor_core<float>(" in src
    for gone in ("fused_conv_kernel", "launch_cuda_core", "kChannelsPerThread"):
        assert gone not in src, gone


def test_variants_by_type():
    """fp32 x takes the TF32 variant, bf16 the tensor-core one; the C entry
    point reports the variant it launched by the ids of VARIANT_IDS, which
    the counts record."""
    assert fused_conv.VARIANTS == {torch.float32: "tensor_core_tf32x3",
                                   torch.bfloat16: "tensor_core"}
    assert set(fused_conv.variant_counts) == {"fused_conv/tensor_core_tf32x3",
                                              "fused_conv/tensor_core"}
    with open(os.path.join(REPO, "twingan_tpu_torch", "csrc", "fused_conv.cu")) as fh:
        head = fh.read().split('extern "C" int fused_conv3x3_leaky_pixel_norm(')[1]
    assert "void* stream,\n" in head[:head.index("{")] and "int* variant)" in head[:head.index("{")]
    fused_conv.reset_launch_counts()
    try:
        fused_conv._count(ctypes.c_int(2))
        assert fused_conv.variant_counts["fused_conv/tensor_core_tf32x3"] == 1
        assert fused_conv.launch_counts[fused_conv.KERNEL_NAME] == 1
        with pytest.raises(RuntimeError, match="reported no variant"):
            fused_conv._count(ctypes.c_int(3))
        assert fused_conv.launch_counts[fused_conv.KERNEL_NAME] == 1
    finally:
        fused_conv.reset_launch_counts()


def test_bf16_on_the_cpu_runs_the_plain_version():
    x, w, bias = _inputs(2, 6, 5, 12, seed=11)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().bfloat16()
    w9, b = torch.from_numpy(w.reshape(9, 5, 12)), torch.from_numpy(bias)
    fused_conv.reset_launch_counts()
    y = fused_conv.fused_conv(xt, w9, b)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, fused_conv.fused_conv_plain(xt, w9, b), rtol=0, atol=0)
    assert not any(fused_conv.launch_counts.values())
    assert not any(fused_conv.variant_counts.values())
