"""Kernel Q1's fused entry ``conv_i8q`` (the activation quantized as Q1
loads it, ``ops/quant.py``) and the int8 values ``EqConv`` keeps between
forwards, against the JAX package (``twingan_tpu/ops/quant.py``,
``models/layers.py:EqConv``).

- ``conv_i8q`` on the CPU (its plain version) against JAX's ``quantize`` +
  ``conv_i8`` + the layer's epilogue: the int32 sums bit-equal, the
  float32 output equal to ``conv.astype(f32) * scale + bias``, the bf16
  output each step rounded to bf16; from bf16 and float32 x, for Cin 3 and
  10, Cout 3 and 8, 1x1, 3x3 SAME, 4x4 VALID and the dilation-2 up case;
  inputs on exact half-way points of x * (1 / s) and past +-127 codes; a
  strided (NHWC-backed) x equal to its contiguous copy.
- ``torch.library.opcheck`` of the op, the refusals of what the kernel
  cannot take, and the wrapper's ctypes argument types against the C
  entry points' signatures in ``csrc/conv_i8.cu``.
- ``EqConv`` under "int8": after a served batch, the weights changed in
  place, by ``load_state_dict``, a raised ``a_max`` and a mode switch give
  the output of a freshly built layer bit for bit (plain, spectral norm,
  and the fused-scale up conv with its aux input), the weight work runs
  once while nothing changes, and ``state_dict`` keeps its keys.

The kernel itself runs only on the card (``chip_smoke.py`` holds both
entries to these plain versions bit for bit).
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from twingan_tpu.ops import quant as jquant  # noqa: E402

from twingan_tpu_torch.models.layers import EqConv  # noqa: E402
from twingan_tpu_torch.ops import quant  # noqa: E402

from torch_quant_parity import two_torch_threads  # noqa: E402

_two_torch_threads = pytest.fixture(autouse=True, scope="module")(two_torch_threads)

# (k, padding (top, bottom, left, right), JAX padding, dilation, Cin, Cout)
CASES = [
    (1, (0, 0, 0, 0), "SAME", 1, 3, 8),
    (3, (1, 1, 1, 1), "SAME", 1, 10, 3),
    (4, (0, 0, 0, 0), "VALID", 1, 10, 8),
    (4, (2, 2, 2, 2), ((2, 2), (2, 2)), 2, 3, 3),
]


def _inputs(seed, cin, a_max):
    """x [2, Cin, 9, 11] float32 with half-way points and values past the
    clip, whose bf16 rounding keeps them (a_max 127: scale 1)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.3, 1.3, (2, cin, 9, 11)).astype(np.float32) * np.float32(a_max)
    flat = x.reshape(-1)
    flat[::5] = (rng.randint(-127, 127, flat[::5].shape) + 0.5).astype(np.float32)
    flat[1::13] = rng.choice([300.0, -1e4, 127.5, -127.5], flat[1::13].shape)
    return x


@pytest.mark.parametrize("in_type", [torch.float32, torch.bfloat16], ids=["fp32_in", "bf16_in"])
@pytest.mark.parametrize("k,padding,jax_padding,dilation,cin,cout", CASES,
                         ids=["1x1", "3x3_same", "4x4_valid", "up_dil2"])
def test_conv_i8q_equals_jax_quantize_conv_and_epilogue(k, padding, jax_padding, dilation,
                                                         cin, cout, in_type):
    rng = np.random.RandomState(7)
    x32 = _inputs(11, cin, 127.0)
    x = torch.from_numpy(x32).to(in_type)
    xj = x.float().numpy()  # the values both sides read (bf16 rounded)
    s_x = quant.act_scale(torch.tensor(127.0))
    assert float(s_x) == 1.0  # so k + 0.5 is an exact tie: half to even
    js_x = jquant.act_scale(jnp.asarray(127.0))
    wq = rng.randint(-127, 128, (k, k, cin, cout)).astype(np.int8)
    xq = jquant.quantize(jnp.asarray(xj.transpose(0, 2, 3, 1)), js_x)
    assert (np.abs(np.asarray(xq)) == 127).any() and (np.asarray(xq) % 2 == 0).any()
    want = np.asarray(jquant.conv_i8(
        xq, jnp.asarray(wq), (1, 1), jax_padding,
        lhs_dilation=(dilation, dilation) if dilation > 1 else None)).transpose(0, 3, 1, 2)
    w_words = quant.weight_words(torch.from_numpy(wq.transpose(3, 2, 0, 1).copy()))
    rscale = torch.reciprocal(s_x)

    got = quant.conv_i8q(x, rscale, w_words, padding=padding, dilation=dilation)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)

    scale = rng.uniform(1e-4, 1e-2, cout).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    y = quant.conv_i8q(x, rscale, w_words, torch.from_numpy(scale), torch.from_numpy(bias),
                       padding, dilation, torch.float32)
    jy = jnp.asarray(want).astype(jnp.float32) * jnp.asarray(scale)[:, None, None]
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy + jnp.asarray(bias)[:, None, None]))

    sc16, b16 = torch.from_numpy(scale).bfloat16().float(), torch.from_numpy(bias).bfloat16()
    y16 = quant.conv_i8q(x, rscale, w_words, sc16, b16.float(), padding, dilation,
                         torch.bfloat16)
    step = (torch.tensor(want).float().bfloat16().float() * sc16[:, None, None]).bfloat16()
    step = (step.float() + b16.float()[:, None, None]).bfloat16()
    assert y16.dtype == torch.bfloat16 and torch.equal(y16, step)

    # The fused entry is the int8 entry after quantize and the NHWC copy.
    x_words = quant.nhwc_words(quant.quantize(x, s_x))
    assert torch.equal(y16, quant.conv_i8(x_words, w_words, sc16, b16.float(), padding,
                                          dilation, torch.bfloat16))


def test_conv_i8q_reads_strided_x_and_a_generic_scale():
    rng = np.random.RandomState(3)
    a_max = np.float32(3.7)
    x = torch.from_numpy(_inputs(4, 10, a_max).transpose(0, 2, 3, 1).copy()).permute(0, 3, 1, 2)
    assert not x.is_contiguous()  # an NCHW view of NHWC memory, as the encoder gets images
    s_x = quant.act_scale(torch.tensor(a_max))
    wq = torch.from_numpy(rng.randint(-127, 128, (8, 3, 3, 12)).astype(np.int8))
    got = quant.conv_i8q(x, torch.reciprocal(s_x), wq, padding=(1, 1, 1, 1))
    assert torch.equal(got, quant.conv_i8q(x.contiguous(), torch.reciprocal(s_x), wq,
                                           padding=(1, 1, 1, 1)))
    xq = jquant.quantize(jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                         jquant.act_scale(jnp.asarray(a_max)))
    want = np.asarray(jquant.conv_i8(xq, jnp.asarray(wq.permute(1, 2, 3, 0)[:, :, :10].numpy())))
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))


def test_conv_i8q_passes_opcheck_and_refuses_what_the_kernel_cannot_take():
    rng = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 5, 5, generator=rng)
    r = torch.tensor(20.0)
    w3 = torch.randint(-127, 128, (3, 3, 3, 8), dtype=torch.int8, generator=rng)
    w4 = torch.randint(-127, 128, (3, 4, 4, 8), dtype=torch.int8, generator=rng)
    op = torch.ops.twingan_tpu_torch.conv_i8q.default
    for args in [(x, r, w3, torch.rand(3), torch.randn(3), [1, 1, 1, 1], 1, torch.float32),
                 (x.bfloat16(), r, w4, None, None, [2, 2, 2, 2], 2, torch.int32),
                 (x, r, w3, torch.rand(3), None, [0, 0, 0, 0], 1, torch.bfloat16)]:
        torch.library.opcheck(op, args)
    with pytest.raises(ValueError, match="float x"):
        quant.conv_i8q(x.to(torch.int8), r, w3)
    with pytest.raises(ValueError, match="rounded up to 4"):
        quant.conv_i8q(x, r, w3[..., :6].contiguous())
    with pytest.raises(ValueError, match="one float rscale"):
        quant.conv_i8q(x, torch.ones(2), w3)
    with pytest.raises(ValueError, match="dilation"):
        quant.conv_i8q(x, r, w3, dilation=3)
    with pytest.raises(ValueError, match="no output"):
        quant.conv_i8q(x, r, torch.zeros(2, 6, 6, 8, dtype=torch.int8))
    with pytest.raises(ValueError, match="contiguous"):
        quant.conv_i8q(x, r, w3.transpose(1, 2))
    with pytest.raises(ValueError, match="one device"):
        quant.conv_i8q(x, r.to("meta"), w3)


@pytest.mark.parametrize("entry", ["conv_i8"])
def test_ctypes_argument_types_match_the_c_entry_points(entry):
    import ctypes

    path = os.path.join(os.path.dirname(quant.__file__), "..", "csrc", "conv_i8.cu")
    with open(path) as fh:
        source = fh.read()
    params = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", source).group(1)
    kinds = {"int": ctypes.c_int, "int64_t": ctypes.c_int64}
    want = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
            for p in (q.strip() for q in params.split(","))]
    assert quant.C_ARGTYPES[entry] == want


def _int8_conv(kind, seed=0):
    """A calibrated int8 EqConv (bf16, eq-lr): "plain", "sn" or "up"."""
    torch.manual_seed(seed)
    conv = EqConv(12 if kind == "up" else 8, 6, 3, equalized_lr=True,
                  spectral_norm=kind == "sn", dtype=torch.bfloat16, quantize="int8")
    conv.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        conv.bias.copy_(torch.linspace(-1, 1, 6))
        conv.a_max.copy_(torch.tensor([2.5, 4.0]))
    return conv


def _batch(kind, seed=1):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(2, 8, 6, 6).astype(np.float32)).bfloat16()
    aux = torch.from_numpy(rng.randn(2, 4, 12, 12).astype(np.float32)) if kind == "up" else None
    return x, aux


def _fresh_output(conv, kind, x, aux):
    """The same layer built anew from ``conv``'s state: nothing kept."""
    fresh = _int8_conv(kind, seed=99)
    fresh.load_state_dict(conv.state_dict())
    with torch.no_grad():
        return fresh(x, aux=aux, up=kind == "up")


@pytest.mark.parametrize("kind", ["plain", "sn", "up"])
def test_eqconv_int8_kept_values_follow_every_change(kind, monkeypatch):
    conv = _int8_conv(kind)
    x, aux = _batch(kind)
    keys = set(conv.state_dict())
    calls = []
    real = quant.weight_quant
    monkeypatch.setattr(quant, "weight_quant", lambda w: calls.append(1) or real(w))

    def run():
        """The layer's output and the weight quantizations it ran."""
        n = len(calls)
        y = conv(x, aux=aux, up=kind == "up")
        return y, len(calls) - n

    n_prep = 2 if kind == "up" else 1
    with torch.no_grad():
        y0, n = run()
        assert n == n_prep
        y, n = run()
        assert torch.equal(y, y0) and n == 0  # served from what was kept
        assert torch.equal(y0, _fresh_output(conv, kind, x, aux))

        conv.kernel.mul_(-0.5)  # in place
        y1, n = run()
        assert n == n_prep and not torch.equal(y1, y0)
        assert torch.equal(y1, _fresh_output(conv, kind, x, aux))

        other = _int8_conv(kind, seed=5)
        conv.load_state_dict(other.state_dict())
        y2, n = run()
        assert n == n_prep and not torch.equal(y2, y1)
        assert torch.equal(y2, _fresh_output(other, kind, x, aux))

        conv.a_max.copy_(torch.maximum(conv.a_max, torch.tensor([6.0, 9.0])))  # a raise
        y3, n = run()
        assert n == 0 and not torch.equal(y3, y2)  # the weights kept, the scales not
        assert torch.equal(y3, _fresh_output(conv, kind, x, aux))

        conv.bias.add_(1.0)
        assert torch.equal(run()[0], _fresh_output(conv, kind, x, aux))

        if kind == "sn":
            conv.u.copy_(torch.flip(conv.u, (0,)))
            y4, n = run()
            assert n == n_prep and torch.equal(y4, _fresh_output(conv, kind, x, aux))

        conv.set_quantize("calib")
        conv(x.float() * 3, aux=aux, up=kind == "up")  # raises a_max
        conv.set_quantize("int8")
        assert torch.equal(run()[0], _fresh_output(conv, kind, x, aux))
    assert set(conv.state_dict()) == keys  # nothing kept is state
