"""The W8A8 primitives of the port (``ops/quant.py``) and ``EqConv``'s
quantize modes against the JAX package's (``twingan_tpu/ops/quant.py``,
``models/layers.py:EqConv``).

- The ops exactly: ``act_scale``, ``quantize`` (ties included, and the
  multiply by the reciprocal, which rounds otherwise than a division),
  ``weight_quant`` (per output channel, OIHW against HWIO),
  ``up2_conv_kernel``, and the int32 sums of ``conv_i8_plain`` against
  JAX's ``conv_i8`` for 1x1, 3x3 SAME, 4x4 VALID and the dilation-2
  padding-2 up case, with Cin not a multiple of 4. The epilogue in float32
  equals JAX's ``conv.astype(f32) * scale + bias``; in bf16 it rounds at
  each step, the int32 going to bf16 through float32.
- ``EqConv`` under "calib": the running abs-max over two batches equals
  JAX's, and the output equals the fp layer's. Under "int8", with and
  without the aux input (the fused-scale split), eq-lr and spectral norm,
  in float64 on both sides (``torch_quant_parity``), within 1e-6 of JAX's.

Kernel Q1 itself runs only on the card (``chip_smoke.py`` holds it to this
plain version bit for bit).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_twingan_step import _unoptimized_jax_reference  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.models.layers import EqConv as JaxEqConv  # noqa: E402
from twingan_tpu.ops import fused_scale as jfused_scale  # noqa: E402
from twingan_tpu.ops import quant as jquant  # noqa: E402

from twingan_tpu_torch.models.layers import EqConv  # noqa: E402
from twingan_tpu_torch.ops import quant  # noqa: E402

from torch_quant_parity import (  # noqa: E402
    as_float64,
    float64_jax,
    float64_port,
    two_torch_threads,
)

_two_torch_threads = pytest.fixture(autouse=True, scope="module")(two_torch_threads)

ATOL64 = 1e-6


def _np(t):
    return t.detach().cpu().numpy()


def test_act_scale_and_quantize_equal_jax_ties_included():
    rng = np.random.RandomState(0)
    # a_max 127: scale 1, so k + 0.5 are exact ties; half to even.
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 200.0, -300.0], np.float32)
    got = _np(quant.quantize(torch.from_numpy(ties), quant.act_scale(torch.tensor(127.0))))
    want = np.asarray(jquant.quantize(jnp.asarray(ties), jquant.act_scale(jnp.asarray(127.0))))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 2, 2, 0, -2, -2, 126, 127, -127])
    assert got.dtype == np.int8
    # Uniform inputs, and inputs a few ulps around each half-way point k + 0.5
    # of the code grid, where x * (1/s) and x / s round apart: the port must
    # follow the JAX multiply on every one.
    for a_max in (0.0, 3.7, 0.013, 1e-9, 255.0):
        s_port = quant.act_scale(torch.tensor(a_max))
        s_jax = jquant.act_scale(jnp.asarray(a_max, jnp.float32))
        assert float(s_port) == float(s_jax)
        s = np.float32(s_jax)
        x0 = ((np.arange(-127, 127, dtype=np.float32) + np.float32(0.5)) * s).astype(np.float32)
        near = np.concatenate([x0 + np.float32(d) * np.spacing(x0) for d in range(-3, 4)])
        x = np.concatenate([near, rng.uniform(-1.2, 1.2, 20000) * max(a_max, 1e-8)])
        x = x.astype(np.float32)
        got = _np(quant.quantize(torch.from_numpy(x), s_port))
        np.testing.assert_array_equal(got, np.asarray(jquant.quantize(jnp.asarray(x), s_jax)))
        if a_max == 3.7:  # the test can tell the two apart
            assert (np.clip(np.round(x / s), -127, 127) != got).sum() > 10


def test_weight_quant_equals_jax_per_output_channel():
    rng = np.random.RandomState(1)
    w_hwio = rng.randn(3, 3, 5, 7).astype(np.float32)
    w_hwio[..., 0] = 0.0  # an all-zero channel: the 1e-8 floor
    w_hwio[0, 0, 0, 1] = 127.0  # channel 1's scale is 1: its ties are exact
    w_hwio[1, 1, 1:4, 1] = [0.5, 1.5, -2.5]
    wq, s = quant.weight_quant(torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy()))
    jwq, js = jquant.weight_quant(jnp.asarray(w_hwio))
    np.testing.assert_array_equal(_np(s), np.asarray(js))
    np.testing.assert_array_equal(_np(wq), np.asarray(jwq).transpose(3, 2, 0, 1))
    assert _np(wq)[1, 1:4, 1, 1].tolist() == [0, 2, -2]


def test_up2_conv_kernel_equals_jax():
    w_hwio = np.random.RandomState(2).randn(3, 3, 4, 6).astype(np.float32)
    got = quant.up2_conv_kernel(torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy()))
    want = np.asarray(jfused_scale.up2_conv_kernel(jnp.asarray(w_hwio)))
    np.testing.assert_array_equal(_np(got), want.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("k,padding,jax_padding,dilation,cin", [
    (1, (0, 0, 0, 0), "SAME", 1, 3),
    (3, (1, 1, 1, 1), "SAME", 1, 10),
    (4, (0, 0, 0, 0), "VALID", 1, 8),
    (4, (2, 2, 2, 2), ((2, 2), (2, 2)), 2, 6),
])
def test_conv_i8_plain_equals_jax(k, padding, jax_padding, dilation, cin):
    rng = np.random.RandomState(3)
    xq = rng.randint(-127, 128, (2, 7, 9, cin)).astype(np.int8)
    wq = rng.randint(-127, 128, (k, k, cin, 5)).astype(np.int8)
    want = np.asarray(jquant.conv_i8(
        jnp.asarray(xq), jnp.asarray(wq), (1, 1), jax_padding,
        lhs_dilation=(dilation, dilation) if dilation > 1 else None)).transpose(0, 3, 1, 2)
    x_words = quant.nhwc_words(torch.from_numpy(xq).permute(0, 3, 1, 2))
    w_words = quant.weight_words(torch.from_numpy(wq.transpose(3, 2, 0, 1)))
    assert x_words.shape[-1] % 4 == 0 and x_words.is_contiguous()
    got = quant.conv_i8_plain(x_words, w_words, padding, dilation)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(quant.conv_i8(x_words, w_words, padding=padding,
                                                    dilation=dilation)), want)

    # The float32 epilogue: conv.astype(f32) * (s_x * s_w).astype(f32) + bias.
    scale = rng.uniform(1e-4, 1e-2, 5).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    y = quant.conv_i8(x_words, w_words, torch.from_numpy(scale), torch.from_numpy(bias),
                      padding, dilation, torch.float32)
    jy = jnp.asarray(want).astype(jnp.float32) * jnp.asarray(scale)[:, None, None]
    jy = jy + jnp.asarray(bias)[:, None, None]
    np.testing.assert_array_equal(_np(y), np.asarray(jy))

    # bf16: each step rounded to bf16, int32 -> float32 -> bf16 first.
    y16 = quant.conv_i8(x_words, w_words, torch.from_numpy(scale).bfloat16().float(),
                        torch.from_numpy(bias).bfloat16().float(), padding, dilation,
                        torch.bfloat16)
    step = got.float().bfloat16().float() * torch.from_numpy(scale).bfloat16().float()[
        :, None, None]
    step = step.bfloat16().float() + torch.from_numpy(bias).bfloat16().float()[:, None, None]
    assert y16.dtype == torch.bfloat16
    assert torch.equal(y16, step.bfloat16())


def test_conv_i8_refuses_what_the_kernel_cannot_take():
    x = torch.zeros(1, 4, 4, 4, dtype=torch.int8)
    w = torch.zeros(2, 3, 3, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 4"):
        quant.conv_i8(x[..., :3].contiguous(), w[..., :3].contiguous())
    with pytest.raises(ValueError, match="int8"):
        quant.conv_i8(x.float(), w)
    with pytest.raises(ValueError, match="dilation"):
        quant.conv_i8(x, w, dilation=3)
    with pytest.raises(ValueError, match="no output"):
        quant.conv_i8(x, torch.zeros(2, 5, 5, 4, dtype=torch.int8))


def _jax_conv(mode, scale_mode, eq_lr, sn, features=6):
    return JaxEqConv(features=features, equalized_lr=eq_lr, spectral_norm=sn,
                     dtype=jnp.float32, scale_mode=scale_mode, quantize=mode)


def _port_conv(variables, in_ch, eq_lr, sn, mode, dtype=torch.float32, features=6):
    conv = EqConv(in_ch, features, 3, equalized_lr=eq_lr, spectral_norm=sn, dtype=dtype,
                  quantize=mode)
    p = variables["params"]
    state = {"kernel": torch.from_numpy(np.asarray(p["kernel"]).transpose(3, 2, 0, 1).copy()),
             "bias": torch.from_numpy(np.asarray(p["bias"]).copy())}
    if sn:
        state["u"] = torch.from_numpy(np.asarray(variables["spectral"]["u"]).copy())
    if "quant" in variables:
        state["a_max"] = torch.from_numpy(np.asarray(variables["quant"]["a_max"]).copy())
    conv.load_state_dict(state, strict=True)
    return conv


def _data(seed=4, aux=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    a = rng.randn(2, 12, 12, 5).astype(np.float32) * 3.0 if aux else None
    return x, a


def _nchw(a):
    return None if a is None else torch.from_numpy(a.transpose(0, 3, 1, 2).copy())


def _nchw64(a):
    return None if a is None else _nchw(a).double()


def test_eqconv_calib_is_a_running_max_and_the_fp_layer():
    x, _ = _data(aux=False)
    jconv = _jax_conv("calib", None, True, False)
    v = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {**v, "params": {**v["params"], "bias": jnp.asarray(np.linspace(-1, 1, 6),
                                                            jnp.float32)}}
    _, u1 = jconv.apply(v, jnp.asarray(0.5 * x), mutable=["quant"])
    _, u2 = jconv.apply({**v, **u1}, jnp.asarray(x), mutable=["quant"])
    _, u3 = jconv.apply({**v, **u2}, jnp.asarray(0.25 * x), mutable=["quant"])

    conv = _port_conv(v, 8, True, False, "calib")
    fp = _port_conv({"params": v["params"]}, 8, True, False, "")
    assert "a_max" not in fp.state_dict()  # no quant buffer without a mode
    with torch.no_grad():
        for scale in (0.5, 1.0, 0.25):
            y = conv(_nchw(scale * x))
            assert torch.equal(y, fp(_nchw(scale * x)))
    np.testing.assert_array_equal(_np(conv.a_max), np.asarray(u3["quant"]["a_max"]))
    assert float(conv.a_max[0]) == float(np.abs(x).max()) and float(conv.a_max[1]) == 0.0
    assert conv.calib_slots == {0}


@pytest.mark.parametrize("aux", [False, True], ids=["plain", "up_aux"])
@pytest.mark.parametrize("eq_lr,sn", [(True, False), (False, True), (True, True)])
def test_eqconv_int8_equals_jax_in_float64(aux, eq_lr, sn):
    x, a = _data(aux=aux)
    scale_mode = "up" if aux else None
    jcal = _jax_conv("calib", scale_mode, eq_lr, sn)
    args = (jnp.asarray(x), jnp.asarray(a)) if aux else (jnp.asarray(x),)
    v = jcal.init(jax.random.PRNGKey(1), *args)
    rng = np.random.RandomState(5)
    v = {**v, "params": {"kernel": v["params"]["kernel"],
                         "bias": jnp.asarray(rng.randn(6), jnp.float32)}}
    v64 = as_float64(jax.device_get(v))
    with float64_jax():
        args64 = tuple(jnp.asarray(t, jnp.float64) for t in ((x, a) if aux else (x,)))
        _, upd = _jax_conv("calib", scale_mode, eq_lr, sn).apply(v64, *args64,
                                                                  mutable=["quant"])
        v64 = {**v64, "quant": upd["quant"]}
        want = np.asarray(_jax_conv("int8", scale_mode, eq_lr, sn).apply(v64, *args64))
        want_fp = np.asarray(_jax_conv("", scale_mode, eq_lr, sn).apply(
            {k: v64[k] for k in v64 if k != "quant"}, *args64))
    with float64_port():
        conv = _port_conv(jax.device_get(v64), 13 if aux else 8, eq_lr, sn, "calib",
                          dtype=torch.float64)
        conv.a_max.zero_()
        with torch.no_grad():
            conv(_nchw64(x), aux=_nchw64(a), up=aux)  # calibrate the port itself
            np.testing.assert_allclose(_np(conv.a_max), np.asarray(v64["quant"]["a_max"]),
                                       rtol=1e-12)
            conv.set_quantize("int8")
            got = _np(conv(_nchw64(x), aux=_nchw64(a), up=aux)).transpose(0, 2, 3, 1)
    assert got.shape == want.shape == ((2, 12, 12, 6) if aux else (2, 6, 6, 6))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL64)
    # int8 is not the fp layer (the test would see a route that skips Q1).
    assert np.abs(got - want_fp).max() > 1e-4


def test_every_kernel_op_passes_opcheck():
    """B1-B4 and Q1 as ``torch.library`` custom ops: schema, fake
    implementation (shapes, dtypes and strides of the CPU implementation,
    which ``torch.export`` traces with) and dispatch, by ``opcheck``."""
    from twingan_tpu_torch.ops import attention

    rng = torch.Generator().manual_seed(0)
    f, g = torch.randn(2, 16, 4, generator=rng), torch.randn(2, 16, 4, generator=rng)
    h = torch.randn(2, 16, 8, generator=rng)
    o, lse = attention.flash_attention_forward(f, g, h)
    do = torch.randn(h.shape, generator=rng)
    delta = (do * o).sum(-1)
    x8 = torch.randint(-127, 128, (2, 5, 5, 8), dtype=torch.int8, generator=rng)
    w3 = torch.randint(-127, 128, (3, 3, 3, 8), dtype=torch.int8, generator=rng)
    w4 = torch.randint(-127, 128, (3, 4, 4, 8), dtype=torch.int8, generator=rng)
    ops = torch.ops.twingan_tpu_torch
    cases = [
        (ops.flash_attn_fwd.default, (f, g, h)),
        (ops.flash_attn_dq.default, (f, g, h, do, lse, delta)),
        (ops.flash_attn_dkv.default, (f, g, h, do, lse, delta)),
        (ops.fused_conv.default, (torch.randn(1, 3, 5, 5, generator=rng),
                                  torch.randn(9, 3, 4, generator=rng), torch.randn(4))),
        (ops.conv_i8.default, (x8, w3, torch.rand(3), torch.randn(3), [1, 1, 1, 1], 1,
                               torch.float32)),
        (ops.conv_i8.default, (x8, w4, None, None, [2, 2, 2, 2], 2, torch.int32)),
        (ops.conv_i8.default, (x8, w3, torch.rand(3), None, [0, 0, 0, 0], 1, torch.bfloat16)),
    ]
    for op, args in cases:
        torch.library.opcheck(op, args)
