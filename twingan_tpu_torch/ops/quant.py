"""W8A8 int8 convolution for serving: quantization and kernel Q1.

Counterpart of ``twingan_tpu/ops/quant.py``, with the same numerics:

- symmetric int8 in [-127, 127] (``QMAX``; -128 unused);
- ``act_scale``: a calibrated abs-max -> the activation's scale,
  ``max(a_max, 1e-8) / 127`` in float32;
- ``quantize``: ``round(x.float() * (1 / scale))``, clipped, as int8. It
  multiplies by the reciprocal, as the JAX function does; ``x / scale``
  rounds differently at the half-way points. Rounding is half to even
  (``torch.round``, like ``jnp.round``);
- ``weight_quant``: per-output-channel scales of an OIHW kernel, taken over
  the other three axes (the JAX function takes them over the first three
  axes of HWIO), and ``round(w / s)``, clipped;
- ``up2_conv_kernel``: the port's copy of
  ``twingan_tpu/ops/fused_scale.py:up2_conv_kernel``, the 4x4 kernel V = W
  (*) ones(2, 2) of the input-dilated conv that equals conv3x3 of the
  nearest 2x upsample, summed in the JAX order.

The int8 conv is kernel Q1, ``csrc/conv_i8.cu`` (CUDA C++ on the int8
tensor cores, ``mma.sync`` m16n8k32 into int32, the dequantize epilogue
fused), with two entries, each a custom op:

- ``twingan_tpu_torch::conv_i8`` (``conv_i8``) takes x as int8 NHWC with
  the channels padded with zeros to a multiple of 4 (``nhwc_words``);
- ``twingan_tpu_torch::conv_i8q`` (``conv_i8q``, the serving path) takes
  the layer's float NCHW activation and the float32 reciprocal of its
  scale, and quantizes x as it loads it, as ``quantize`` does: the int8
  tensor and its NHWC copy are never made.

Both take the weights as int8 [Cout, kh, kw, Cin_pad] (``weight_words``)
and write NCHW: the int32 sums, or ``float(acc) -> dtype``, times
``scale`` (already in the output type), plus ``bias`` (the same), each
step rounded to the output type, as the JAX layer computes
``conv.astype(dt) * (s_x * s_w).astype(dt) + bias.astype(dt)``.

- ``conv_i8_plain`` is the plain version of the sums: the int8 values in
  float64 through ``F.conv2d`` and back to int32, exact (every partial
  sum is an integer below 2^53); input dilation by zero-stuffing;
  ``dequantize_plain`` the epilogue's. ``conv_i8q``'s plain version is
  ``quantize_recip`` -> ``nhwc_words`` -> ``conv_i8_plain`` ->
  ``dequantize_plain``.
- On a CUDA tensor each op launches Q1 or raises; on a CPU tensor it runs
  the plain version. The ops' CUDA implementations add one to
  ``launch_counts`` per launch, so the launches of an exported program
  count too.
- A layer's W8A8 conv is ``conv_prep`` (the weight-only part: quantized
  weights in Q1's layout and their scales), ``conv_scales`` (the
  per-activation part) and one ``conv_i8q``; ``models/layers.py:EqConv``
  keeps the first two while their inputs are unchanged.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from twingan_tpu_torch.ops import cuda_build

QMAX = 127.0
KERNEL_NAME = "conv_i8"  # the library (csrc/conv_i8.cu) and its int8 entry
FUSED_NAME = "conv_i8q"  # the entry that quantizes x as it loads it
VARIANT = "tensor_core"  # mma.sync m16n8k32 s8: the kernel's one variant
# The output types the kernel writes, by its out_kind code.
KERNEL_OUT_KINDS = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
# The types of x each entry reads, by its in_kind code.
KERNEL_IN_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}

# The ctypes argument types of the library's C entry points, in order.
_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
C_ARGTYPES = {
    "conv_i8": [_VP, _I32, _VP, _VP, _VP, _VP, _VP] + [_I32] * 15 + [_I64] * 4 + [_VP],
}

# Q1's launches by entry since the last reset_launch_counts(); only the
# ops' CUDA implementations add to them, once per launch.
launch_counts = {KERNEL_NAME: 0, FUSED_NAME: 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _over_qmax(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division on every device. PyTorch's CUDA kernel
    turns division by a Python scalar into multiplication by its reciprocal,
    which rounds otherwise in the last bit: the card's scales would differ
    from the CPU's and the JAX package's."""
    return t / torch.full_like(t, QMAX)


def act_scale(a_max: torch.Tensor) -> torch.Tensor:
    """Calibrated abs-max -> the activation's multiplicative scale (float32)."""
    return _over_qmax(torch.clamp(a_max.float(), min=1e-8))


def quantize_recip(x: torch.Tensor, rscale: torch.Tensor) -> torch.Tensor:
    """A float tensor -> int8 given the reciprocal of its scale:
    round(x * rscale), half to even, clipped to [-127, 127]."""
    q = torch.round(x.float() * rscale)
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A float tensor -> int8 with a static scale: round(x * (1 / scale))."""
    return quantize_recip(x, torch.reciprocal(scale))


def weight_quant(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An OIHW kernel -> (int8 kernel, per-output-channel scale [O])."""
    a_max = torch.amax(torch.abs(w), dim=tuple(range(1, w.dim())))
    s = _over_qmax(torch.clamp(a_max, min=1e-8))
    wq = torch.clamp(torch.round(w / s.reshape(-1, *([1] * (w.dim() - 1)))), -QMAX, QMAX)
    return wq.to(torch.int8), s


def up2_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """OIHW [O, I, 3, 3] -> [O, I, 4, 4]: V = W (*) ones(2, 2), the kernel of
    the input-dilated conv equal to conv3x3(nearest_up2(x)). The four
    shifted copies are added in the JAX order, so V is the same to the bit."""
    if w.shape[2:] != (3, 3):
        raise ValueError(f"up2_conv_kernel takes a 3x3 kernel, got {tuple(w.shape)}")
    v = torch.zeros(*w.shape[:2], 4, 4, dtype=w.dtype, device=w.device)
    for a in (0, 1):
        for b in (0, 1):
            v[:, :, a:a + 3, b:b + 3] += w
    return v


def _pad4(t: torch.Tensor) -> torch.Tensor:
    """The last axis padded with zeros to a multiple of 4, contiguous."""
    extra = -t.shape[-1] % 4
    return F.pad(t, (0, extra)) if extra else t.contiguous()


def nhwc_words(xq: torch.Tensor) -> torch.Tensor:
    """int8 NCHW -> Q1's x: NHWC, channels padded to a multiple of 4."""
    return _pad4(xq.permute(0, 2, 3, 1))


def weight_words(wq: torch.Tensor) -> torch.Tensor:
    """int8 OIHW -> Q1's weights: [O, kh, kw, I_pad]."""
    return _pad4(wq.permute(0, 2, 3, 1))


def output_hw(x_hw: Sequence[int], kernel_hw: Sequence[int], padding: Sequence[int],
              dilation: int) -> tuple[int, int]:
    """(Ho, Wo) of the input-dilated conv; padding is (top, bottom, left, right)."""
    (h, w), (kh, kw) = x_hw, kernel_hw
    t, b, left, right = padding
    return ((h - 1) * dilation + 1 + t + b - kh + 1,
            (w - 1) * dilation + 1 + left + right - kw + 1)


def conv_i8_plain(xq: torch.Tensor, wq: torch.Tensor, padding: Sequence[int] = (0, 0, 0, 0),
                  dilation: int = 1) -> torch.Tensor:
    """Plain version of Q1's sums: xq int8 NHWC [B, H, W, Cp], wq int8
    [Cout, kh, kw, Cp] -> int32 NCHW [B, Cout, Ho, Wo], exact."""
    x = xq.permute(0, 3, 1, 2).double()
    if dilation > 1:
        b, c, h, w = x.shape
        xd = x.new_zeros(b, c, (h - 1) * dilation + 1, (w - 1) * dilation + 1)
        xd[:, :, ::dilation, ::dilation] = x
        x = xd
    t, bottom, left, right = padding
    x = F.pad(x, (left, right, t, bottom))
    return F.conv2d(x, wq.permute(0, 3, 1, 2).double()).to(torch.int32).contiguous()


def dequantize_plain(acc: torch.Tensor, scale: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """Plain version of Q1's epilogue: int32 NCHW -> float(acc) -> dtype,
    times scale and plus bias in dtype; the int32 sums for dtype int32."""
    if dtype == torch.int32:
        return acc.clone()
    y = acc.float().to(dtype) * scale.to(dtype)[:, None, None]
    if bias is not None:
        y = y + bias.to(dtype)[:, None, None]
    return y


def _launch(name: str, x: torch.Tensor, rscale: Optional[torch.Tensor], wq: torch.Tensor,
            scale, bias, padding, dilation, dtype) -> torch.Tensor:
    """One launch of Q1: x int8 NHWC (``conv_i8``) or float NCHW with its
    rscale (``conv_i8q``)."""
    if dtype not in KERNEL_OUT_KINDS:
        raise ValueError(f"{name} writes {sorted(map(str, KERNEL_OUT_KINDS))}, not {dtype}")
    if x.dtype not in KERNEL_IN_KINDS:
        raise ValueError(f"{name} reads int8, bfloat16 or float32 x on the card, not {x.dtype}")
    floats = [t for t in (rscale, scale, bias) if t is not None]
    if dtype != torch.int32 and scale is None:
        raise ValueError(f"{name} to {dtype} takes a scale")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in floats):
        raise ValueError(f"{name} takes contiguous float32 scales and bias on the card")
    if x.data_ptr() % 4 or wq.data_ptr() % 4:
        raise ValueError(f"{name} reads 4-byte words: x and w must be 4-byte aligned")
    cout, kh, kw, cp = wq.shape
    if x.dtype == torch.int8:
        bsz, h, w, cin = x.shape
    else:
        bsz, cin, h, w = x.shape
    ho, wo = output_hw((h, w), (kh, kw), padding, dilation)
    fn = cuda_build.load(KERNEL_NAME).conv_i8
    if fn.argtypes is None:
        fn.argtypes, fn.restype = C_ARGTYPES["conv_i8"], ctypes.c_int
    out = torch.empty((bsz, cout, ho, wo), dtype=dtype, device=x.device)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = fn(x.data_ptr(), KERNEL_IN_KINDS[x.dtype], ptr(rscale), wq.data_ptr(), ptr(scale),
             ptr(bias), out.data_ptr(), KERNEL_OUT_KINDS[dtype], x.device.index or 0, bsz, h, w,
             cin, cp, cout, kh, kw, padding[0], padding[2], dilation, ho, wo,
             *(x.stride() if x.dtype != torch.int8 else (0, 0, 0, 0)),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    launch_counts[name] += 1
    return out


@torch.library.custom_op("twingan_tpu_torch::conv_i8", mutates_args=(), device_types="cpu")
def _conv_i8_op(xq: torch.Tensor, wq: torch.Tensor, scale: Optional[torch.Tensor],
                bias: Optional[torch.Tensor], padding: list[int], dilation: int,
                dtype: torch.dtype) -> torch.Tensor:
    return dequantize_plain(conv_i8_plain(xq, wq, padding, dilation), scale, bias, dtype)


@_conv_i8_op.register_kernel("cuda")
def _conv_i8_cuda(xq, wq, scale, bias, padding, dilation, dtype):
    return _launch(KERNEL_NAME, xq, None, wq, scale, bias, padding, dilation, dtype)


@_conv_i8_op.register_fake
def _conv_i8_fake(xq, wq, scale, bias, padding, dilation, dtype):
    ho, wo = output_hw(xq.shape[1:3], wq.shape[1:3], padding, dilation)
    return xq.new_empty((xq.shape[0], wq.shape[0], ho, wo), dtype=dtype)


def _check_common(name: str, x: torch.Tensor, wq: torch.Tensor, tensors, padding,
                  dilation: int, x_hw, x_contiguous: bool = True) -> None:
    if len(padding) != 4 or min(padding) < 0 or dilation not in (1, 2):
        raise ValueError(f"padding (top, bottom, left, right) >= 0 and dilation 1 or 2, got "
                         f"{tuple(padding)} and {dilation}")
    if min(output_hw(x_hw, wq.shape[1:3], padding, dilation)) < 1:
        raise ValueError(f"no output for x {tuple(x.shape)}, w {tuple(wq.shape)}")
    if not ((x.is_contiguous() or not x_contiguous) and wq.is_contiguous()):
        raise ValueError(f"{name} takes contiguous x and w")
    if any(t.device != x.device for t in tensors if t is not None):
        raise ValueError(f"{name}'s tensors must be on one device")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def conv_i8(xq: torch.Tensor, wq: torch.Tensor, scale: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None, padding: Sequence[int] = (0, 0, 0, 0),
            dilation: int = 1, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Q1: xq int8 NHWC [B, H, W, Cp] (Cp a multiple of 4), wq int8 [Cout,
    kh, kw, Cp], padding (top, bottom, left, right) of the input dilated by
    ``dilation`` (1 or 2) -> NCHW [B, Cout, Ho, Wo] in ``dtype``: the int32
    sums, or the epilogue with ``scale`` [Cout] and ``bias`` [Cout] (float
    values already in ``dtype``). A CUDA tensor goes to the kernel (or
    raises); a CPU tensor to the plain version."""
    if xq.dim() != 4 or wq.dim() != 4 or xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError("conv_i8 takes int8 x [B, H, W, Cp] and int8 w [Cout, kh, kw, Cp]")
    if xq.shape[3] != wq.shape[3] or xq.shape[3] % 4:
        raise ValueError(f"x {tuple(xq.shape)} and w {tuple(wq.shape)}: the channels must "
                         "agree and be padded to a multiple of 4")
    _check_common("conv_i8", xq, wq, (wq, scale, bias), padding, dilation, xq.shape[1:3])
    return torch.ops.twingan_tpu_torch.conv_i8(xq, wq, scale, bias, list(padding), dilation,
                                               dtype)


@torch.library.custom_op("twingan_tpu_torch::conv_i8q", mutates_args=(), device_types="cpu")
def _conv_i8q_op(x: torch.Tensor, rscale: torch.Tensor, wq: torch.Tensor,
                 scale: Optional[torch.Tensor], bias: Optional[torch.Tensor], padding: list[int],
                 dilation: int, dtype: torch.dtype) -> torch.Tensor:
    acc = conv_i8_plain(nhwc_words(quantize_recip(x, rscale)), wq, padding, dilation)
    return dequantize_plain(acc, scale, bias, dtype)


@_conv_i8q_op.register_kernel("cuda")
def _conv_i8q_cuda(x, rscale, wq, scale, bias, padding, dilation, dtype):
    return _launch(FUSED_NAME, x, rscale, wq, scale, bias, padding, dilation, dtype)


@_conv_i8q_op.register_fake
def _conv_i8q_fake(x, rscale, wq, scale, bias, padding, dilation, dtype):
    ho, wo = output_hw(x.shape[2:], wq.shape[1:3], padding, dilation)
    return x.new_empty((x.shape[0], wq.shape[0], ho, wo), dtype=dtype)


def conv_i8q(x: torch.Tensor, rscale: torch.Tensor, wq: torch.Tensor,
             scale: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
             padding: Sequence[int] = (0, 0, 0, 0), dilation: int = 1,
             dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Q1 with the activation's quantize fused into its load: x float
    [B, Cin, H, W], any strides (bfloat16 or float32 on the card),
    ``rscale`` the reciprocal of x's scale (one float32 value on the card),
    wq int8 [Cout, kh, kw, Cp] (Cp = Cin rounded up to 4); the rest as
    ``conv_i8``. Equals
    ``conv_i8(nhwc_words(quantize_recip(x, rscale)), wq, ...)``."""
    if x.dim() != 4 or not x.dtype.is_floating_point:
        raise ValueError(f"conv_i8q takes float x [B, Cin, H, W], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if wq.dim() != 4 or wq.dtype != torch.int8 or wq.shape[3] != -(-x.shape[1] // 4) * 4:
        raise ValueError(f"conv_i8q takes int8 w [Cout, kh, kw, Cin rounded up to 4], got "
                         f"{wq.dtype} {tuple(wq.shape)} for x {tuple(x.shape)}")
    if rscale.numel() != 1 or not rscale.dtype.is_floating_point:
        raise ValueError(f"conv_i8q takes one float rscale, got {rscale.dtype} "
                         f"{tuple(rscale.shape)}")
    _check_common("conv_i8q", x, wq, (rscale, wq, scale, bias), padding, dilation,
                  x.shape[2:], x_contiguous=False)
    if x.is_cuda and x.dtype not in (torch.bfloat16, torch.float32):
        x = x.float()  # as the plain version reads it: float16 exactly, float64 rounded
    return torch.ops.twingan_tpu_torch.conv_i8q(x, rscale.reshape(()), wq, scale, bias,
                                                list(padding), dilation, dtype)


def conv_prep(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The weight-only part of a W8A8 conv: the float kernel (OIHW, the
    eq-lr scale folded in) -> (Q1's int8 weights, per-channel scale s_w)."""
    wq, s_w = weight_quant(kernel)
    return weight_words(wq), s_w


def conv_scales(a_max: torch.Tensor, s_w: torch.Tensor, dtype: torch.dtype,
                bias: Optional[torch.Tensor] = None):
    """The per-activation part: (rscale, scale, bias) for ``conv_i8q`` from
    the calibrated abs-max: 1 / s_x, (s_x * s_w) in ``dtype`` and the bias
    in ``dtype``, both held as float32."""
    s_x = act_scale(a_max)
    scale = (s_x * s_w).to(dtype).float()
    return (torch.reciprocal(s_x), scale,
            bias.to(dtype).float() if bias is not None else None)
