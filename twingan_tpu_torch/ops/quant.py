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

The int8 conv is kernel Q1, ``csrc/conv_i8.cu`` (CUDA C++, ``__dp4a``
into int32, the dequantize epilogue fused), registered as the custom op
``twingan_tpu_torch::conv_i8``:

- ``conv_i8_plain`` is the plain version: the int8 values in float64
  through ``F.conv2d`` and back to int32, exact (every partial sum is an
  integer below 2^53); input dilation by zero-stuffing;
- ``conv_i8`` is the wrapper. On a CUDA tensor the op launches Q1 or
  raises; on a CPU tensor it runs the plain version. The op's CUDA
  implementation adds one to ``launch_counts`` per launch, so the launches
  of an exported program count too.

Q1 takes x as int8 NHWC with the channels padded with zeros to a multiple
of 4 (``nhwc_words``) and the weights as int8 [Cout, kh, kw, Cin_pad]
(``weight_words``), and writes NCHW: the int32 sums, or
``float(acc) -> dtype``, times ``scale`` (already in the output type),
plus ``bias`` (the same), each step rounded to the output type, as the JAX
layer computes ``conv.astype(dt) * (s_x * s_w).astype(dt) +
bias.astype(dt)``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from twingan_tpu_torch.ops import cuda_build

QMAX = 127.0
KERNEL_NAME = "conv_i8"
# The output types the kernel writes, by its out_kind code.
KERNEL_OUT_KINDS = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}

# Q1 launches since the last reset_launch_counts(); only the op's CUDA
# implementation adds to it, once per launch.
launch_counts = {KERNEL_NAME: 0}


def reset_launch_counts() -> None:
    launch_counts[KERNEL_NAME] = 0


def _over_qmax(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division on every device. PyTorch's CUDA kernel
    turns division by a Python scalar into multiplication by its reciprocal,
    which rounds otherwise in the last bit: the card's scales would differ
    from the CPU's and the JAX package's."""
    return t / torch.full_like(t, QMAX)


def act_scale(a_max: torch.Tensor) -> torch.Tensor:
    """Calibrated abs-max -> the activation's multiplicative scale (float32)."""
    return _over_qmax(torch.clamp(a_max.float(), min=1e-8))


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A float tensor -> int8 with a static scale: round(x * (1 / scale))."""
    q = torch.round(x.float() * torch.reciprocal(scale))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


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


def _launch(xq, wq, scale, bias, padding, dilation, dtype) -> torch.Tensor:
    if dtype not in KERNEL_OUT_KINDS:
        raise ValueError(f"{KERNEL_NAME} writes {sorted(map(str, KERNEL_OUT_KINDS))}, "
                         f"not {dtype}")
    floats = [t for t in (scale, bias) if t is not None]
    if dtype != torch.int32 and scale is None:
        raise ValueError(f"{KERNEL_NAME} to {dtype} takes a scale")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in floats):
        raise ValueError(f"{KERNEL_NAME} takes contiguous float32 scale and bias on the card")
    if xq.data_ptr() % 4 or wq.data_ptr() % 4:
        raise ValueError(f"{KERNEL_NAME} reads 4-byte words: x and w must be 4-byte aligned")
    bsz, h, w, cp = xq.shape
    cout, kh, kw = wq.shape[:3]
    ho, wo = output_hw((h, w), (kh, kw), padding, dilation)
    fn = cuda_build.load(KERNEL_NAME).conv_i8
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [i32] * 14 + [vp]
        fn.restype = ctypes.c_int
    out = torch.empty((bsz, cout, ho, wo), dtype=dtype, device=xq.device)
    err = fn(xq.data_ptr(), wq.data_ptr(), scale.data_ptr() if scale is not None else None,
             bias.data_ptr() if bias is not None else None, out.data_ptr(),
             KERNEL_OUT_KINDS[dtype], xq.device.index or 0, bsz, h, w, cp // 4, cout, kh, kw,
             padding[0], padding[2], dilation, ho, wo,
             torch.cuda.current_stream(xq.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: cudaError_t {err}")
    launch_counts[KERNEL_NAME] += 1
    return out


@torch.library.custom_op("twingan_tpu_torch::conv_i8", mutates_args=(), device_types="cpu")
def _conv_i8_op(xq: torch.Tensor, wq: torch.Tensor, scale: Optional[torch.Tensor],
                bias: Optional[torch.Tensor], padding: list[int], dilation: int,
                dtype: torch.dtype) -> torch.Tensor:
    return dequantize_plain(conv_i8_plain(xq, wq, padding, dilation), scale, bias, dtype)


@_conv_i8_op.register_kernel("cuda")
def _conv_i8_cuda(xq, wq, scale, bias, padding, dilation, dtype):
    return _launch(xq, wq, scale, bias, padding, dilation, dtype)


@_conv_i8_op.register_fake
def _conv_i8_fake(xq, wq, scale, bias, padding, dilation, dtype):
    ho, wo = output_hw(xq.shape[1:3], wq.shape[1:3], padding, dilation)
    return xq.new_empty((xq.shape[0], wq.shape[0], ho, wo), dtype=dtype)


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
    if len(padding) != 4 or min(padding) < 0 or dilation not in (1, 2):
        raise ValueError(f"padding (top, bottom, left, right) >= 0 and dilation 1 or 2, got "
                         f"{tuple(padding)} and {dilation}")
    if min(output_hw(xq.shape[1:3], wq.shape[1:3], padding, dilation)) < 1:
        raise ValueError(f"no output for x {tuple(xq.shape)}, w {tuple(wq.shape)}")
    if not (xq.is_contiguous() and wq.is_contiguous()):
        raise ValueError("conv_i8 takes contiguous x and w")
    tensors = [t for t in (xq, wq, scale, bias) if t is not None]
    if any(t.device != xq.device for t in tensors):
        raise ValueError("conv_i8's tensors must be on one device")
    if xq.device.type not in ("cuda", "cpu"):
        raise ValueError(f"conv_i8 runs on cuda or cpu, not {xq.device}")
    return torch.ops.twingan_tpu_torch.conv_i8(xq, wq, scale, bias, list(padding), dilation,
                                               dtype)


def quantized_conv(x: torch.Tensor, kernel: torch.Tensor, a_max: torch.Tensor,
                   padding: Sequence[int], dilation: int, dtype: torch.dtype,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One W8A8 conv of a layer: x (NCHW, any float type) quantized with the
    calibrated ``a_max``, the float kernel (OIHW, the eq-lr scale folded
    in) per channel, Q1 with the epilogue in ``dtype``:
    ``acc.dtype * (s_x * s_w).dtype (+ bias.dtype)``."""
    s_x = act_scale(a_max)
    wq, s_w = weight_quant(kernel)
    scale = (s_x * s_w).to(dtype).float()
    if bias is not None:
        bias = bias.to(dtype).float()
    return conv_i8(nhwc_words(quantize(x, s_x)), weight_words(wq), scale, bias, padding,
                   dilation, dtype)
