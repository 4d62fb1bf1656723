"""Fused conv3x3 SAME + bias + leaky ReLU 0.2 + pixel norm (kernel B4).

Counterpart of ``_fused_kernel`` / ``pallas_block`` in
``tools/exp_fused_conv.py``, the one Pallas kernel of the repo outside the
package. It computes, per pixel of x:

    y = pn(leaky(conv3x3_same(x, w) + b)),  leaky(v) = max(0.2 v, v),
    pn(v) = v * rsqrt(mean_c(v^2) + 1e-6)

with the conv's products and sums, and the epilogue, in fp32, and y cast
to x's dtype. That is the generator's ``block_*_conv0/conv1`` step under
``norm_type="none"`` with pixel norm: the conv with its bias, the leaky
activation, then ``pixel_norm`` (eps 1e-6).

- ``fused_conv_plain`` is the plain PyTorch version: fp32 ``F.conv2d`` of
  ``x.float()``, the fp32 epilogue, the cast. The tests hold it against
  the JAX functions, and ``fused_conv`` runs it for CPU tensors;
- ``fused_conv`` wraps the hand-written CUDA kernel
  ``csrc/fused_conv.cu``: on a CUDA tensor it launches the kernel or
  raises, never falling back. The kernel is an implicit GEMM on the
  tensor cores (``mma.sync``) in two variants, chosen by x's type in its C
  entry point, which reports the one it launched (``VARIANTS`` names them):
  bf16 x multiplies each fp32 weight as a high and a low bf16 half, fp32 x
  runs on the TF32 tensor cores with x and w each split into a high and a
  low TF32 half and three products (3xTF32), so the products stay those of
  fp32. ``variant_counts`` counts each launch under the variant the entry
  point reported, beside ``launch_counts``' total;
- the kernel is the ``torch.library`` custom op
  ``twingan_tpu_torch::fused_conv``: the CUDA implementation launches it
  and adds to the counts, the CPU implementation is the plain version, and
  a fake implementation gives the output's shape for ``torch.export``;
- ``fold_weights`` folds the equalized-lr scale into a conv's weights,
  ``w_eff = kernel * scale`` in fp32 as [9, Cin, Cout] (the Pallas layout).

The dispatch of one generator step is ``ConvBlock.forward_pixel_norm``:
``fused_conv`` where no gradient is needed; where one is, the block's eager
layers (cuDNN conv, bias, leaky, pixel norm), counted under
``AUTOGRAD_ROUTE``, since the JAX package has no backward for the kernel.

Tensors are NCHW, the modules' layout, read in place: the kernel handles
the 1-pixel halo with bounds checks, where the Pallas version materializes
halo-duplicated row tiles because BlockSpec windows cannot overlap.

Any Cout: the Pallas kernel holds all of Cout in one block (VMEM is its
only bound), and so does B4 up to ``COUT_TILE`` channels. The pixel norm
needs every channel of a pixel before any can be written. A wider layer is
cut into tiles of ``CHANNEL_TILE`` channels, and the tiles of one block of
pixels form a thread-block cluster: up to ``ONE_PASS_WIDTH`` channels (8
tiles, a portable cluster) each block adds every tile's per-pixel sums of
squares through distributed shared memory in a fixed order and writes its
channels once, one kernel and no scratch. Past it the layer runs in two
passes of the one call, a route of its own (``route_counts``): each tile
writes its fp32 values and its per-pixel sum of squares to scratch that
this wrapper allocates, then the normalize adds each pixel's tile sums in
a fixed order and rounds y once.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from twingan_tpu_torch.ops import cuda_build
from twingan_tpu_torch.ops.attention import TENSOR_CORE, TF32X3, VARIANT_IDS

KERNEL_NAME = "fused_conv"
AUTOGRAD_ROUTE = "fused_conv_autograd"
# Output channels one block of the kernel holds (csrc/fused_conv.cu's
# kCoutTile); a wider layer is cut into tiles of CHANNEL_TILE (kChannelTile)
# and runs in one pass up to ONE_PASS_WIDTH (kOnePassWidth), in two past it
# (see above), whose tiles' sums of squares the wrapper makes room for.
COUT_TILE = 1024
CHANNEL_TILE = 256
ONE_PASS_WIDTH = 8 * CHANNEL_TILE
ONE_PASS = f"{KERNEL_NAME}/one_pass"
TWO_PASS = f"{KERNEL_NAME}/two_pass"
LEAKY_SLOPE = 0.2
PIXEL_NORM_EPS = 1e-6

# Kernel launches since the last reset_launch_counts(). Only ``fused_conv``
# adds to KERNEL_NAME, once per launch; AUTOGRAD_ROUTE counts the steps that
# ``ConvBlock.forward_pixel_norm`` sent to the eager layers because a
# gradient was needed.
launch_counts = {KERNEL_NAME: 0, AUTOGRAD_ROUTE: 0}
# The variant the C entry point launches for each type of x (it reports the
# one it launched by the ids of ``VARIANT_IDS``), and the kernel's launches
# by "<kernel>/<variant>".
VARIANTS = {torch.float32: TF32X3, torch.bfloat16: TENSOR_CORE}
variant_counts = {f"{KERNEL_NAME}/{v}": 0 for v in VARIANTS.values()}
# The ids B4's entry point can report: ``VARIANT_IDS`` up to TF32X3 (the
# later ones name the wide bf16 attention backward's variant alone).
_VARIANT_IDS = VARIANT_IDS[:VARIANT_IDS.index(TF32X3) + 1]
# The same launches by route: one kernel, or the two passes past
# ONE_PASS_WIDTH channels.
route_counts = {ONE_PASS: 0, TWO_PASS: 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, variant_counts, route_counts):
        for k in counts:
            counts[k] = 0


def fold_weights(kernel: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """An OIHW [Cout, Cin, 3, 3] kernel times the equalized-lr input scale,
    in fp32, as the kernel's contiguous [9, Cin, Cout] (tap dy * 3 + dx)."""
    cout, cin = kernel.shape[:2]
    w = kernel.detach().float() * scale
    return w.permute(2, 3, 1, 0).reshape(9, cin, cout).contiguous()


def fused_conv_plain(x: torch.Tensor, w9: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: x NCHW [B, Cin, H, W], w9 [9, Cin, Cout] fp32, b [Cout]
    fp32 -> y NCHW [B, Cout, H, W] in x's dtype."""
    cin, cout = w9.shape[1:]
    w = w9.float().reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    y = F.conv2d(x.float(), w, padding=1) + b.float()[:, None, None]
    y = torch.maximum(y * LEAKY_SLOPE, y)
    y = y * torch.rsqrt(torch.mean(torch.square(y), dim=1, keepdim=True) + PIXEL_NORM_EPS)
    return y.to(x.dtype)


def _check(x: torch.Tensor, w9: torch.Tensor, b: torch.Tensor) -> None:
    """What the kernel takes (checked for CPU tensors too, so that both
    routes accept the same calls)."""
    if x.dim() != 4 or w9.dim() != 3 or b.dim() != 1:
        raise ValueError("fused_conv takes x [B, Cin, H, W], w9 [9, Cin, Cout] and b [Cout]")
    cin, cout = w9.shape[1:]
    if w9.shape[0] != 9 or x.shape[1] != cin or b.shape[0] != cout:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w9 {tuple(w9.shape)}, "
                         f"b {tuple(b.shape)}")
    if cout < 1 or min(x.shape) < 1 or x.shape[0] > 65535:
        raise ValueError(f"fused_conv takes Cout >= 1, non-empty x and B <= 65535, "
                         f"got x {tuple(x.shape)}, Cout {cout}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_conv takes float32 or bfloat16 x, got {x.dtype}")
    if w9.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"fused_conv takes float32 w9 and b, got {w9.dtype} and {b.dtype}")
    if not (x.is_contiguous() and w9.is_contiguous() and b.is_contiguous()):
        raise ValueError("fused_conv takes contiguous NCHW x, w9 and b")
    if not (x.device == w9.device == b.device):
        raise ValueError("x, w9 and b must be on one device")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_conv runs on cuda or cpu, not {x.device}")


def _scratch(y: torch.Tensor) -> tuple:
    """(ws, ssq) of the two passes past ONE_PASS_WIDTH channels: the fp32
    values before the norm (y itself when y is fp32) and each channel
    tile's per-pixel sum of squares; (None, None) up to it, where the
    kernel needs no scratch."""
    bsz, cout, h, w = y.shape
    if cout <= ONE_PASS_WIDTH:
        return None, None
    ws = y if y.dtype == torch.float32 else torch.empty(y.shape, dtype=torch.float32,
                                                        device=y.device)
    return ws, torch.empty((-(-cout // CHANNEL_TILE), bsz, h * w), dtype=torch.float32,
                           device=y.device)


def _launch(x: torch.Tensor, w9: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    bsz, cin, h, w = x.shape
    cout = w9.shape[2]
    fn = cuda_build.load(KERNEL_NAME).fused_conv3x3_leaky_pixel_norm
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 6 + [i32] * 7 + [vp, ctypes.POINTER(i32)]
        fn.restype = ctypes.c_int
    y = torch.empty((bsz, cout, h, w), dtype=x.dtype, device=x.device)
    ws, ssq = _scratch(y)
    vid = ctypes.c_int(-1)
    err = fn(x.data_ptr(), w9.data_ptr(), b.data_ptr(), y.data_ptr(),
             None if ws is None else ws.data_ptr(), None if ssq is None else ssq.data_ptr(),
             0 if x.dtype == torch.float32 else 1, x.device.index or 0, bsz, cin, cout, h, w,
             torch.cuda.current_stream(x.device).cuda_stream, ctypes.byref(vid))
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: cudaError_t {err}")
    _count(vid, ssq is not None)
    return y


def _count(variant_id: ctypes.c_int, two_pass: bool = False) -> None:
    """One launch, under the variant the entry point reported (a variant
    outside ``VARIANTS`` gets a count of its own) and its route."""
    if not 0 <= variant_id.value < len(_VARIANT_IDS):
        raise RuntimeError(f"{KERNEL_NAME} reported no variant ({variant_id.value})")
    launch_counts[KERNEL_NAME] += 1
    key = f"{KERNEL_NAME}/{_VARIANT_IDS[variant_id.value]}"
    variant_counts[key] = variant_counts.get(key, 0) + 1
    route_counts[TWO_PASS if two_pass else ONE_PASS] += 1


@torch.library.custom_op("twingan_tpu_torch::fused_conv", mutates_args=(), device_types="cpu")
def _fused_conv_op(x: torch.Tensor, w9: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fused_conv_plain(x, w9, b)


@_fused_conv_op.register_kernel("cuda")
def _fused_conv_cuda(x, w9, b):
    return _launch(x, w9, b)


@_fused_conv_op.register_fake
def _fused_conv_fake(x, w9, b):
    return x.new_empty((x.shape[0], w9.shape[2], *x.shape[2:]))


def fused_conv(x: torch.Tensor, w9: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = pn(leaky(conv3x3_same(x, w9) + b)) in x's dtype, NCHW. A CUDA
    tensor goes to the kernel (or raises); a CPU tensor to the plain
    version."""
    _check(x, w9, b)
    return torch.ops.twingan_tpu_torch.fused_conv(x, w9, b)

