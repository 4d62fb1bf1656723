"""SAGAN self-attention core: softmax(f g^T) h over N = H*W positions.

Counterpart of ``twingan_tpu/ops/attention.py``:

- ``attention_core`` is the plain PyTorch version of the JAX einsum path
  (scores and softmax in fp32, the probabilities cast to h's dtype, the
  value product accumulated in fp32). The tests use it, and the kernel
  wrapper runs it for tensors on the CPU;
- ``flash_attention_forward`` is the wrapper of the hand-written CUDA kernel
  ``csrc/flash_attn_fwd.cu``, which replaces the Pallas ``_flash_kernel``.
  On a CUDA tensor it launches the kernel or raises; it never falls back;
- ``self_attention`` is the dispatch the SelfAttention layer calls. On a
  CUDA tensor the kernel runs at any N (there is no TPU-style size
  threshold); on a CPU tensor the plain version runs.

The backward kernels (Pallas ``_flash_dq_kernel`` / ``_flash_dkv_kernel``)
belong to the training slice: ``FlashAttention.backward`` raises.
"""

from __future__ import annotations

import ctypes

import torch

from twingan_tpu_torch.ops import cuda_build

KERNEL_NAME = "flash_attn_fwd"
MAX_CBAR = 64
MAX_C = 256

# Kernel launches since the last reset_launch_counts(), by kernel name. Only
# the wrapper adds to it, once per launch of its kernel.
launch_counts = {KERNEL_NAME: 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def attention_core(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """o[b,i,:] = sum_j softmax_j(f[b,i] . g[b,j]) h[b,j].

    f, g: [B, N, C_bar]; h: [B, N, C]. Plain version: materializes the N^2
    scores in fp32, as the JAX einsum path does."""
    scores = torch.matmul(f.float(), g.float().transpose(1, 2))
    beta = torch.softmax(scores, dim=-1)
    o = torch.matmul(beta.to(h.dtype).float(), h.float())
    return o.to(h.dtype)


def attention_lse(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per-row logsumexp of the scores, fp32 [B, N] (plain version)."""
    return torch.logsumexp(torch.matmul(f.float(), g.float().transpose(1, 2)), dim=-1)


def _check(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor) -> None:
    if f.dim() != 3 or g.dim() != 3 or h.dim() != 3:
        raise ValueError("f, g, h must be [B, N, C'] tensors")
    if f.shape != g.shape or h.shape[:2] != f.shape[:2]:
        raise ValueError(
            f"shape mismatch: f {tuple(f.shape)}, g {tuple(g.shape)}, h {tuple(h.shape)}")
    if not (f.dtype == g.dtype == h.dtype):
        raise ValueError(f"dtype mismatch: {f.dtype}, {g.dtype}, {h.dtype}")
    if not (f.device == g.device == h.device):
        raise ValueError("f, g, h must be on one device")


def _launch(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel; every check the kernel needs happens here."""
    if f.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attn_fwd takes float32 or bfloat16, got {f.dtype}")
    b, n, c_bar = f.shape
    c = h.shape[-1]
    if not 1 <= c_bar <= MAX_CBAR or not 1 <= c <= MAX_C:
        raise ValueError(
            f"flash_attn_fwd takes c_bar in [1, {MAX_CBAR}] and C in [1, {MAX_C}], "
            f"got {c_bar} and {c}")
    if not (f.is_contiguous() and g.is_contiguous() and h.is_contiguous()):
        raise ValueError("flash_attn_fwd takes contiguous f, g, h")
    lib = cuda_build.load(KERNEL_NAME)
    fn = lib.flash_attn_fwd
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [vp] * 5 + [i32] * 6 + [i64] * 9 + [vp]
        fn.restype = ctypes.c_int
    o = torch.empty_like(h)
    lse = torch.empty((b, n), dtype=torch.float32, device=f.device)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    err = fn(
        f.data_ptr(), g.data_ptr(), h.data_ptr(), o.data_ptr(), lse.data_ptr(),
        0 if f.dtype == torch.float32 else 1, f.device.index or 0, b, n, c_bar, c,
        f.stride(0), f.stride(1), g.stride(0), g.stride(1), h.stride(0), h.stride(1),
        o.stride(0), o.stride(1), lse.stride(0), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError_t {err}")
    launch_counts[KERNEL_NAME] += 1
    return o, lse


def flash_attention_forward(
    f: torch.Tensor, g: torch.Tensor, h: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): o in h's dtype, lse the fp32 per-row logsumexp [B, N].

    A CUDA tensor goes to the kernel (or raises); a CPU tensor to the plain
    version."""
    _check(f, g, h)
    if f.is_cuda:
        return _launch(f, g, h)
    if f.device.type != "cpu":
        raise ValueError(f"flash_attention_forward runs on cuda or cpu, not {f.device}")
    return attention_core(f, g, h), attention_lse(f, g)


class FlashAttention(torch.autograd.Function):
    """Autograd boundary of the forward kernel. Its backward kernels are not
    ported yet, so a gradient through it raises instead of being wrong."""

    @staticmethod
    def forward(ctx, f, g, h):
        o, _ = flash_attention_forward(f, g, h)
        return o

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError("flash backward: training slice")


flash_attention_core = FlashAttention.apply


def self_attention(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The layer's dispatch: the CUDA kernel for CUDA tensors at every N, the
    plain version for CPU tensors."""
    if f.is_cuda:
        return flash_attention_core(f, g, h)
    return attention_core(f, g, h)
