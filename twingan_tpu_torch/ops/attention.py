"""SAGAN self-attention core: softmax(f g^T) h over N = H*W positions.

Counterpart of ``twingan_tpu/ops/attention.py``:

- ``attention_core`` is the plain PyTorch version of the JAX einsum path
  (scores and softmax in fp32, the probabilities cast to h's dtype, the
  value product accumulated in fp32). The tests use it, the kernel wrappers
  run it for tensors on the CPU, and its autograd is twice differentiable;
- ``flash_attention_forward`` wraps the hand-written CUDA kernel
  ``csrc/flash_attn_fwd.cu`` (Pallas ``_flash_kernel``), and
  ``flash_attention_backward`` the two kernels of ``csrc/flash_attn_bwd.cu``
  (Pallas ``_flash_dq_kernel`` and ``_flash_dkv_kernel``). On a CUDA tensor
  each launches its kernel or raises; it never falls back. Their plain
  versions (``attention_core``/``attention_lse`` and
  ``flash_attention_dq_plain``/``flash_attention_dkv_plain``) run on CPU
  tensors;
- each kernel is a ``torch.library`` custom op,
  ``twingan_tpu_torch::flash_attn_fwd`` (o and lse), ``::flash_attn_dq``
  and ``::flash_attn_dkv``: its CUDA implementation launches the kernel,
  its CPU implementation is the plain version, and a fake implementation
  gives the output shapes, so that ``torch.export`` traces through it
  (``infer/export.py``). The eager wrappers call the same ops, and only the
  CUDA implementations add to the launch counts: the launches of an
  exported program count too;
- each kernel's C entry point picks its variant by the input type and
  the widths, and reports the one it launched (``VARIANT_IDS``): bf16 runs
  on the tensor cores
  (``mma.sync`` m16n8k16); fp32 B1-B3 run on the TF32 tensor cores,
  each product as three TF32 products of the operands' high and low
  halves (3xTF32, fp32-accurate). Every
  c_bar and C is taken: past c_bar 64, or C 256 (where the register-held
  kernels stop), the entry points launch ``csrc/flash_wide.cuh``'s
  kernels, which cut every operand into chunks of columns
  (``WIDE_VARIANTS``): the bf16 forward on the tensor cores, one 64-column
  slice of o a block; the bf16 dq and dkv on the tensor cores too, as
  their own variant (``TENSOR_CORE_CLUSTER``): each block owns a group of
  up to 256 output columns, and a thread-block cluster splits the other
  side's tiles (or, at one or two tiles, dp's chunks); fp32 on the TF32
  tensor cores (3xTF32), groups and clusters the same way.
  ``variant_counts`` counts each launch under the variant its entry point
  reported, beside ``launch_counts``' total;
- ``FlashAttention`` is the autograd boundary. Its backward is
  ``once_differentiable`` and refuses to run under ``create_graph=True``:
  the kernels' outputs carry no graph, and a second-order pass through
  them would treat them as constants. ``once_differentiable`` alone raises
  only when the engine reaches its error node, which
  ``torch.autograd.grad(..., inputs)`` can prune, leaving a wrong
  gradient without an error; so the first-order pass that would build the
  second-order graph raises instead;
- ``self_attention`` is the dispatch the SelfAttention layer calls. On a
  CUDA tensor the kernels run at any N (there is no TPU-style size
  threshold); on a CPU tensor the plain version runs. Where no gradient is
  needed (serving, and the programs ``torch.export`` traces) it calls the
  forward op on either device; where one is, ``FlashAttention`` on a CUDA
  tensor and the plain version's autograd on a CPU tensor.
  ``route="plain"`` asks for the plain version on any device. The gradient
  penalty takes it:
  DRAGAN and WGAN-GP differentiate the discriminator twice, the backward
  kernels have no second-order rule, and neither has the JAX package's
  ``custom_vjp`` (on a TPU its penalty also runs the einsum path). Each such
  call is counted under ``PLAIN_ROUTE``;
- ``context_parallel_attention`` splits the N positions over a process
  group (the JAX ``sharded_attention_core``, which runs its einsum path):
  an all-to-all from each process's batch rows to its share of the
  positions of the whole batch, ``sharded_attention_core`` (g and h
  all-gathered, this process's query rows against every key), an
  all-to-all back. The kernels take as many keys as queries, so the core
  runs them on one block of keys at a time and merges the blocks by their
  logsumexps (``FlashAttention``'s ``blocks``): B1-B3 on a CUDA tensor, their
  plain versions on a CPU tensor; ``route="plain"`` runs the plain version
  on the gathered keys, twice differentiable with the collectives.
"""

from __future__ import annotations

import ctypes

import torch

from twingan_tpu_torch.ops import cuda_build
from twingan_tpu_torch.parallel.multihost import all_gather, all_to_all
from twingan_tpu_torch.parallel.mesh import world_size

KERNEL_NAME = "flash_attn_fwd"
BWD_LIBRARY = "flash_attn_bwd"
DQ_KERNEL = "flash_attn_dq"
DKV_KERNEL = "flash_attn_dkv"
PLAIN_ROUTE = "attention_core_double_backward"

CUDA_CORE = "cuda_core"
TENSOR_CORE = "tensor_core"
TF32X3 = "tensor_core_tf32x3"
TENSOR_CORE_CLUSTER = "tensor_core_cluster"
# The variants by the id a C entry point writes to its ``variant`` argument
# (csrc/flash_mma.cuh's ``Variant``). The entry points alone pick them; no
# kernel reports CUDA_CORE any more (the id stays, so the others keep theirs).
VARIANT_IDS = (CUDA_CORE, TENSOR_CORE, TF32X3, TENSOR_CORE_CLUSTER)
# The variant each kernel's entry point launches for each input type at
# the widths of its register-held kernels (c_bar <= 64; C <= 256 for fp32
# and for the backward).
VARIANTS = {
    KERNEL_NAME: {torch.float32: TF32X3, torch.bfloat16: TENSOR_CORE},
    DQ_KERNEL: {torch.float32: TF32X3, torch.bfloat16: TENSOR_CORE},
    DKV_KERNEL: {torch.float32: TF32X3, torch.bfloat16: TENSOR_CORE},
}
# Past those widths, csrc/flash_wide.cuh's kernels, by kernel and input type.
WIDE_VARIANTS = {
    KERNEL_NAME: {torch.float32: TF32X3, torch.bfloat16: TENSOR_CORE},
    DQ_KERNEL: {torch.float32: TF32X3, torch.bfloat16: TENSOR_CORE_CLUSTER},
    DKV_KERNEL: {torch.float32: TF32X3, torch.bfloat16: TENSOR_CORE_CLUSTER},
}


# Kernel launches since the last reset_launch_counts(), by kernel name. Only
# a wrapper adds to it, once per launch of its kernel; PLAIN_ROUTE counts the
# calls that asked for the twice-differentiable plain version.
launch_counts = {KERNEL_NAME: 0, DQ_KERNEL: 0, DKV_KERNEL: 0, PLAIN_ROUTE: 0}
# The same launches by "<kernel>/<variant>".
variant_counts = {f"{k}/{v}": 0 for k, by_type in VARIANTS.items()
                  for v in dict.fromkeys([*by_type.values(), *WIDE_VARIANTS[k].values()])}


def reset_launch_counts() -> None:
    for counts in (launch_counts, variant_counts):
        for k in counts:
            counts[k] = 0


def _count(name: str, variant_id: ctypes.c_int) -> None:
    """One launch of kernel ``name``, under the variant its entry point
    reported (a variant outside the tables gets a count of its own)."""
    if not 0 <= variant_id.value < len(VARIANT_IDS):
        raise RuntimeError(f"{name} reported no variant ({variant_id.value})")
    launch_counts[name] += 1
    key = f"{name}/{VARIANT_IDS[variant_id.value]}"
    variant_counts[key] = variant_counts.get(key, 0) + 1


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


def _check_kernel_args(name: str, f: torch.Tensor, h: torch.Tensor, *tensors: torch.Tensor) -> None:
    """What the CUDA kernels take: fp32 or bf16, non-empty tensors of at
    most 65535 batch rows (the grid's y) and any c_bar and C (past c_bar 64
    or C 256 the entry points launch ``csrc/flash_wide.cuh``'s kernels),
    contiguous tensors."""
    if f.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes float32 or bfloat16, got {f.dtype}")
    if min(*f.shape, h.shape[-1]) < 1 or f.shape[0] > 65535:
        raise ValueError(f"{name} takes non-empty tensors and B <= 65535, got f "
                         f"{tuple(f.shape)} and h {tuple(h.shape)}")
    if not all(t.is_contiguous() for t in (f, h, *tensors)):
        raise ValueError(f"{name} takes contiguous tensors")


def _launch(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel; every check the kernel needs happens here."""
    _check_kernel_args(KERNEL_NAME, f, h, g)
    b, n, c_bar = f.shape
    c = h.shape[-1]
    lib = cuda_build.load(KERNEL_NAME)
    fn = lib.flash_attn_fwd
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [vp] * 5 + [i32] * 6 + [i64] * 9 + [vp, ctypes.POINTER(i32)]
        fn.restype = ctypes.c_int
    o = torch.empty_like(h)
    vid = ctypes.c_int(-1)
    lse = torch.empty((b, n), dtype=torch.float32, device=f.device)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    err = fn(
        f.data_ptr(), g.data_ptr(), h.data_ptr(), o.data_ptr(), lse.data_ptr(),
        0 if f.dtype == torch.float32 else 1, f.device.index or 0, b, n, c_bar, c,
        f.stride(0), f.stride(1), g.stride(0), g.stride(1), h.stride(0), h.stride(1),
        o.stride(0), o.stride(1), lse.stride(0), stream, ctypes.byref(vid),
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError_t {err}")
    _count(KERNEL_NAME, vid)
    return o, lse


def flash_attention_forward(
    f: torch.Tensor, g: torch.Tensor, h: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): o in h's dtype, lse the fp32 per-row logsumexp [B, N].

    A CUDA tensor goes to the kernel (or raises); a CPU tensor to the plain
    version."""
    _check(f, g, h)
    if f.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention_forward runs on cuda or cpu, not {f.device}")
    return torch.ops.twingan_tpu_torch.flash_attn_fwd(f, g, h)


@torch.library.custom_op("twingan_tpu_torch::flash_attn_fwd", mutates_args=(),
                         device_types="cpu")
def _fwd_op(f: torch.Tensor, g: torch.Tensor,
            h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return attention_core(f, g, h), attention_lse(f, g)


@_fwd_op.register_kernel("cuda")
def _fwd_cuda(f, g, h):
    return _launch(f, g, h)


@_fwd_op.register_fake
def _fwd_fake(f, g, h):
    return torch.empty_like(h), f.new_empty(f.shape[:2], dtype=torch.float32)


def flash_attention_dq_plain(f, g, h, do, lse, delta) -> torch.Tensor:
    """Plain version of the dq kernel: df = ds g, with p = exp(f g^T - lse),
    dp = do h^T and ds = p (dp - delta), over the full N^2 in fp32."""
    p = torch.exp(torch.matmul(f.float(), g.float().transpose(1, 2)) - lse[..., None])
    ds = p * (torch.matmul(do.float(), h.float().transpose(1, 2)) - delta[..., None])
    return torch.matmul(ds, g.float()).to(f.dtype)


def flash_attention_dkv_plain(f, g, h, do, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dkv kernel: dg = ds^T f and dh = p^T do."""
    p = torch.exp(torch.matmul(f.float(), g.float().transpose(1, 2)) - lse[..., None])
    ds = p * (torch.matmul(do.float(), h.float().transpose(1, 2)) - delta[..., None])
    dg = torch.matmul(ds.transpose(1, 2), f.float())
    dh = torch.matmul(p.transpose(1, 2), do.float())
    return dg.to(g.dtype), dh.to(h.dtype)


def flash_attention_backward_plain(f, g, h, do, lse, delta):
    """(df, dg, dh) of the two backward kernels' plain versions."""
    return (flash_attention_dq_plain(f, g, h, do, lse, delta),
            *flash_attention_dkv_plain(f, g, h, do, lse, delta))


def _bwd_fn(lib, name: str, n_ptrs: int, n_strides: int):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [vp] * n_ptrs + [i32] * 6 + [i64] * n_strides + [vp, ctypes.POINTER(i32)]
        fn.restype = ctypes.c_int
    return fn


def _check_backward(f, g, h, do, lse, delta) -> None:
    _check(f, g, h)
    if do.shape != h.shape or lse.shape != f.shape[:2] or delta.shape != f.shape[:2]:
        raise ValueError(
            f"shape mismatch: do {tuple(do.shape)}, lse {tuple(lse.shape)}, "
            f"delta {tuple(delta.shape)} for h {tuple(h.shape)}")
    if any(t.device != f.device for t in (do, lse, delta)):
        raise ValueError("do, lse and delta must be on f's device")
    if f.is_cuda:
        _check_kernel_args("flash backward", f, h, g, do, lse, delta)
        if do.dtype != h.dtype or lse.dtype != torch.float32 or delta.dtype != torch.float32:
            raise ValueError("flash backward takes do in h's dtype and fp32 lse and delta")
    elif f.device.type != "cpu":
        raise ValueError(f"flash backward runs on cuda or cpu, not {f.device}")


def _backward_args(f, g, h, do, lse, delta) -> tuple:
    """The kernels' shared leading arguments: the six input pointers; then,
    after the output pointers, dtype, device and sizes; then the input
    strides (lse and delta share one batch stride, both being contiguous)."""
    ptrs = (f.data_ptr(), g.data_ptr(), h.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    sizes = (0 if f.dtype == torch.float32 else 1, f.device.index or 0, *f.shape, h.shape[-1])
    strides = (f.stride(0), f.stride(1), g.stride(0), g.stride(1), h.stride(0), h.stride(1),
               do.stride(0), do.stride(1), lse.stride(0))
    return ptrs, sizes, strides


def flash_attention_dq(f, g, h, do, lse, delta) -> torch.Tensor:
    """df in f's dtype. A CUDA tensor goes to the dq kernel (or raises); a
    CPU tensor to ``flash_attention_dq_plain``."""
    _check_backward(f, g, h, do, lse, delta)
    return torch.ops.twingan_tpu_torch.flash_attn_dq(f, g, h, do, lse, delta)


def flash_attention_dkv(f, g, h, do, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """(dg, dh) in the dtypes of g and h. A CUDA tensor goes to the dkv
    kernel (or raises); a CPU tensor to ``flash_attention_dkv_plain``."""
    _check_backward(f, g, h, do, lse, delta)
    return torch.ops.twingan_tpu_torch.flash_attn_dkv(f, g, h, do, lse, delta)


@torch.library.custom_op("twingan_tpu_torch::flash_attn_dq", mutates_args=(),
                         device_types="cpu")
def _dq_op(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, do: torch.Tensor,
           lse: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    return flash_attention_dq_plain(f, g, h, do, lse, delta)


@_dq_op.register_kernel("cuda")
def _dq_cuda(f, g, h, do, lse, delta):
    df = torch.empty_like(f)
    vid = ctypes.c_int(-1)
    ptrs, sizes, strides = _backward_args(f, g, h, do, lse, delta)
    err = _bwd_fn(cuda_build.load(BWD_LIBRARY), DQ_KERNEL, 7, 11)(
        *ptrs, df.data_ptr(), *sizes, *strides, df.stride(0), df.stride(1),
        torch.cuda.current_stream(f.device).cuda_stream, ctypes.byref(vid))
    if err != 0:
        raise RuntimeError(f"{DQ_KERNEL} launch failed: cudaError_t {err}")
    _count(DQ_KERNEL, vid)
    return df


@_dq_op.register_fake
def _dq_fake(f, g, h, do, lse, delta):
    return torch.empty_like(f)


@torch.library.custom_op("twingan_tpu_torch::flash_attn_dkv", mutates_args=(),
                         device_types="cpu")
def _dkv_op(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, do: torch.Tensor,
            lse: torch.Tensor, delta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_dkv_plain(f, g, h, do, lse, delta)


@_dkv_op.register_kernel("cuda")
def _dkv_cuda(f, g, h, do, lse, delta):
    dg, dh = torch.empty_like(g), torch.empty_like(h)
    vid = ctypes.c_int(-1)
    ptrs, sizes, strides = _backward_args(f, g, h, do, lse, delta)
    err = _bwd_fn(cuda_build.load(BWD_LIBRARY), DKV_KERNEL, 8, 13)(
        *ptrs, dg.data_ptr(), dh.data_ptr(), *sizes, *strides, dg.stride(0), dg.stride(1),
        dh.stride(0), dh.stride(1), torch.cuda.current_stream(f.device).cuda_stream,
        ctypes.byref(vid))
    if err != 0:
        raise RuntimeError(f"{DKV_KERNEL} launch failed: cudaError_t {err}")
    _count(DKV_KERNEL, vid)
    return dg, dh


@_dkv_op.register_fake
def _dkv_fake(f, g, h, do, lse, delta):
    return torch.empty_like(g), torch.empty_like(h)


def flash_attention_backward(f, g, h, do, lse, delta):
    """(df, dg, dh) in the dtypes of f, g, h, from the forward's fp32 lse
    and delta = rowsum(do * o) [B, N] fp32: the dq and the dkv kernel on a
    CUDA tensor, their plain versions on a CPU tensor."""
    return (flash_attention_dq(f, g, h, do, lse, delta),
            *flash_attention_dkv(f, g, h, do, lse, delta))


def _first_order_only(backward):
    """Raise when the backward runs with grad mode on (create_graph=True)."""

    def wrapper(ctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "FlashAttention is differentiable once only: its backward kernels "
                "have no second-order rule. Take self_attention(..., route='plain') "
                "for a create_graph=True pass (the gradient penalty's).")
        return backward(ctx, *grads)

    return wrapper


def blocked_forward(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                    blocks: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of f's rows against all of g and h, where g and h hold
    ``blocks`` times f's N rows: the forward op on each block of keys,
    whose partial outputs are merged by their logsumexps, o = sum_i
    exp(lse_i - lse) o_i in fp32, lse = logsumexp_i lse_i. One block is the
    op's own (o, lse)."""
    outs = [flash_attention_forward(f, gi.contiguous(), hi.contiguous())
            for gi, hi in zip(g.chunk(blocks, dim=1), h.chunk(blocks, dim=1))]
    if blocks == 1:
        return outs[0]
    lse = torch.logsumexp(torch.stack([lse_i for _, lse_i in outs]), dim=0)
    o = sum(torch.exp(lse_i - lse)[..., None] * o_i.float() for o_i, lse_i in outs)
    return o.to(h.dtype), lse


class FlashAttention(torch.autograd.Function):
    """Autograd boundary of the three kernels: the forward saves (o, lse),
    the backward computes delta = rowsum(do * o) as a plain fp32 reduction
    (as the JAX package does outside its kernels) and launches dq and dkv.
    With ``blocks`` > 1, g and h hold ``blocks`` times f's N rows (the
    context-parallel core's gathered keys) and the kernels, which take as
    many keys as queries, run on one block of keys at a time
    (``blocked_forward``); the backward runs dq and dkv on each block with
    the merged lse and delta, which gives each block's exact share: df is
    the fp32 sum of the blocks' dq, dg and dh the blocks' dkv side by side.
    Differentiable once only (see the module docstring)."""

    @staticmethod
    def forward(ctx, f, g, h, blocks):
        o, lse = blocked_forward(f, g, h, blocks)
        ctx.blocks = blocks
        ctx.save_for_backward(f, g, h, o, lse)
        return o

    @staticmethod
    @_first_order_only
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        f, g, h, o, lse = ctx.saved_tensors
        do = do.to(h.dtype).contiguous()
        delta = torch.sum(do.float() * o.float(), dim=-1)
        parts = [flash_attention_backward(f, gi.contiguous(), hi.contiguous(), do, lse, delta)
                 for gi, hi in zip(g.chunk(ctx.blocks, dim=1), h.chunk(ctx.blocks, dim=1))]
        if ctx.blocks == 1:
            return (*parts[0], None)
        df = sum(p[0].float() for p in parts).to(f.dtype)
        return (df, torch.cat([p[1] for p in parts], dim=1),
                torch.cat([p[2] for p in parts], dim=1), None)


def flash_attention_core(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                         blocks: int = 1) -> torch.Tensor:
    return FlashAttention.apply(f, g, h, blocks)


ROUTES = ("kernel", "plain")


def self_attention(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                   route: str = "kernel", blocks: int = 1) -> torch.Tensor:
    """The layer's dispatch. ``route="kernel"``: the CUDA kernels for CUDA
    tensors at every N, the plain version for CPU tensors (through the
    forward op where no gradient is needed). ``route="plain"``:
    the twice-differentiable plain version on any device, counted under
    ``PLAIN_ROUTE`` (the gradient penalty's passes). ``blocks`` > 1: g and
    h hold ``blocks`` times f's rows, and the kernel route takes them one
    block at a time (``FlashAttention``), on the CPU too, so that the
    blocks' merge runs there with the kernels' plain versions."""
    if route not in ROUTES:
        raise ValueError(f"unknown attention route {route!r}")
    if route == "plain":
        launch_counts[PLAIN_ROUTE] += 1
        return attention_core(f, g, h)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (f, g, h)):
        if f.is_cuda or blocks > 1:
            return flash_attention_core(f, g, h, blocks)
        return attention_core(f, g, h)
    return blocked_forward(f, g, h, blocks)[0]


# ---------------------------------------------------------------------------
# Context parallelism: the N positions split over a process group


def sharded_attention_core(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, group,
                           route: str = "kernel") -> torch.Tensor:
    """Context-parallel attention core, the JAX ``sharded_attention_core``:
    f, g, h are [B, N / W, C'], this process's share of the N positions of
    the whole batch over the W processes of ``group``. g and h are
    all-gathered along N, and this process's query rows attend to every
    key through ``self_attention`` with one block of keys per process
    (``route="plain"``: the plain version, twice differentiable with the
    collectives). The backward reduce-scatters dg and dh back to their
    processes."""
    g_all = all_gather(g, 1, group).contiguous()
    h_all = all_gather(h, 1, group).contiguous()
    return self_attention(f, g_all, h_all, route, blocks=world_size(group))


def to_position_shards(x: torch.Tensor, group) -> torch.Tensor:
    """[b, N, C] (this process's rows, every position) -> [W b, N / W, C]
    (every process's rows in rank order, this process's share of the
    positions): one all-to-all."""
    w = world_size(group)
    b, n, c = x.shape
    chunks = x.reshape(b, w, n // w, c).transpose(0, 1)
    return all_to_all(chunks, group).reshape(w * b, n // w, c)


def to_batch_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse of ``to_position_shards``."""
    w = world_size(group)
    rows, part, c = x.shape
    back = all_to_all(x.reshape(w, rows // w, part, c), group)
    return back.transpose(0, 1).reshape(rows // w, w * part, c)


def context_parallel_attention(f: torch.Tensor, g: torch.Tensor, h: torch.Tensor, group,
                               route: str = "kernel") -> torch.Tensor:
    """The attention of this process's rows [b, N, C'] computed with the
    positions split over ``group``: an all-to-all from batch rows to
    position shards of the whole batch, ``sharded_attention_core``, and an
    all-to-all back (JAX ``models/layers.py``'s SelfAttention under
    ``attention_context_parallel``, where ``shard_map`` reshards)."""
    core = sharded_attention_core(*(to_position_shards(t, group) for t in (f, g, h)), group,
                                  route)
    return to_batch_rows(core, group)
