"""Process-group start-up, the batch rows of each process, and the
differentiable collectives.

Counterpart of ``twingan_tpu/parallel/multihost.py``. Where the JAX
package joins ``jax.distributed`` from the ``JAX_*`` variables and lets
one jitted program span every device, the port starts one process per
device (``torchrun --nproc_per_node N``, or a test's spawner) and joins
them into a ``torch.distributed`` process group from torchrun's
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``: NCCL on the card, gloo only where the caller asks for
the CPU. Every group is made with a timeout, so a process that dies ends
its peers with an error instead of leaving them blocked.

Each process holds the whole batch that the same seeded source gives all
of them and keeps its rows (``local_batch_slice``, ``local_rows``,
``shard_batch``); ``make_global_array`` gathers them back. Random draws
with a batch axis are made at the global batch and sliced the same way
(``draw_rows``), so N processes compute what one process computes on the
whole batch.

The collectives (``all_reduce_mean``, ``all_gather``, whose backward is a
reduce-scatter, and ``all_to_all``) are ``torch.autograd.Function``s
whose backward is the adjoint collective, called through ``apply`` again,
so they are differentiable twice (the DRAGAN penalty differentiates the
discriminator twice). Each is the identity without a group; with a group
of one process it is issued all the same and returns its input's values
exactly.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from twingan_tpu_torch.parallel.mesh import current_group, rank, set_current_group, world_size

DEFAULT_TIMEOUT_S = 600.0


def init_group(device: Optional[str | torch.device], rank: int, world_size: int,
               init_method: str, timeout_s: float = DEFAULT_TIMEOUT_S, local_rank: int = 0):
    """Join the default process group and register it as the current one.
    ``device`` None or CUDA: NCCL, on ``cuda:local_rank``, which becomes the
    current device; it raises where NCCL is missing and never falls back.
    ``device="cpu"``: gloo."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a process group on the card needs one "
                               "(pass device='cpu' for gloo on the CPU)")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL: a process group on the card "
                               "needs it, and gloo is used only on the CPU")
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"process groups run on cuda or cpu, not {device}")
    kw = {"device_id": torch.device("cuda", local_rank)} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    group = dist.group.WORLD
    set_current_group(group)
    return group


def initialize_from_env(device: Optional[str | torch.device] = None,
                        timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) when it has more than
    one process, and register it. Returns True when it did, False for a
    single process (no variables, or ``WORLD_SIZE`` 1). A group that is
    already initialized is registered and kept."""
    n = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if n <= 1:
        return False
    if dist.is_initialized():
        set_current_group(dist.group.WORLD)
        return True
    missing = [v for v in ("RANK", "MASTER_ADDR", "MASTER_PORT") if v not in os.environ]
    if missing:
        raise ValueError(f"WORLD_SIZE={n} but {', '.join(missing)} unset: start the "
                         "processes with torchrun")
    init_group(device, int(os.environ["RANK"]), n,
               f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
               timeout_s=timeout_s, local_rank=int(os.environ.get("LOCAL_RANK", "0")))
    return True


def local_batch_slice(global_batch: int, group=None) -> slice:
    """This process's rows of a batch of ``global_batch`` rows, in the order
    of the group's ranks (the current group's by default)."""
    group = group if group is not None else current_group()
    n = world_size(group)
    if global_batch % n:
        raise ValueError(
            f"global_batch {global_batch} not divisible by the process count {n}"
            " — remainder samples would be silently dropped")
    per = global_batch // n
    i = rank(group)
    return slice(i * per, (i + 1) * per)


def local_rows(x: Optional[torch.Tensor], parts: int = 1,
               group=None) -> Optional[torch.Tensor]:
    """This process's rows of the tensor ``x`` (None stays None), whose
    first axis is the global batch, or ``parts`` global batches laid end to
    end (a fused pass's concatenation): each part's local slice,
    concatenated in order."""
    group = group if group is not None else current_group()
    if group is None or x is None:
        return x
    b = x.shape[0] // parts
    if b * parts != x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows are not {parts} equal parts")
    sl = local_batch_slice(b, group)
    return torch.cat([x[p * b + sl.start:p * b + sl.stop] for p in range(parts)])


def draw_rows(draw: Callable, shape: Sequence[int], parts: int = 1, **kw) -> torch.Tensor:
    """``draw(shape, **kw)`` (``torch.randn``, ``torch.rand``) for this
    process's rows: under a current group of W processes the draw is made
    at the global batch, ``shape[0]`` times W rows (``parts`` global
    batches end to end for a fused pass), and this process keeps its rows
    of each (``local_rows``); so W processes draw what one process draws
    for the whole batch. Without a group, or with one process, it is
    ``draw(shape, **kw)``."""
    group = current_group()
    shards = world_size(group)
    if shards == 1:
        return draw(tuple(shape), **kw)
    full = draw((shape[0] * shards,) + tuple(shape[1:]), **kw)
    return local_rows(full, parts=parts, group=group)


def make_global_array(x: torch.Tensor, group=None) -> torch.Tensor:
    """The global batch from each process's rows ``x`` (the all-gather along
    the first axis), for a caller that needs every row."""
    group = group if group is not None else current_group()
    if group is None:
        return x
    return all_gather(x, 0, group)


# ---------------------------------------------------------------------------
# Differentiable collectives


def _chunk_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``dim`` moved to the front, contiguous."""
    return x.movedim(dim, 0).contiguous()


# PyTorch 2.13 renames these two and deprecates the old names; earlier
# releases have the old names only.
_all_gather_base = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_base = (getattr(dist, "reduce_scatter_single", None)
                        or dist.reduce_scatter_tensor)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        src = _chunk_dim(x, dim)
        out = src.new_empty((n * src.shape[0],) + src.shape[1:])
        _all_gather_base(out, src, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceScatter.apply(grad, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        src = _chunk_dim(x, dim)
        out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
        _reduce_scatter_base(out, src, op=dist.ReduceOp.SUM, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        return _AllGather.apply(grad, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    """Chunk i of the first axis goes to rank i; chunk i of the result came
    from rank i. Its own adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, ctx.group), None


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the processes of ``group`` (``x`` without
    one). Its gradient is the mean of the processes' gradients, sent back
    to each."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group) / world_size(group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every process's ``x`` concatenated along ``dim`` in rank order; the
    gradient of each process's part is reduce-scattered back to it."""
    if group is None:
        return x
    return _AllGather.apply(x, dim, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Split ``x`` along its first axis into one equal chunk per process,
    send chunk i to process i, and return the chunks received, chunk i
    from process i, in place of the sent ones."""
    if group is None:
        return x
    if x.shape[0] % world_size(group):
        raise ValueError(f"first axis {x.shape[0]} not divisible by the process count "
                         f"{world_size(group)}")
    return _AllToAll.apply(x, group)


def all_reduce_mean_(tensors: list[torch.Tensor], group) -> None:
    """In place, no gradient: each tensor replaced by its mean over the
    processes of ``group``, one flat bucket per dtype (the gradients of a
    step, the moments batch norm's moving statistics move with)."""
    if group is None or not tensors:
        return
    n = world_size(group)
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for same in buckets.values():
            flat = torch.cat([t.reshape(-1) for t in same])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            flat /= n
            for t, part in zip(same, torch.split(flat, [t.numel() for t in same])):
                t.copy_(part.view_as(t))
