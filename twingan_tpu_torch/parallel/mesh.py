"""The current process group, and replicating state and sharding batches
over it.

Counterpart of ``twingan_tpu/parallel/mesh.py``. The JAX package is
single-controller: one process sees every device of a ``Mesh``, keeps the
parameters replicated and the batch sharded by ``NamedSharding``s, and
XLA inserts the gradient all-reduce. PyTorch runs one process per device,
so the port keeps no sharding objects: each process holds a full copy of
the parameters and its own rows of the batch, and the trainers issue the
collectives themselves (``parallel/multihost.py``: the gradient
all-reduce, and the batch reductions the JAX package's global view
computes over the whole batch). ``create_mesh``, ``data_sharding``,
``replicated_sharding`` and ``put_with_sharding`` have no counterpart for
that reason.

The registry of the current process group stands in for the JAX
``set_current_mesh``/``current_mesh``: the stage runner (or a test)
registers the group, and the layers whose math spans the batch (batch
norm's moments, minibatch stddev, context-parallel attention) and the
trainers look it up at call time. ``None`` means a single process, and
every collective below is then the identity.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Mapping

import torch
import torch.distributed as dist

_CURRENT_GROUP = None


def set_current_group(group) -> None:
    """Register ``group`` (a ``torch.distributed`` process group, or None
    for a single process) as the one the model's batch reductions span."""
    global _CURRENT_GROUP
    _CURRENT_GROUP = group


def current_group():
    return _CURRENT_GROUP


@contextlib.contextmanager
def local_only() -> Iterator[None]:
    """No current group inside the block: the coordinator's own work (sample
    grids, the in-training SWD) runs the model on its own rows without a
    collective that the other processes would never join."""
    prev = current_group()
    set_current_group(None)
    try:
        yield
    finally:
        set_current_group(prev)


def world_size(group=None) -> int:
    """The processes of ``group``; 1 without one."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's index in ``group``; 0 without one."""
    return 0 if group is None else dist.get_rank(group)


def barrier(group=None) -> None:
    """Wait for every process of ``group`` (nothing without one)."""
    if group is not None:
        dist.barrier(group=group)


def _broadcast_(tensors: list[torch.Tensor], group) -> None:
    """Broadcast ``tensors`` from the group's first process in place, one
    flat bucket per dtype and device."""
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    src = dist.get_global_rank(group, 0)
    for same in buckets.values():
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.broadcast(flat, src=src, group=group)
        for t, part in zip(same, torch.split(flat, [t.numel() for t in same])):
            with torch.no_grad():
                t.copy_(part.view_as(t))


def replicate(state, group=None):
    """Every parameter, buffer and optimizer slot of the ``GanTrainState``
    ``state`` made equal to the first process's, and the state returned.
    The processes start from the same seed, so this only guards against
    drift (a restore that read another file, a nondeterministic init)."""
    group = group if group is not None else current_group()
    if group is None:
        return state
    from twingan_tpu_torch.train.state import state_from_dict, state_to_dict

    device = state.gdrop_strength.device
    flat = {k: v.to(device) for k, v in state_to_dict(state).items()}
    _broadcast_(list(flat.values()), group)
    return state_from_dict(state, flat)


def shard_batch(batch: Mapping[str, Any], group=None) -> dict:
    """This process's rows of ``batch``, a flat mapping of arrays or
    tensors whose first axis is the global batch, which every process
    holds whole: each sliced by ``local_batch_slice``."""
    from twingan_tpu_torch.parallel.multihost import local_batch_slice

    group = group if group is not None else current_group()
    return {k: v[local_batch_slice(v.shape[0], group)] for k, v in batch.items()}
