"""Data parallelism over ``torch.distributed`` process groups.

Counterpart of ``twingan_tpu/parallel``: one process per device (NCCL on
the card, gloo on the CPU), the parameters replicated, each process
training on its rows of the global batch, the gradients all-reduced by
the trainers, and the model's batch reductions (batch norm's moments,
minibatch stddev, context-parallel attention) issued as collectives over
the current group (``mesh.py``, ``multihost.py``).
"""

from twingan_tpu_torch.parallel.mesh import (
    barrier,
    current_group,
    local_only,
    rank,
    replicate,
    set_current_group,
    shard_batch,
    world_size,
)
from twingan_tpu_torch.parallel.multihost import (
    all_gather,
    all_reduce_mean,
    all_reduce_mean_,
    all_to_all,
    draw_rows,
    init_group,
    initialize_from_env,
    local_batch_slice,
    local_rows,
    make_global_array,
)
