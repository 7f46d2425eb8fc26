"""Parallelism over a ``torch.distributed`` DeviceMesh: mesh
construction, parameter and batch placements, and the multi-process
runtime (port of trlx_tpu.parallel).

- **dp** (data parallel): batches shard over it; each process runs its
  rows and the gradients are summed across it.
- **fsdp** (fully-sharded data parallel): parameters and optimizer
  moments are sharded over it and gathered on use (ZeRO-3). Batches
  shard over (dp, fsdp) jointly, so fsdp processes also contribute data
  parallelism.
- **tp** (tensor parallel): Megatron-style (column-parallel
  in-projections, row-parallel out-projections): in the training and
  scoring forwards each process computes its heads and its part of the
  MLP width, and the row-parallel products are summed over tp. Where tp
  does not divide the heads or the MLP width the parameters are only
  stored so, and the flash kernels alone split the heads.
- **sp** (sequence parallel): each process of an sp group runs its
  chunk of every sequence's positions, and attention passes the key /
  value chunks around the group (trlx_tpu_torch.ops.ring_attention);
  per-token results are gathered over it before the losses, and the
  gradients are summed across it.
- **pp** (pipeline parallel): the frozen trunk's stacked layer axis is
  split over it, and microbatches stream through the stages
  (trlx_tpu_torch.ops.pipeline_parallel, GPipe); the trunk's output is
  broadcast to every stage, so what follows runs replicated over pp.
  sp and pp do not combine (trlx_tpu refuses it too).

Parameters are DTensors with the placements of trlx_tpu's leaf rules
(:func:`param_placements`), and the trainers' steps compute on each
process's rows with each parameter gathered on use
(trlx_tpu_torch.parallel.sharding). Rollout decoding runs each
process's rows at the whole width.
"""

from trlx_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES,
    axis_group,
    build_mesh,
    mesh_from_config,
    mesh_sizes,
    single_device_mesh,
)
from trlx_tpu_torch.parallel.runtime import (  # noqa: F401
    broadcast_host_floats,
    initialize_runtime,
    is_main_process,
    process_count,
    process_index,
)
from trlx_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    param_placements,
    param_sharding_specs,
    param_shardings,
    relayout_for_decode,
    replicated,
    shard_batch,
    shard_params,
    sharded_opt_init,
)
