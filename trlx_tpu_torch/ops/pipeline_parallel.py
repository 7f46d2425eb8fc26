"""GPipe over the mesh's ``pp`` axis (port of
trlx_tpu.ops.pipeline_parallel).

The stacked-layer trunk [L, ...] splits into ``pp`` stages, one
contiguous slab of L / pp layers each (:func:`shard_blocks_pp`: the
layer axis ``Shard(0)`` over pp). With P stages and M microbatches the
schedule runs M + P - 1 ticks; at tick t stage s runs microbatch t - s
(when in range) through its layers and hands the activation to stage
s + 1 (:mod:`trlx_tpu_torch.parallel.exchange`: one neighbour hop a
tick, sent and received only where a microbatch moves). The last
stage's outputs are then broadcast to every stage, as trlx_tpu's masked
``psum`` does, so the trainable top and the losses that follow run
alike on every pp rank. Bubble fraction (P - 1) / (M + P - 1).

Scope, as trlx_tpu uses it: the frozen trunk only. trlx_tpu's trainers
refuse a trunk of zero frozen layers under pp, and the embeddings train
only at full unfreeze, so nothing upstream of the trunk's output needs
a gradient: the schedule runs under ``torch.no_grad()`` and keeps no
activations. Decode keeps its dense path on the whole trunk.

:func:`pp_apply_blocks` is the mesh entry (this process's stage);
:func:`pp_apply_blocks_loopback` runs every stage in this process, for
the CPU tests and the chip smoke.
"""

from typing import Any, Dict, List

import torch

from trlx_tpu_torch.models.transformer import (
    apply_blocks,
    attention_scores,
    num_layers,
    tree_map,
)
from trlx_tpu_torch.parallel.exchange import LoopbackExchange, P2PExchange

Params = Dict[str, Any]


def shard_blocks_pp(mesh, blocks: Params) -> Params:
    """Stacked [L, ...] blocks (plain tensors, the same on every process)
    as DTensors with the layer axis over ``pp``, replicated over the
    other axes: each stage holds L / pp contiguous layers."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from trlx_tpu_torch.parallel.mesh import AXES

    placements = [Shard(0) if ax == "pp" else Replicate() for ax in AXES]
    return tree_map(lambda x: distribute_tensor(
        x.detach(), mesh, placements, src_data_rank=None), blocks)


def _global_layers(blocks: Params, pp: int) -> int:
    """The trunk's layer count: a DTensor leaf's global extent, or a
    plain leaf's (this stage's slab) times pp."""
    from trlx_tpu_torch.parallel.sharding import is_dtensor

    leaf = blocks
    while isinstance(leaf, (dict, tuple, list)):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) \
            else leaf[0]
    return leaf.shape[0] if is_dtensor(leaf) else leaf.shape[0] * pp


def _check(B: int, L: int, pp: int, n_micro: int) -> None:
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    if L % pp:
        raise ValueError(f"n_layer {L} not divisible by pp={pp}")


def _gpipe(ex, stages: List[Params], spec, h, mask_bias, positions,
           n_micro: int, attention_fn, tp) -> List[torch.Tensor]:
    """The schedule for every local stage; each gets the last stage's
    outputs [B, T, D]."""
    B = h.shape[0]
    mb = B // n_micro

    def micro(x, m):
        return x[m * mb:(m + 1) * mb]

    P = ex.n
    template = [micro(h, 0)]
    outs = [torch.zeros_like(h) for _ in ex.ranks]
    cur: List = [None] * len(ex.ranks)
    for t in range(n_micro + P - 1):
        sends = []
        for i, s in enumerate(ex.ranks):
            m = t - s
            if not 0 <= m < n_micro:
                sends.append(None)
                continue
            h_in = micro(h, m) if s == 0 else cur[i]
            h_out = apply_blocks(stages[i], spec, h_in,
                                 micro(mask_bias, m), micro(positions, m),
                                 attention_fn=attention_fn, tp=tp)
            if s == P - 1:
                outs[i][m * mb:(m + 1) * mb] = h_out
                sends.append(None)
            else:
                sends.append([h_out])
        recv_like = [template if s > 0 and 0 <= t - s + 1 < n_micro
                     else None for s in ex.ranks]
        cur = [None if r is None else r[0]
               for r in ex.shift(sends, recv_like, wrap=False)]
    return [o[0] for o in ex.broadcast([[o] for o in outs], src=P - 1)]


def _stage(blocks: Params, tp) -> Params:
    """This process's slab of pp-sharded blocks as plain tensors (a
    DTensor leaf gathered over every axis but pp, and tp where the
    blocks keep their tp shards)."""
    from trlx_tpu_torch.parallel.sharding import unshard

    return tree_map(lambda x: unshard(x, keep_tp=tp is not None,
                                      keep_pp=True), blocks)


@torch.no_grad()
def pp_apply_blocks(mesh, blocks: Params, spec, h: torch.Tensor,
                    mask_bias: torch.Tensor, positions: torch.Tensor,
                    n_micro: int = 4, attention_fn=None,
                    tp=None) -> torch.Tensor:
    """Forward ``h`` [B, T, D] (this process's rows) through pp-sharded
    stacked blocks, every process of the pp group together; the trunk's
    output, the same on every stage. ``blocks``: DTensors from
    :func:`shard_blocks_pp` (or the trainer's placements), or this
    stage's slab as plain tensors. Equals :func:`apply_blocks` on the
    whole trunk; without gradient (module docstring). ``tp``:
    ``block_apply``'s Megatron compute."""
    from trlx_tpu_torch.parallel.mesh import mesh_sizes

    attention_fn = attention_fn or attention_scores
    pp = 1 if mesh is None else mesh_sizes(mesh)["pp"]
    if pp == 1:
        # no microbatching constraints apply
        return apply_blocks(blocks, spec, h, mask_bias, positions,
                            attention_fn=attention_fn, tp=tp)
    _check(h.shape[0], _global_layers(blocks, pp), pp, n_micro)
    return _gpipe(P2PExchange(mesh, "pp"), [_stage(blocks, tp)], spec, h,
                  mask_bias, positions, n_micro, attention_fn, tp)[0]


@torch.no_grad()
def pp_apply_blocks_loopback(blocks: Params, pp: int, spec,
                             h: torch.Tensor, mask_bias: torch.Tensor,
                             positions: torch.Tensor, n_micro: int = 4,
                             attention_fn=None) -> torch.Tensor:
    """The GPipe schedule of ``pp`` stages run in this process: the
    whole stacked ``blocks`` split into contiguous slabs, one a stage."""
    attention_fn = attention_fn or attention_scores
    if pp == 1:
        return apply_blocks(blocks, spec, h, mask_bias, positions,
                            attention_fn=attention_fn)
    L = num_layers(blocks)
    _check(h.shape[0], L, pp, n_micro)
    per = L // pp
    stages = [tree_map(lambda x, s=s: x[s * per:(s + 1) * per], blocks)
              for s in range(pp)]
    return _gpipe(LoopbackExchange(pp), stages, spec, h, mask_bias,
                  positions, n_micro, attention_fn, None)[0]
