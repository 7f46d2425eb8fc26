"""Hydra policy: shared frozen trunk, trainable top, frozen reference top,
value head (port of trlx_tpu.models.policy).

A hydra param tree is ``{"frozen_base": {"embed", "blocks"},
"trainable": {"blocks", "ln_f", "v_head"[, "lm_head"]}, "ref":
{"blocks", "ln_f"[, "lm_head"]}}`` with stacked [L, ...] blocks: the
bottom ``L - k`` blocks and the embeddings are frozen, the top ``k``
blocks train, and ``ref`` is the init-time copy of the trainable
transformer part. One forward runs the trunk once and branches twice.

Gradients are taken only w.r.t. ``trainable`` in the JAX package, and
the reference branch sits under ``stop_gradient``; here the trunk and
the reference branch run under ``torch.no_grad()``, which is the same
thing and keeps no activations for them. ``remat`` recomputes each
trainable block in the backward (``torch.utils.checkpoint``).

On a mesh (trlx_tpu_torch.parallel) two more axes reach the forward.
``pp_mesh`` with pp > 1 runs the frozen trunk through the GPipe schedule
(trlx_tpu_torch.ops.pipeline_parallel), each stage on its slab of
layers, its output the same on every stage. ``sp`` (a
trlx_tpu_torch.ops.ring_attention ``SequenceSplit``) runs the trunk,
both tops and the value head on this rank's chunk of positions, whose
position ids are the whole sequence's; attention is then the ring
(``attention_fn``), and :meth:`HydraPolicy.forward_hidden` returns the
chunk, which the trainer gathers per token (``sp.gather``).

The decode helpers (:func:`all_blocks`, :func:`head_params_for_decode`)
serve the live policy branch: the frozen bottom then the trainable top,
kept as two segments; they accept numpy or torch leaves.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from trlx_tpu_torch.data.configs import ModelSpec
from trlx_tpu_torch.models.heads import head_apply
from trlx_tpu_torch.models.transformer import (
    apply_blocks,
    attention_scores,
    embed_tokens,
    layer_norm,
    mask_arg_for,
    positions_from_mask,
    project_logits,
    tree_map,
)

Params = Dict[str, Any]


def resolve_num_unfrozen(spec: ModelSpec, num_layers_unfrozen: int) -> int:
    """k trainable top blocks; -1 means all blocks."""
    if num_layers_unfrozen < 0:
        return spec.n_layer
    return min(num_layers_unfrozen, spec.n_layer)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _cast(x, dtype):
    return x.astype(dtype) if hasattr(x, "astype") else x.to(dtype)


def all_blocks(params: Params) -> Tuple[Params, Params]:
    """(bottom, trainable top) stacked segments, run in order. The top is
    cast to the frozen storage dtype, as trlx_tpu does: where the dtypes
    already match, the trainer's own tensors come back, which a captured
    decode step reads in place; a real cast makes new tensors each call,
    which the step's CUDA graph copies in (trlx_tpu_torch.utils.aotjit)."""
    bottom = params["frozen_base"]["blocks"]
    frozen_dtype = _first_leaf(bottom).dtype
    top = tree_map(lambda b: _cast(b, frozen_dtype),
                   params["trainable"]["blocks"])
    return bottom, top


def head_params_for_decode(params: Params) -> Tuple[Params, Params]:
    """(embed + lm_head dict, ln_f) of the live policy branch."""
    embed = dict(params["frozen_base"]["embed"])
    if "lm_head" in params["trainable"]:
        embed["lm_head"] = params["trainable"]["lm_head"]
    return embed, params["trainable"]["ln_f"]


@dataclass(frozen=True)
class HydraPolicy:
    """Static description of a hydra policy; the methods are functions of
    the param tree."""

    spec: ModelSpec
    num_layers_unfrozen: int = -1
    compute_dtype: Any = torch.bfloat16
    remat: bool = False
    attention_fn: Any = None  # None => plain attention
    #: trlx_tpu_torch.parallel.sharding.TensorParallel: the blocks' tp
    #: compute on a mesh (their tp-ruled leaves are then shards)
    tp: Any = None
    #: GPipe of the frozen trunk over this mesh's pp axis when it is > 1
    #: (the trainers set it from train.mesh), in pp_n_micro microbatches
    pp_mesh: Any = None
    pp_n_micro: int = 4
    #: trlx_tpu_torch.ops.ring_attention.SequenceSplit: this rank's chunk
    #: of positions under sp > 1
    sp: Any = None

    @property
    def k(self) -> int:
        return resolve_num_unfrozen(self.spec, self.num_layers_unfrozen)

    def _attn(self):
        return self.attention_fn or attention_scores

    def _pp_active(self) -> bool:
        return pp_active(self.pp_mesh)

    def _trunk(self, params: Params, tokens, attention_mask):
        """Embeddings + the frozen bottom blocks, without gradient; under
        sp on this rank's chunk of positions."""
        with torch.no_grad():
            positions = positions_from_mask(attention_mask)
            if self.sp is not None:
                tokens, attention_mask, positions = (
                    self.sp.chunk(x) for x in (tokens, attention_mask,
                                               positions))
            mask_arg = mask_arg_for(self._attn(), attention_mask)
            h = embed_tokens(params["frozen_base"]["embed"], self.spec,
                             tokens, positions, self.compute_dtype)
            h = frozen_trunk(self, params["frozen_base"]["blocks"], h,
                             mask_arg, positions)
        return h, mask_arg, positions

    def _branch_hidden(self, branch: Params, h, mask_arg, positions):
        """A top branch's blocks + final norm: the post-ln_f hidden that
        both the lm head and the value head read."""
        h = apply_blocks(branch["blocks"], self.spec, h, mask_arg, positions,
                         attention_fn=self._attn(), remat=self.remat,
                         tp=self.tp)
        return layer_norm(branch["ln_f"], h, self.spec.layer_norm_epsilon)

    def branch_head_fn(self, branch: Params, embed: Params):
        """h_normed [B, T, D] -> float32 logits [B, T, V] for a branch."""
        head_params = dict(embed)
        if "lm_head" in branch:
            head_params["lm_head"] = branch["lm_head"]
        return lambda h_normed: project_logits(head_params, self.spec,
                                               h_normed)

    def forward(self, params: Params, tokens, attention_mask,
                with_ref: bool = True,
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """(logits [B, T, V] float32, ref_logits | None, values [B, T]
        float32); the trunk runs once. Under sp, this rank's chunk of
        T."""
        h_top, h_ref, values = self.forward_hidden(params, tokens,
                                                   attention_mask, with_ref)
        embed = params["frozen_base"]["embed"]
        logits = self.branch_head_fn(params["trainable"], embed)(h_top)
        ref_logits = None
        if with_ref:
            with torch.no_grad():
                ref_logits = self.branch_head_fn(params["ref"], embed)(h_ref)
        return logits, ref_logits, values

    def forward_hidden(self, params: Params, tokens, attention_mask,
                       with_ref: bool = True):
        """Trunk + both top branches without the lm-head projection:
        (h_policy_normed [B, T, D], h_ref_normed | None, values [B, T]);
        under sp, this rank's chunk of T."""
        h, mask_arg, positions = self._trunk(params, tokens, attention_mask)
        h_top = self._branch_hidden(params["trainable"], h, mask_arg,
                                    positions)
        values = head_apply(params["trainable"]["v_head"], h_top)[..., 0]
        h_ref = None
        if with_ref:
            with torch.no_grad():
                h_ref = self._branch_hidden(params["ref"], h, mask_arg,
                                            positions)
        return h_top, h_ref, values


def pp_active(pp_mesh) -> bool:
    """Whether ``pp_mesh`` pipelines the frozen trunk (its pp axis > 1)."""
    if pp_mesh is None:
        return False
    from trlx_tpu_torch.parallel.mesh import mesh_sizes

    return mesh_sizes(pp_mesh)["pp"] > 1


def frozen_trunk(model, blocks: Params, h, mask_arg, positions):
    """``model``'s frozen bottom blocks on ``h``: the GPipe schedule over
    its ``pp_mesh`` when that pipelines (the blocks are then this stage's
    slab), else :func:`apply_blocks`."""
    if pp_active(model.pp_mesh):
        from trlx_tpu_torch.ops.pipeline_parallel import pp_apply_blocks

        return pp_apply_blocks(model.pp_mesh, blocks, model.spec, h,
                               mask_arg, positions,
                               n_micro=model.pp_n_micro,
                               attention_fn=model._attn(), tp=model.tp)
    return apply_blocks(blocks, model.spec, h, mask_arg, positions,
                        attention_fn=model._attn(), tp=model.tp)
