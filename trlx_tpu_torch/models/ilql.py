"""ILQL network: trunk + LM head + value head + (double) Q heads + frozen
target-Q heads (port of trlx_tpu.models.ilql).

A param tree is ``{"frozen_base": {"embed", "blocks"}, "trainable":
{"blocks", "ln_f", "v_head", "q1_head"[, "q2_head"][, "lm_head"][,
"embed"]}, "target": {"q1_head"[, "q2_head"]}}`` with stacked [L, ...]
blocks: the bottom ``L - k`` blocks are frozen and the top ``k`` train.
At full unfreeze (k == n_layer) the embeddings train too
(:func:`split_embed_for_unfreeze`): the frozen embed is ``{}``, the
frozen bottom has 0 layers, and a tied LM head learns through the
trainable ``wte``, which then takes gradient from both the lookup and
the logits. Every head reads the post-``ln_f`` hidden state of one
trunk forward; the target heads give no gradient.

Frozen parts run under ``torch.no_grad()``, which keeps no activations
for them (the JAX package differentiates w.r.t. ``trainable`` only).
On a mesh, ``pp_mesh`` and ``sp`` act as in
trlx_tpu_torch.models.policy: GPipe of the frozen trunk over pp, and
under sp the forward on this rank's chunk of positions (their ids the
whole sequence's).
"""

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from trlx_tpu_torch.data.configs import ModelSpec
from trlx_tpu_torch.models.heads import head_apply
from trlx_tpu_torch.models.policy import (
    frozen_trunk,
    pp_active,
    resolve_num_unfrozen,
)
from trlx_tpu_torch.models.transformer import (
    apply_blocks,
    attention_scores,
    embed_tokens,
    layer_norm,
    mask_arg_for,
    project_logits,
)

Params = Dict[str, Any]


def split_embed_for_unfreeze(embed: Params, k: int, spec: ModelSpec):
    """(frozen_embed, trainable_embed | None): at full unfreeze
    (k == n_layer) the embeddings move to the trainable branch, as
    trlx_tpu's ILQL does (the reference's freeze list is empty at
    ``num_layers_unfrozen: -1``); otherwise they stay frozen."""
    if k == spec.n_layer:
        return {}, embed
    return embed, None


@dataclass(frozen=True)
class ILQLModel:
    """Static description of the ILQL network; the methods are functions
    of the param tree."""

    spec: ModelSpec
    num_layers_unfrozen: int = -1
    two_qs: bool = True
    compute_dtype: Any = torch.bfloat16
    remat: bool = False
    attention_fn: Any = None  # None => plain attention
    #: trlx_tpu_torch.parallel.sharding.TensorParallel: the blocks' tp
    #: compute on a mesh (their tp-ruled leaves are then shards)
    tp: Any = None
    #: GPipe of the frozen trunk, as HydraPolicy.pp_mesh
    pp_mesh: Any = None
    pp_n_micro: int = 4
    #: this rank's chunk of positions under sp > 1, as HydraPolicy.sp
    sp: Any = None

    @property
    def k(self) -> int:
        return resolve_num_unfrozen(self.spec, self.num_layers_unfrozen)

    def _pp_active(self) -> bool:
        return pp_active(self.pp_mesh)

    @property
    def q_names(self) -> Tuple[str, ...]:
        return ("q1_head", "q2_head") if self.two_qs else ("q1_head",)

    def _attn(self):
        return self.attention_fn or attention_scores

    def embed_params(self, params: Params) -> Params:
        """The token / position embeddings: trainable at full unfreeze,
        frozen otherwise."""
        return params["trainable"].get("embed",
                                       params["frozen_base"]["embed"])

    def forward(self, params: Params, tokens, attention_mask):
        """(logits [B, T, V], qs tuple, target_qs tuple, vs [B, T]), all
        float32; the target outputs carry no gradient."""
        h_normed = self.forward_hidden(params, tokens, attention_mask)
        lm_fn, q_fns, tq_fns, v_fn = self.head_fns(params)
        return (lm_fn(h_normed), tuple(f(h_normed) for f in q_fns),
                tuple(f(h_normed) for f in tq_fns), v_fn(h_normed))

    def forward_hidden(self, params: Params, tokens, attention_mask):
        """Trunk up to and including the final layernorm: [B, T, D]; under
        sp, this rank's chunk of T.

        Positions are plain arange over T, not derived from the mask: the
        data is right-padded with the terminal token's mask slot zeroed,
        and mask-derived positions would give the terminal token its
        predecessor's position and shift V at the bootstrap target."""
        B, T = tokens.shape
        positions = torch.arange(T, device=tokens.device).expand(B, T)
        if self.sp is not None:
            tokens, attention_mask, positions = (
                self.sp.chunk(x) for x in (tokens, attention_mask,
                                           positions))
        attn = self._attn()
        mask_arg = mask_arg_for(attn, attention_mask)
        frozen_embed = "embed" not in params["trainable"]
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not frozen_embed):
            h = embed_tokens(self.embed_params(params), self.spec, tokens,
                             positions, self.compute_dtype)
        with torch.no_grad():
            h = frozen_trunk(self, params["frozen_base"]["blocks"], h,
                             mask_arg, positions)
        h = apply_blocks(params["trainable"]["blocks"], self.spec, h,
                         mask_arg, positions, attention_fn=attn,
                         remat=self.remat, tp=self.tp)
        return layer_norm(params["trainable"]["ln_f"], h,
                          self.spec.layer_norm_epsilon)

    def head_fns(self, params: Params):
        """(lm_fn, q_fns, tq_fns, v_fn) over a post-ln_f hidden state
        h [..., D]: the first three give float32 [..., V], v_fn [...].
        The LM head is tied through :meth:`embed_params`' ``wte`` unless
        the tree has an ``lm_head``; the target fns run without
        gradient."""
        head_params = dict(self.embed_params(params))
        if "lm_head" in params["trainable"]:
            head_params["lm_head"] = params["trainable"]["lm_head"]

        def lm_fn(h):
            return project_logits(head_params, self.spec, h)

        def trainable_head(name):
            return lambda h: head_apply(params["trainable"][name], h)

        def target_head(name):
            def fn(h):
                with torch.no_grad():
                    return head_apply(params["target"][name], h)
            return fn

        def v_fn(h):
            return head_apply(params["trainable"]["v_head"], h)[..., 0]

        return (lm_fn, tuple(trainable_head(n) for n in self.q_names),
                tuple(target_head(n) for n in self.q_names), v_fn)

    def heads_on_hidden(self, params: Params, h_normed):
        """(min target Q [..., V], v [..., 1]) on a post-ln_f hidden
        state: the decode-time pieces of the advantage-shifted sampler."""
        tq = head_apply(params["target"]["q1_head"], h_normed)
        if self.two_qs:
            tq = torch.minimum(
                tq, head_apply(params["target"]["q2_head"], h_normed))
        return tq, head_apply(params["trainable"]["v_head"], h_normed)

    def all_blocks(self, params: Params):
        """(frozen bottom, trainable top) stacked segments for decode."""
        return (params["frozen_base"]["blocks"],
                params["trainable"]["blocks"])

    def head_params_for_decode(self, params: Params):
        """(embed + lm_head dict, ln_f) for decode."""
        embed = dict(self.embed_params(params))
        if "lm_head" in params["trainable"]:
            embed["lm_head"] = params["trainable"]["lm_head"]
        return embed, params["trainable"]["ln_f"]


@torch.no_grad()
def sync_targets(params: Params, alpha: float) -> None:
    """Polyak update in place: target <- alpha * q + (1 - alpha) * target,
    in float32 as trlx_tpu's pytree lerp computes it. DTensor heads update
    their shards on this process (a target leaf and its Q-head leaf share
    their placements)."""
    from trlx_tpu_torch.parallel.sharding import local

    for name, tgt in params["target"].items():
        src = params["trainable"][name]
        for key, t in tgt.items():
            t, q = local(t), local(src[key])
            t.copy_(alpha * q.float() + (1.0 - alpha) * t.float())
