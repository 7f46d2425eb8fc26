"""Hydra-policy decode helpers (port of the decode half of
trlx_tpu.models.policy, ``policy.py:261-282``).

A hydra param tree is ``{"frozen_base": {"embed", "blocks"},
"trainable": {"blocks", "ln_f", "v_head"[, "lm_head"]}, "ref": ...}``
with stacked [L, ...] blocks. Serving runs the live policy branch only:
the frozen bottom blocks then the trainable top (kept as two segments,
never concatenated), embed (+ the trainable lm_head when untied) and
the trainable ln_f. The helpers accept numpy or torch leaves.
"""

from typing import Any, Dict, Tuple

from trlx_tpu_torch.data.configs import ModelSpec
from trlx_tpu_torch.models.transformer import tree_map

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
    cast to the frozen storage dtype, as trlx_tpu does."""
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
