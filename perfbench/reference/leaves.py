"""Norms of the reference's tensors, grouped as the program groups its
parameters into leaves (per block matrix, stacked over the layers it
trains; q, k and v apart), so that the two sides compare leaf by leaf.
The names are the program's tree paths, as plain strings."""

import re
from typing import Dict

import torch

# (checkpoint name pattern, [(leaf, column slice in thirds or None)])
_GPT2 = [
    (r"transformer\.wte\.weight", [("embed.wte", None)]),
    (r"transformer\.wpe\.weight", [("embed.wpe", None)]),
    (r"transformer\.ln_f\.weight", [("ln_f.scale", None)]),
    (r"transformer\.ln_f\.bias", [("ln_f.bias", None)]),
    (r"transformer\.h\.\d+\.ln_1\.weight", [("blocks.ln_1.scale", None)]),
    (r"transformer\.h\.\d+\.ln_1\.bias", [("blocks.ln_1.bias", None)]),
    (r"transformer\.h\.\d+\.ln_2\.weight", [("blocks.ln_2.scale", None)]),
    (r"transformer\.h\.\d+\.ln_2\.bias", [("blocks.ln_2.bias", None)]),
    (r"transformer\.h\.\d+\.attn\.c_attn\.weight",
     [("blocks.attn.wq", 0), ("blocks.attn.wk", 1), ("blocks.attn.wv", 2)]),
    (r"transformer\.h\.\d+\.attn\.c_attn\.bias",
     [("blocks.attn.bq", 0), ("blocks.attn.bk", 1), ("blocks.attn.bv", 2)]),
    (r"transformer\.h\.\d+\.attn\.c_proj\.weight",
     [("blocks.attn.wo", None)]),
    (r"transformer\.h\.\d+\.attn\.c_proj\.bias", [("blocks.attn.bo", None)]),
    (r"transformer\.h\.\d+\.mlp\.c_fc\.weight", [("blocks.mlp.w_in", None)]),
    (r"transformer\.h\.\d+\.mlp\.c_fc\.bias", [("blocks.mlp.b_in", None)]),
    (r"transformer\.h\.\d+\.mlp\.c_proj\.weight",
     [("blocks.mlp.w_out", None)]),
    (r"transformer\.h\.\d+\.mlp\.c_proj\.bias", [("blocks.mlp.b_out", None)]),
]
_GPTJ = [
    (r"transformer\.ln_f\.weight", [("ln_f.scale", None)]),
    (r"transformer\.ln_f\.bias", [("ln_f.bias", None)]),
    (r"lm_head\.weight", [("lm_head.w", None)]),
    (r"lm_head\.bias", [("lm_head.b", None)]),
    (r"transformer\.h\.\d+\.ln_1\.weight", [("blocks.ln_1.scale", None)]),
    (r"transformer\.h\.\d+\.ln_1\.bias", [("blocks.ln_1.bias", None)]),
    (r"transformer\.h\.\d+\.attn\.q_proj\.weight", [("blocks.attn.wq", None)]),
    (r"transformer\.h\.\d+\.attn\.k_proj\.weight", [("blocks.attn.wk", None)]),
    (r"transformer\.h\.\d+\.attn\.v_proj\.weight", [("blocks.attn.wv", None)]),
    (r"transformer\.h\.\d+\.attn\.out_proj\.weight",
     [("blocks.attn.wo", None)]),
    (r"transformer\.h\.\d+\.mlp\.fc_in\.weight", [("blocks.mlp.w_in", None)]),
    (r"transformer\.h\.\d+\.mlp\.fc_in\.bias", [("blocks.mlp.b_in", None)]),
    (r"transformer\.h\.\d+\.mlp\.fc_out\.weight",
     [("blocks.mlp.w_out", None)]),
    (r"transformer\.h\.\d+\.mlp\.fc_out\.bias", [("blocks.mlp.b_out", None)]),
]


def leaf_norms(tensors: Dict[str, torch.Tensor],
               arch: str) -> Dict[str, float]:
    """{program leaf: L2 norm} of reference tensors named as in the
    checkpoint, heads as ``<head>.<w1|b1|w2|b2>``."""
    table = _GPT2 if arch == "gpt2" else _GPTJ
    squares: Dict[str, float] = {}
    for name, t in tensors.items():
        t = t.detach().double()
        if re.fullmatch(r"(v|q1|q2)_head\.(w1|b1|w2|b2)", name):
            parts = [(name, None)]
        else:
            parts = next((p for pat, p in table if re.fullmatch(pat, name)),
                         None)
            if parts is None:
                raise KeyError(f"no program leaf for {name}")
        for leaf, third in parts:
            x = t if third is None else t.chunk(3, dim=-1)[third]
            squares[leaf] = squares.get(leaf, 0.0) + float((x ** 2).sum())
    return {k: v ** 0.5 for k, v in squares.items()}
