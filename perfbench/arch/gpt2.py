"""GPT-2 (openai-community/gpt2) in Hugging Face's layout: learned
positions, a sequential block with two layer norms, Conv1D weights stored
[in, out], the tanh GELU, and the LM head tied to the token embedding.

One architecture's module (``harness.arch``): its checkpoint layout, its
reference math, its names, the program's leaves and its FLOP count.
"""

from typing import Dict

import torch

from perfbench.reference.gpt import attend, gelu, layer_norm

# -- checkpoint layout ------------------------------------------------- #


def layer_prefix(cfg: Dict, i: int) -> str:
    return f"transformer.h.{i}."


def final_prefixes(cfg: Dict):
    """The parameters after the last block: the final norm (the head is
    the embedding)."""
    return ("transformer.ln_f.",)


def matrices(cfg: Dict):
    """(name, shape, residual) of every matrix, in fill order."""
    d, f, V = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    out = [("transformer.wte.weight", (V, d), False),
           ("transformer.wpe.weight", (cfg["n_positions"], d), False)]
    for i in range(cfg["n_layer"]):
        h = layer_prefix(cfg, i)
        out += [(h + "attn.c_attn.weight", (d, 3 * d), False),
                (h + "attn.c_proj.weight", (d, d), True),
                (h + "mlp.c_fc.weight", (d, f), False),
                (h + "mlp.c_proj.weight", (f, d), True)]
    return out


def vectors(cfg: Dict):
    """(name, size, value) of every bias and norm parameter."""
    d, f = cfg["d_model"], cfg["d_ff"]
    out = [("transformer.ln_f.weight", d, 1.0),
           ("transformer.ln_f.bias", d, 0.0)]
    for i in range(cfg["n_layer"]):
        h = layer_prefix(cfg, i)
        out += [(h + "ln_1.weight", d, 1.0), (h + "ln_1.bias", d, 0.0),
                (h + "ln_2.weight", d, 1.0), (h + "ln_2.bias", d, 0.0),
                (h + "attn.c_attn.bias", 3 * d, 0.0),
                (h + "attn.c_proj.bias", d, 0.0),
                (h + "mlp.c_fc.bias", f, 0.0),
                (h + "mlp.c_proj.bias", d, 0.0)]
    return out


# -- reference math ------------------------------------------------------ #


def embed(get, cfg: Dict, tokens: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    V = cfg["vocab_size"]
    h = get("transformer.wte.weight")[tokens.long().clamp(0, V - 1)].float()
    return h + get("transformer.wpe.weight")[positions].float()


def block(get, cfg: Dict, i: int, h: torch.Tensor, bias: torch.Tensor,
          positions: torch.Tensor, prec, mask: torch.Tensor) -> torch.Tensor:
    """Block ``i`` on h [B, T, d] (float32); ``get(name)`` returns the
    checkpoint tensor of that name. The row mask is not read: attention
    sees keys through ``bias`` alone."""
    B, T, d = h.shape
    H = cfg["n_head"]
    hd = d // H
    eps = cfg["layer_norm_epsilon"]
    n = layer_prefix(cfg, i)
    x = layer_norm(h, get(n + "ln_1.weight"), get(n + "ln_1.bias"), eps)
    qkv = prec.mm(x, get(n + "attn.c_attn.weight")) \
        + get(n + "attn.c_attn.bias").float()
    q, k, v = (t.reshape(B, T, H, hd) for t in qkv.split(d, dim=-1))
    a = attend(q, k, v, bias, prec).reshape(B, T, d)
    h = h + prec.mm(a, get(n + "attn.c_proj.weight")) \
        + get(n + "attn.c_proj.bias").float()
    x2 = layer_norm(h, get(n + "ln_2.weight"), get(n + "ln_2.bias"), eps)
    m = gelu(prec.mm(x2, get(n + "mlp.c_fc.weight"))
             + get(n + "mlp.c_fc.bias").float())
    return h + prec.mm(m, get(n + "mlp.c_proj.weight")) \
        + get(n + "mlp.c_proj.bias").float()


def final_norm(get, cfg: Dict, h: torch.Tensor) -> torch.Tensor:
    return layer_norm(h, get("transformer.ln_f.weight"),
                      get("transformer.ln_f.bias"), cfg["layer_norm_epsilon"])


def lm_logits(get, cfg: Dict, hn: torch.Tensor, prec) -> torch.Tensor:
    """Float32 logits of the normed hidden ``hn``: the tied embedding."""
    return prec.linear(hn, get("transformer.wte.weight"))


# -- the program's leaves ------------------------------------------------ #


def _third(k: int):
    return lambda t: t.chunk(3, dim=-1)[k]


#: (checkpoint name pattern, [(program leaf, part of the tensor or None)])
LEAVES = [
    (r"transformer\.wte\.weight", [("embed.wte", None)]),
    (r"transformer\.wpe\.weight", [("embed.wpe", None)]),
    (r"transformer\.ln_f\.weight", [("ln_f.scale", None)]),
    (r"transformer\.ln_f\.bias", [("ln_f.bias", None)]),
    (r"transformer\.h\.\d+\.ln_1\.weight", [("blocks.ln_1.scale", None)]),
    (r"transformer\.h\.\d+\.ln_1\.bias", [("blocks.ln_1.bias", None)]),
    (r"transformer\.h\.\d+\.ln_2\.weight", [("blocks.ln_2.scale", None)]),
    (r"transformer\.h\.\d+\.ln_2\.bias", [("blocks.ln_2.bias", None)]),
    (r"transformer\.h\.\d+\.attn\.c_attn\.weight",
     [("blocks.attn.wq", _third(0)), ("blocks.attn.wk", _third(1)),
      ("blocks.attn.wv", _third(2))]),
    (r"transformer\.h\.\d+\.attn\.c_attn\.bias",
     [("blocks.attn.bq", _third(0)), ("blocks.attn.bk", _third(1)),
      ("blocks.attn.bv", _third(2))]),
    (r"transformer\.h\.\d+\.attn\.c_proj\.weight",
     [("blocks.attn.wo", None)]),
    (r"transformer\.h\.\d+\.attn\.c_proj\.bias", [("blocks.attn.bo", None)]),
    (r"transformer\.h\.\d+\.mlp\.c_fc\.weight", [("blocks.mlp.w_in", None)]),
    (r"transformer\.h\.\d+\.mlp\.c_fc\.bias", [("blocks.mlp.b_in", None)]),
    (r"transformer\.h\.\d+\.mlp\.c_proj\.weight",
     [("blocks.mlp.w_out", None)]),
    (r"transformer\.h\.\d+\.mlp\.c_proj\.bias", [("blocks.mlp.b_out", None)]),
]

# -- FLOP count and geometry --------------------------------------------- #


def layer_flops_per_token(cfg: Dict, i: int) -> int:
    """Forward FLOPs of block ``i``'s projections for one token: q, k, v,
    o and the two MLP matrices."""
    d, f = cfg["d_model"], cfg["d_ff"]
    return 2 * (4 * d * d + 2 * d * f)


def attention_width(cfg: Dict, i: int) -> int:
    """H x hd of block ``i``'s attention: every block attends."""
    return cfg["d_model"]


def kv_heads(cfg: Dict) -> int:
    return cfg["n_head"]
