"""GPT-J (EleutherAI/gpt-j-6b) in Hugging Face's layout: a parallel block
(attention and MLP both read one ``ln_1``) with rotary embeddings on the
first ``rotary_dim`` dimensions of each head, rotated every two, the tanh
GELU, and an untied LM head with a bias.

One architecture's module (``harness.arch``): its checkpoint layout, its
reference math, its names, the program's leaves and its FLOP count.
"""

from typing import Dict

import torch

from perfbench.reference.gpt import attend, gelu, layer_norm, rotary

# -- checkpoint layout ------------------------------------------------- #


def layer_prefix(cfg: Dict, i: int) -> str:
    return f"transformer.h.{i}."


def final_prefixes(cfg: Dict):
    """The parameters after the last block: the final norm and the LM
    head."""
    return ("transformer.ln_f.", "lm_head.")


def matrices(cfg: Dict):
    """(name, shape, residual) of every matrix, in fill order."""
    d, f, V = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    out = [("transformer.wte.weight", (V, d), False)]
    for i in range(cfg["n_layer"]):
        h = layer_prefix(cfg, i)
        out += [(h + "attn.q_proj.weight", (d, d), False),
                (h + "attn.k_proj.weight", (d, d), False),
                (h + "attn.v_proj.weight", (d, d), False),
                (h + "attn.out_proj.weight", (d, d), True),
                (h + "mlp.fc_in.weight", (f, d), False),
                (h + "mlp.fc_out.weight", (d, f), True)]
    out.append(("lm_head.weight", (V, d), False))
    return out


def vectors(cfg: Dict):
    """(name, size, value) of every bias and norm parameter."""
    d, f = cfg["d_model"], cfg["d_ff"]
    out = [("transformer.ln_f.weight", d, 1.0),
           ("transformer.ln_f.bias", d, 0.0)]
    for i in range(cfg["n_layer"]):
        h = layer_prefix(cfg, i)
        out += [(h + "ln_1.weight", d, 1.0), (h + "ln_1.bias", d, 0.0),
                (h + "mlp.fc_in.bias", f, 0.0),
                (h + "mlp.fc_out.bias", d, 0.0)]
    out.append(("lm_head.bias", cfg["vocab_size"], 0.0))
    return out


# -- reference math ------------------------------------------------------ #


def embed(get, cfg: Dict, tokens: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    V = cfg["vocab_size"]
    return get("transformer.wte.weight")[
        tokens.long().clamp(0, V - 1)].float()


def block(get, cfg: Dict, i: int, h: torch.Tensor, bias: torch.Tensor,
          positions: torch.Tensor, prec, mask: torch.Tensor) -> torch.Tensor:
    """Block ``i`` on h [B, T, d] (float32); ``get(name)`` returns the
    checkpoint tensor of that name. The row mask is not read: attention
    sees keys through ``bias`` alone."""
    B, T, d = h.shape
    H = cfg["n_head"]
    hd = d // H
    n = layer_prefix(cfg, i)
    x = layer_norm(h, get(n + "ln_1.weight"), get(n + "ln_1.bias"),
                   cfg["layer_norm_epsilon"])
    q, k, v = (prec.linear(x, get(n + f"attn.{p}_proj.weight")).reshape(
        B, T, H, hd) for p in "qkv")
    rot = cfg["rotary_dim"]
    q, k = rotary(q, positions, rot), rotary(k, positions, rot)
    a = attend(q, k, v, bias, prec).reshape(B, T, d)
    a = prec.linear(a, get(n + "attn.out_proj.weight"))
    m = gelu(prec.linear(x, get(n + "mlp.fc_in.weight"),
                         get(n + "mlp.fc_in.bias")))
    m = prec.linear(m, get(n + "mlp.fc_out.weight"),
                    get(n + "mlp.fc_out.bias"))
    return h + a + m


def final_norm(get, cfg: Dict, h: torch.Tensor) -> torch.Tensor:
    return layer_norm(h, get("transformer.ln_f.weight"),
                      get("transformer.ln_f.bias"), cfg["layer_norm_epsilon"])


def lm_logits(get, cfg: Dict, hn: torch.Tensor, prec) -> torch.Tensor:
    """Float32 logits of the normed hidden ``hn``: the untied head with
    its bias."""
    return prec.linear(hn, get("lm_head.weight"), get("lm_head.bias"))


# -- the program's leaves ------------------------------------------------ #

#: (checkpoint name pattern, [(program leaf, part of the tensor or None)])
LEAVES = [
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
