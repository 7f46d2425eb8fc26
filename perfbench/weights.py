"""Seeded checkpoints in Hugging Face's layout, made on the device.

Both sides of a run read these: the program through its own converter,
and the plain reference (``perfbench/reference``) directly. Every matrix
is a view of one flat buffer that a single ``normal_`` call fills from a
generator on the device, so a 6B checkpoint takes a few large calls and
the same seed gives the same bytes again after the program is gone.

N(0, 0.02) matrices, the residual projections (attention out and MLP
out) scaled by 1 / sqrt(2 n_layer), zero biases, unit norm scales.
"""

import math
from typing import Dict, List, Tuple

import torch


def _matrices(cfg: Dict) -> List[Tuple[str, tuple, bool]]:
    """(name, shape, residual) of every matrix of the checkpoint."""
    d, f, V, L = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"], \
        cfg["n_layer"]
    out = [("transformer.wte.weight", (V, d), False)]
    if cfg["arch"] == "gpt2":
        out.append(("transformer.wpe.weight", (cfg["n_positions"], d),
                    False))
        for i in range(L):
            h = f"transformer.h.{i}."
            out += [(h + "attn.c_attn.weight", (d, 3 * d), False),
                    (h + "attn.c_proj.weight", (d, d), True),
                    (h + "mlp.c_fc.weight", (d, f), False),
                    (h + "mlp.c_proj.weight", (f, d), True)]
        return out
    if cfg["arch"] != "gptj":
        raise ValueError(f"no checkpoint layout for arch {cfg['arch']!r}")
    for i in range(L):
        h = f"transformer.h.{i}."
        out += [(h + "attn.q_proj.weight", (d, d), False),
                (h + "attn.k_proj.weight", (d, d), False),
                (h + "attn.v_proj.weight", (d, d), False),
                (h + "attn.out_proj.weight", (d, d), True),
                (h + "mlp.fc_in.weight", (f, d), False),
                (h + "mlp.fc_out.weight", (d, f), True)]
    out.append(("lm_head.weight", (V, d), False))
    return out


def _vectors(cfg: Dict) -> List[Tuple[str, int, float]]:
    """(name, size, value) of every bias and norm parameter."""
    d, f, V, L = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"], \
        cfg["n_layer"]
    out = [("transformer.ln_f.weight", d, 1.0),
           ("transformer.ln_f.bias", d, 0.0)]
    for i in range(L):
        h = f"transformer.h.{i}."
        out += [(h + "ln_1.weight", d, 1.0), (h + "ln_1.bias", d, 0.0)]
        if cfg["arch"] == "gpt2":
            out += [(h + "ln_2.weight", d, 1.0), (h + "ln_2.bias", d, 0.0),
                    (h + "attn.c_attn.bias", 3 * d, 0.0),
                    (h + "attn.c_proj.bias", d, 0.0),
                    (h + "mlp.c_fc.bias", f, 0.0),
                    (h + "mlp.c_proj.bias", d, 0.0)]
        else:
            out += [(h + "mlp.fc_in.bias", f, 0.0),
                    (h + "mlp.fc_out.bias", d, 0.0)]
    if cfg["arch"] == "gptj":
        out.append(("lm_head.bias", V, 0.0))
    return out


@torch.no_grad()
def state_dict(cfg: Dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The seeded checkpoint of model config ``cfg`` (perfbench/configs'
    ``spec`` block) on ``device`` in ``dtype``."""
    mats = _matrices(cfg)
    total = sum(math.prod(shape) for _, shape, _ in mats)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(0.0, 0.02, generator=gen)
    resid = 1.0 / math.sqrt(2 * cfg["n_layer"])
    sd, at = {}, 0
    for name, shape, residual in mats:
        n = math.prod(shape)
        view = flat[at:at + n].view(shape)
        if residual:
            view.mul_(resid)
        sd[name] = view
        at += n
    vecs = _vectors(cfg)
    ones = torch.ones(sum(n for _, n, v in vecs if v == 1.0), dtype=dtype,
                      device=device)
    zeros = torch.zeros(sum(n for _, n, v in vecs if v == 0.0), dtype=dtype,
                        device=device)
    at_one = at_zero = 0
    for name, n, value in vecs:
        if value == 1.0:
            sd[name] = ones[at_one:at_one + n]
            at_one += n
        else:
            sd[name] = zeros[at_zero:at_zero + n]
            at_zero += n
    return sd
