"""What the plain reference of every architecture shares: how products
are computed (:class:`Precision`), softmax attention, rotary embeddings,
the layer norm and the tanh GELU, positions and the causal key mask, the
trunk over an architecture's blocks, and the MLP heads the algorithms
train beside it. Each architecture's own math (embedding, block, final
norm, LM head) is its module ``perfbench/arch/<arch>.py``, found through
``harness.arch``; it reads a checkpoint in Hugging Face's layout
(``perfbench/weights.py``).

Positions count real tokens from 0 under left padding, and padded keys
are masked, as Hugging Face does with a position-id and attention-mask
input.

Every matrix product goes through :class:`Precision`: float32 with TF32
off (the reference), or the inputs of each product rounded to float8
e4m3 with a scale per row first (the control, one step below the bf16
the configurations state).
"""

import contextlib
import math
from typing import Dict, Optional

import torch

from perfbench import harness

NEG = -1e9  # finite additive mask: a fully masked row stays finite


class Precision:
    """How the products of the reference are computed."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as float32, through float8 e4m3 (scaled per row of its
        last dimension) in the control."""
        x = x.float()
        if self.name == "float32":
            return x
        amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., in] @ w [in, out]; w is rounded per output column."""
        return self.round(x) @ self.round(w.t()).t()

    def linear(self, x, w, b=None):
        """x @ w.T (+ b), w [out, in] as nn.Linear stores it."""
        y = self.round(x) @ self.round(w).t()
        return y if b is None else y + b.float()


@contextlib.contextmanager
def exact_float32():
    """TF32 off for the matrix products and convolutions inside."""
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def positions_of(mask: torch.Tensor) -> torch.Tensor:
    """0 at each row's first real token, counting real tokens."""
    return (torch.cumsum(mask.long(), dim=-1) - 1).clamp(min=0)


def causal_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """[B, 1, T, T] additive bias: a query sees real keys at or before
    it."""
    T = key_mask.shape[-1]
    causal = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                   device=key_mask.device))
    ok = causal[None] & (key_mask[:, None, :] > 0)
    return torch.where(ok, 0.0, NEG)[:, None]


def layer_norm(x, w, b, eps):
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w.float() + b.float()


def gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def rotary(x: torch.Tensor, positions: torch.Tensor, rot: int,
           theta: float = 10000.0) -> torch.Tensor:
    """GPT-J's rotary embedding: pairs (2i, 2i + 1) of the first ``rot``
    dimensions rotated by position / theta^(2i / rot). x [B, T, H, hd]."""
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, device=x.device,
                                       dtype=torch.float64) / rot)
    ang = positions[..., None].double() * inv  # [B, T, rot / 2]
    cos = torch.cos(ang).float()[:, :, None, :]
    sin = torch.sin(ang).float()[:, :, None, :]
    even, odd = x[..., 0:rot:2], x[..., 1:rot:2]
    out = torch.stack([even * cos - odd * sin, odd * cos + even * sin],
                      dim=-1).reshape(*x.shape[:-1], rot)
    return torch.cat([out, x[..., rot:]], dim=-1)


def attend(q, k, v, bias, prec: Precision):
    """Softmax attention, q k v [B, T, H, hd], bias [B, 1, T, T]."""
    hd = q.shape[-1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, T, hd]
    s = prec.round(qh) @ prec.round(kh).transpose(-1, -2)
    p = torch.softmax(s / math.sqrt(hd) + bias, dim=-1)
    o = prec.round(p) @ prec.round(vh.transpose(-1, -2)).transpose(-1, -2)
    return o.transpose(1, 2)


def trunk(get, cfg: Dict, tokens: torch.Tensor, mask: torch.Tensor,
          prec: Precision, layers=None, h: Optional[torch.Tensor] = None,
          positions: Optional[torch.Tensor] = None,
          key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The architecture's blocks ``layers`` (default all) over tokens
    [B, T] (float32 hidden out, before the final norm). ``h``: start from
    this hidden instead of the embeddings. ``positions`` default to the
    mask's real token count, ``key_mask`` to ``mask``; each block gets
    the key mask as its row mask too."""
    model = harness.arch(cfg)
    if positions is None:
        positions = positions_of(mask)
    keys = mask if key_mask is None else key_mask
    bias = causal_bias(keys)
    if h is None:
        h = model.embed(get, cfg, tokens, positions)
    for i in (range(cfg["n_layer"]) if layers is None else layers):
        h = model.block(get, cfg, i, h, bias, positions, prec, keys)
    return h


def head(p: Dict[str, torch.Tensor], x: torch.Tensor,
         prec: Precision) -> torch.Tensor:
    """The MLP head d -> 2d -> out (ReLU), weights [in, out]."""
    y = torch.relu(prec.mm(x, p["w1"]) + p["b1"].float())
    return prec.mm(y, p["w2"]) + p["b2"].float()


def init_head(rng, d_in: int, d_out: int, device) -> Dict[str, torch.Tensor]:
    """A fresh head drawn as the port's trainers draw theirs from a numpy
    generator: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) matrices [in, out] (the
    first, then the second), zero biases; float32."""
    import numpy as np

    hidden = 2 * d_in
    lim1 = 1.0 / np.sqrt(np.float32(d_in))
    lim2 = 1.0 / np.sqrt(np.float32(hidden))
    w1 = rng.uniform(-lim1, lim1, (d_in, hidden)).astype(np.float32)
    w2 = rng.uniform(-lim2, lim2, (hidden, d_out)).astype(np.float32)
    return {"w1": torch.from_numpy(w1).to(device),
            "b1": torch.zeros(hidden, device=device),
            "w2": torch.from_numpy(w2).to(device),
            "b2": torch.zeros(d_out, device=device)}
