"""Auxiliary heads on the trunk (port of trlx_tpu.models.heads): the
value head is Linear(d, 2d) -> ReLU -> Linear(2d, out)."""

from typing import Any, Dict

import numpy as np
import torch

Params = Dict[str, Any]


def init_head_params(rng: np.random.Generator, d_in: int, d_out: int,
                     dtype=np.float32) -> Params:
    """numpy head weights: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) matrices
    and zero biases, as trlx_tpu's init draws them (from a numpy
    generator here)."""
    hidden = 2 * d_in
    lim1 = 1.0 / np.sqrt(np.float32(d_in))
    lim2 = 1.0 / np.sqrt(np.float32(hidden))
    return {
        "w1": rng.uniform(-lim1, lim1, (d_in, hidden)).astype(dtype),
        "b1": np.zeros((hidden,), dtype),
        "w2": rng.uniform(-lim2, lim2, (hidden, d_out)).astype(dtype),
        "b2": np.zeros((d_out,), dtype),
    }


def head_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """MLP head in x's dtype; returns float32."""
    h = torch.relu(x @ p["w1"].to(x.dtype) + p["b1"].to(x.dtype))
    out = h @ p["w2"].to(x.dtype) + p["b2"].to(x.dtype)
    return out.float()
