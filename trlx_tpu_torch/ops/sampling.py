"""Logit warpers and token sampling for the decode loop (port of
trlx_tpu.ops.sampling).

The warpers reproduce trlx_tpu's arithmetic (temperature -> top-k ->
top-p, masked entries at the finite ``NEG_INF``). Draws come from a
``torch.Generator`` — one per sampling stream — and cannot agree token
for token with JAX's threefry/rbg streams: sampled decode is held to
equal WARPED logits, greedy decode to identical tokens.
"""

from typing import NamedTuple, Optional

import torch

NEG_INF = -1e9


class SamplingParams(NamedTuple):
    """Static sampling configuration. `top_p_cap` bounds the candidate set
    top-p considers (0 = exact full-vocab sort)."""

    temperature: float = 1.0
    top_k: int = 0  # 0 disables
    top_p: float = 1.0  # 1.0 disables
    do_sample: bool = True
    top_p_cap: int = 1024


def _neg_inf_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, NEG_INF)


def warp_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits / max(temperature, 1e-6)


def warp_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit (k clamped to V)."""
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _neg_inf_like(logits), logits)


def warp_top_p(logits: torch.Tensor, top_p: float, cap: int = 0) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose cumulative
    probability reaches `top_p` (always keeps the top-1 token). With
    ``0 < cap < V`` only the top-`cap` logits are candidates."""
    V = logits.shape[-1]
    if cap and cap < V:
        vals, idx = torch.topk(logits, cap, dim=-1)  # descending
        logz = torch.logsumexp(logits, dim=-1, keepdim=True)
        probs = torch.exp(vals - logz)
        cum_before = torch.cumsum(probs, dim=-1) - probs
        keep_sorted = cum_before < top_p
        keep_sorted[..., 0] = True
        keep = torch.zeros_like(logits, dtype=torch.bool)
        keep.scatter_(-1, idx, keep_sorted)
        return torch.where(keep, logits, _neg_inf_like(logits))
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1, descending=True,
                                           stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    drop_sorted = cum_before >= top_p
    drop_sorted[..., 0] = False
    drop = torch.zeros_like(drop_sorted)
    drop.scatter_(-1, sorted_idx, drop_sorted)
    return torch.where(drop, _neg_inf_like(logits), logits)


def warp_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Apply temperature -> top-k -> top-p, matching HF's warper order."""
    if params.temperature != 1.0:
        logits = warp_temperature(logits, params.temperature)
    if params.top_k and params.top_k > 0:
        logits = warp_top_k(logits, params.top_k)
    if params.top_p < 1.0:
        logits = warp_top_p(logits, params.top_p, cap=params.top_p_cap)
    return logits


def sample_token(generator: Optional[torch.Generator], logits: torch.Tensor,
                 params: SamplingParams, rows=None) -> torch.Tensor:
    """Draw next tokens [B] (int64) from warped logits [B, V], or the
    argmax under greedy decode — which skips the warpers entirely (every
    warper keeps the top-1 token, so the argmax cannot change).

    The draw is the exponential race ``argmax(probs / E)``, ``E ~ Exp(1)``
    from ``generator``: what ``torch.multinomial`` computes for one
    sample, token for token, without its input check, which reads a
    value back to the host and so cannot run inside a CUDA graph.

    ``rows`` = (start, total): ``logits`` are rows [start, start + B) of
    a ``total``-row batch sharded over processes. The draw is then made
    for the whole batch and this process keeps its rows, so every
    process's generator advances alike and each row draws what it would
    in one process (processes holding the same rows, a tp group, draw
    the same tokens)."""
    if not params.do_sample:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(warp_logits(logits, params), dim=-1)
    if rows is None:
        race = torch.empty_like(probs).exponential_(generator=generator)
    else:
        start, total = rows
        race = torch.empty((total,) + probs.shape[1:], dtype=probs.dtype,
                           device=probs.device).exponential_(
            generator=generator)[start:start + probs.shape[0]]
    return torch.argmax(probs / race, dim=-1)
