"""RL loss math (port of trlx_tpu.ops.losses: the PPO half): masked
means, whitening, logprob gathering, GAE, the clipped PPO losses and the
KL-penalty rewards. Every function takes an optional response mask; with
none they reduce to the unmasked math.
"""

from typing import Callable, Dict, Optional, Tuple

import torch


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                dim=None) -> torch.Tensor:
    if mask is None:
        return x.mean() if dim is None else x.mean(dim=dim)
    mask = mask.to(x.dtype)
    if dim is None:
        return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return (x * mask).sum(dim=dim) / torch.clamp(mask.sum(dim=dim), min=1.0)


def whiten(x: torch.Tensor, shift_mean: bool = True,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero mean / unit variance with the unbiased (n - 1) variance, over
    the real elements when masked."""
    mean = masked_mean(x, mask)
    if mask is None:
        n = torch.tensor(float(x.numel()), dtype=x.dtype, device=x.device)
        sq = ((x - mean) ** 2).sum()
    else:
        m = mask.to(x.dtype)
        n = m.sum()
        sq = (((x - mean) ** 2) * m).sum()
    var = sq / torch.clamp(n - 1.0, min=1.0)
    out = (x - mean) * torch.rsqrt(var + 1e-8)
    if not shift_mean:
        out = out + mean
    return out


def clip_by_value(x: torch.Tensor, low, high) -> torch.Tensor:
    """min(max(x, low), high), as ``jnp.clip``."""
    return torch.clamp(x, low, high)


def logprobs_from_logits(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Per-token logprobs of ``labels`` under ``logits`` [..., T, V];
    labels are clamped into the vocabulary (JAX's ``mode="clip"``), so an
    out-of-vocab pad id on a masked position cannot poison a sum."""
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels.long().clamp(0, logits.shape[-1] - 1)
    return torch.gather(logp, -1, idx[..., None])[..., 0]


def chunked_label_logprobs(head_fn: Callable[[torch.Tensor], torch.Tensor],
                           h: torch.Tensor, labels: torch.Tensor,
                           chunk: int = 16) -> torch.Tensor:
    """Per-position logprobs of ``labels`` [B, T] from layernormed hidden
    states ``h`` [B, T, D] without materializing the [B, T, V] logits:
    ``head_fn`` (h chunk -> float32 logits) runs on ``chunk`` positions
    at a time."""
    out = [logprobs_from_logits(head_fn(h[:, s:s + chunk]),
                                labels[:, s:s + chunk])
           for s in range(0, h.shape[1], chunk)]
    return torch.cat(out, dim=1)


#: the [T, T] GAE weight matrix costs T^2 memory; beyond this the
#: reverse loop runs instead
_GAE_MATMUL_MAX_T = 2048


def gae_advantages(values: torch.Tensor, rewards: torch.Tensor,
                   gamma: float, lam: float,
                   mask: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over the response window [B, T]:
    (advantages, returns = advantages + values), V beyond the last token
    0. With ``mask`` the episode ends at the last real token (bootstrap
    values of pads zeroed, pad deltas zeroed). Up to
    ``_GAE_MATMUL_MAX_T`` the constant-coefficient recurrence is one
    float32 [B, T] x [T, T] product with weights (gamma * lam)^(k - t);
    beyond it a reverse loop."""
    B, T = values.shape
    zeros = torch.zeros((B, 1), dtype=values.dtype, device=values.device)
    v_next = torch.cat([values[:, 1:], zeros], dim=1)
    if mask is not None:
        m = mask.to(values.dtype)
        m_next = torch.cat([m[:, 1:], zeros], dim=1)
        v_next = v_next * m_next
        deltas = (rewards + gamma * v_next - values) * m
    else:
        deltas = rewards + gamma * v_next - values
    if T <= _GAE_MATMUL_MAX_T:
        idx = torch.arange(T, device=values.device)
        exponent = idx[:, None] - idx[None, :]  # k - t
        base = torch.tensor(gamma * lam, dtype=torch.float32,
                            device=values.device)
        weights = torch.where(
            exponent >= 0,
            torch.pow(base, exponent.clamp(min=0).float()),
            torch.zeros((), dtype=torch.float32, device=values.device),
        ).to(values.dtype)
        advantages = deltas @ weights
    else:
        adv = torch.zeros((B,), dtype=values.dtype, device=values.device)
        cols = []
        for t in range(T - 1, -1, -1):
            adv = deltas[:, t] + gamma * lam * adv
            cols.append(adv)
        advantages = torch.stack(cols[::-1], dim=1)
    return advantages, advantages + values


def ppo_losses(logprobs, values, old_logprobs, old_values, advantages,
               returns, cliprange: float, cliprange_value: float,
               vf_coef: float, mask: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped-ratio policy loss + clipped value loss over [B, T]
    response-window tensors: (total loss, stats)."""
    vpred_clipped = clip_by_value(values, old_values - cliprange_value,
                                  old_values + cliprange_value)
    vf_unclipped = (values - returns) ** 2
    vf_clipped = (vpred_clipped - returns) ** 2
    vf_loss = 0.5 * masked_mean(torch.maximum(vf_unclipped, vf_clipped),
                                mask)
    vf_clipfrac = masked_mean((vf_clipped > vf_unclipped).float(), mask)

    log_ratio = logprobs - old_logprobs
    ratio = torch.exp(log_ratio)
    pg_unclipped = -advantages * ratio
    pg_clipped = -advantages * torch.clamp(ratio, 1.0 - cliprange,
                                           1.0 + cliprange)
    pg_loss = masked_mean(torch.maximum(pg_unclipped, pg_clipped), mask)
    pg_clipfrac = masked_mean((pg_clipped > pg_unclipped).float(), mask)

    mean_kl = masked_mean(-log_ratio, mask)
    loss = pg_loss + vf_coef * vf_loss
    stats = {
        "loss": loss,
        "pg_loss": pg_loss,
        "vf_loss": vf_loss,
        "pg_clipfrac": pg_clipfrac,
        "vf_clipfrac": vf_clipfrac,
        "approx_kl": mean_kl,
        "ratio_mean": masked_mean(ratio, mask),
    }
    return loss, stats


def kl_penalty_rewards(logprobs, ref_logprobs, scores, kl_coef,
                       mask: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token rewards -kl_coef * (logprobs - ref_logprobs) with the
    task score added on the last (real) response token, and the
    per-sequence summed KL [B] the adaptive controller reads."""
    kls = logprobs - ref_logprobs
    if mask is not None:
        kls = kls * mask.to(kls.dtype)
    rewards = -kl_coef * kls
    rows = torch.arange(rewards.shape[0], device=rewards.device)
    if mask is None:
        last = torch.full_like(rows, rewards.shape[1] - 1)
    else:
        last = (mask.sum(dim=-1).long() - 1).clamp(min=0)
    rewards = rewards.index_put((rows, last), scores.to(rewards.dtype),
                                accumulate=True)
    return rewards, kls.sum(dim=-1)
