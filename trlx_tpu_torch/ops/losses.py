"""RL loss math (port of trlx_tpu.ops.losses): masked means, whitening,
logprob gathering, GAE, the clipped PPO losses, the KL-penalty rewards
and the ILQL composite loss (whole and T-chunked). The PPO functions
take an optional response mask; with none they reduce to the unmasked
math.
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
        n = torch.full((), float(x.numel()), dtype=x.dtype, device=x.device)
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


def _gather(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """x [..., T, V] at ``labels`` [..., T] clamped into the vocabulary
    (JAX's ``mode="clip"``)."""
    idx = labels.long().clamp(0, x.shape[-1] - 1)
    return torch.gather(x, -1, idx[..., None])[..., 0]


def logprobs_from_logits(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Per-token logprobs of ``labels`` under ``logits`` [..., T, V];
    labels are clamped into the vocabulary (JAX's ``mode="clip"``), so an
    out-of-vocab pad id on a masked position cannot poison a sum."""
    return _gather(torch.log_softmax(logits, dim=-1), labels)


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
        base = torch.full((), gamma * lam, dtype=torch.float32,
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


def _ilql_terms(q_g, q_lse, tq_g, lm_g, lm_lse, vs, attention_mask, rewards,
                gamma, tau, cql_scale, awac_scale):
    """The ILQL loss from per-position statistics, each [B, T]: the
    Q heads' gathered action values ``q_g`` and logsumexps ``q_lse``,
    the target heads' gathered values ``tq_g``, the LM head's ``lm_g`` /
    ``lm_lse`` and the value head ``vs``. The last position of each is a
    dummy (sliced off). The non-terminal mask is ``attention_mask[:, :-1]``
    (the terminal token's slot is zeroed upstream); sums are normalised
    by its count. ``targetQ`` and the bootstrap target are detached."""
    nonterminal = attention_mask[:, :-1].float()
    n_nonterminal = torch.clamp(nonterminal.sum(), min=1.0)

    Qs = [g[:, :-1] for g in q_g]
    targetQ = tq_g[0][:, :-1]
    if len(tq_g) > 1:
        targetQ = torch.minimum(targetQ, tq_g[1][:, :-1])
    targetQ = targetQ.detach()

    V_next = vs[:, 1:] * nonterminal
    Q_ = (rewards + gamma * V_next).detach()
    loss_q = sum((((Q - Q_) * nonterminal) ** 2).sum() / n_nonterminal
                 for Q in Qs)

    V = vs[:, 1:] * nonterminal
    diff = targetQ - V
    weight = torch.where(targetQ >= V, tau, 1.0 - tau)
    loss_v = (weight * diff ** 2 * nonterminal).sum() / n_nonterminal

    def masked_ce(g, lse):
        return (-((g - lse)[:, :-1]) * nonterminal).sum() / n_nonterminal

    loss_cql = sum(masked_ce(g, lse) for g, lse in zip(q_g, q_lse))
    loss_awac = masked_ce(lm_g, lm_lse)

    loss = loss_q + loss_v + cql_scale * loss_cql + awac_scale * loss_awac
    stats = {
        "loss": loss,
        "loss_q": loss_q,
        "loss_v": loss_v,
        "loss_cql": loss_cql,
        "loss_awac": loss_awac,
    }
    return loss, stats


def _gather_lse(x: torch.Tensor, labels: torch.Tensor):
    """(:func:`_gather`, logsumexp over V), each [..., T]."""
    return _gather(x, labels), torch.logsumexp(x, dim=-1)


def _action_labels(tokens: torch.Tensor) -> torch.Tensor:
    """labels[t] = the action taken at t (tokens[t + 1]); the last
    position holds a dummy 0."""
    return torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                     dim=1)


def ilql_losses(logits, qs, target_qs, vs, tokens, attention_mask, rewards,
                gamma: float, tau: float, cql_scale: float,
                awac_scale: float) -> Tuple[torch.Tensor, Dict]:
    """The ILQL composite loss — Q TD loss + expectile V loss + CQL
    cross-entropy + AWAC LM cross-entropy — from whole head outputs:
    logits / qs / target_qs [B, T, V], vs [B, T], tokens and
    attention_mask [B, T], rewards [B, T - 1]. Actions are clamped into
    the vocabulary (a pad id past it sits on masked positions)."""
    labels = _action_labels(tokens)
    lm_g, lm_lse = _gather_lse(logits, labels)
    q_stats = [_gather_lse(q, labels) for q in qs]
    tq_g = [_gather(q, labels) for q in target_qs]
    return _ilql_terms([g for g, _ in q_stats], [lse for _, lse in q_stats],
                       tq_g, lm_g, lm_lse, vs, attention_mask, rewards,
                       gamma, tau, cql_scale, awac_scale)


def ilql_losses_chunked(lm_head_fn, q_head_fns, tq_head_fns, vs, h_normed,
                        tokens, attention_mask, rewards, gamma: float,
                        tau: float, cql_scale: float, awac_scale: float,
                        chunk: int = 16, gather_rows: Optional[Callable] = None,
                        seq=None) -> Tuple[torch.Tensor, Dict]:
    """:func:`ilql_losses` without ever holding the [B, T, V] head
    outputs: each ``chunk`` positions of ``h_normed`` [B, T, D] go
    through the heads (callables [B, c, D] -> float32 [B, c, V]) and
    reduce at once to the gathered action value and the logsumexp. The
    trainable heads' chunks run under ``torch.utils.checkpoint``, so the
    backward recomputes each chunk's projections instead of storing
    them; the target heads (no gradient) run outside it. Same math and
    stats as :func:`ilql_losses`.

    ``gather_rows`` (trlx_tpu_torch.parallel.sharding ``gather_rows`` on
    a mesh): the inputs are this process's rows, and every per-position
    statistic, the mask and the rewards go through it to the whole batch
    before the losses, which are then the whole batch's.

    ``seq`` (trlx_tpu_torch.ops.ring_attention ``SequenceSplit``, sp >
    1): ``h_normed`` and ``vs`` are this process's chunk of positions
    while ``tokens``, the mask and the rewards are whole; the chunk's
    statistics and V are gathered over sp first."""
    from torch.utils.checkpoint import checkpoint

    labels = _action_labels(tokens)
    if seq is not None:
        labels = seq.chunk(labels)
    fns = (lm_head_fn,) + tuple(q_head_fns)

    def trainable_stats(h_c, lab_c):
        return tuple(x for f in fns for x in _gather_lse(f(h_c), lab_c))

    cols, tq_cols = [], []
    for s in range(0, h_normed.shape[1], chunk):
        h_c, lab_c = h_normed[:, s:s + chunk], labels[:, s:s + chunk]
        if torch.is_grad_enabled():
            cols.append(checkpoint(trainable_stats, h_c, lab_c,
                                   use_reentrant=False))
        else:
            cols.append(trainable_stats(h_c, lab_c))
        with torch.no_grad():
            tq_cols.append([_gather(f(h_c), lab_c)
                            for f in tq_head_fns])
    out = [torch.cat(c, dim=1) for c in zip(*cols)]
    tq_g = [torch.cat(c, dim=1) for c in zip(*tq_cols)]
    if seq is not None:
        out, tq_g = [seq.gather(x) for x in out], [seq.gather(x)
                                                   for x in tq_g]
        vs = seq.gather(vs)
    if gather_rows is not None:
        out, tq_g = [gather_rows(x) for x in out], [gather_rows(x)
                                                   for x in tq_g]
        vs, attention_mask, rewards = (gather_rows(x) for x in
                                       (vs, attention_mask, rewards))
    lm_g, lm_lse = out[0], out[1]
    return _ilql_terms(out[2::2], out[3::2], tq_g, lm_g, lm_lse, vs,
                       attention_mask, rewards, gamma, tau, cql_scale,
                       awac_scale)
