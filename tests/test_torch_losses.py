"""The port's PPO loss math (trlx_tpu_torch.ops.losses) against
trlx_tpu.ops.losses on the same numpy inputs, float32, atol 1e-6: masked
means, whitening, clipping, logprob gathering (plain and chunked), both
GAE paths with and without a mask, the clipped PPO losses and the
KL-penalty rewards."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops import losses as jl
from trlx_tpu_torch.ops import losses as tl

ATOL = 1e-6


def _data(seed=0, B=3, T=7):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mask = np.ones((B, T), np.int32)
    mask[1, 4:] = 0
    mask[2, 1:] = 0
    return rng, f, mask


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_mean_whiten_clip_match_jax(masked):
    _, f, mask = _data()
    x = f(3, 7)
    m = mask if masked else None
    tm = torch.from_numpy(mask) if masked else None
    jm = jnp.asarray(mask) if masked else None
    _close(tl.masked_mean(torch.from_numpy(x), tm),
           jl.masked_mean(jnp.asarray(x), jm))
    _close(tl.masked_mean(torch.from_numpy(x), tm, dim=1),
           jl.masked_mean(jnp.asarray(x), jm, axis=1))
    for shift in (True, False):
        _close(tl.whiten(torch.from_numpy(x), shift, tm),
               jl.whiten(jnp.asarray(x), shift, jm), atol=2e-6)
    low, high = f(3, 7), f(3, 7) + 1.0
    _close(tl.clip_by_value(torch.from_numpy(x), torch.from_numpy(low),
                            torch.from_numpy(high)),
           jl.clip_by_value(jnp.asarray(x), jnp.asarray(low),
                            jnp.asarray(high)))
    assert m is None or m.shape == x.shape


def test_logprobs_plain_and_chunked_match_jax():
    rng, f, _ = _data(1)
    B, T, D, V = 2, 37, 8, 11
    logits = f(B, T, V) * 3
    labels = rng.integers(0, V + 3, (B, T)).astype(np.int32)  # some OOV
    _close(tl.logprobs_from_logits(torch.from_numpy(logits),
                                   torch.from_numpy(labels)),
           jl.logprobs_from_logits(jnp.asarray(logits), jnp.asarray(labels)),
           atol=2e-6)
    h, w = f(B, T, D), f(D, V)
    out_t = tl.chunked_label_logprobs(
        lambda x: x @ torch.from_numpy(w), torch.from_numpy(h),
        torch.from_numpy(labels), chunk=16)
    out_j = jl.chunked_label_logprobs(
        lambda x: x @ jnp.asarray(w), jnp.asarray(h), jnp.asarray(labels),
        chunk=16)
    _close(out_t, out_j, atol=5e-6)


@pytest.mark.parametrize("long_t", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_gae_both_paths_match_jax(masked, long_t, monkeypatch):
    """The float32 matmul path and (with the threshold lowered on both
    sides) the reverse-loop path."""
    if long_t:
        monkeypatch.setattr(jl, "_GAE_MATMUL_MAX_T", 4)
        monkeypatch.setattr(tl, "_GAE_MATMUL_MAX_T", 4)
    _, f, mask = _data(2)
    values, rewards = f(3, 7), f(3, 7)
    tm = torch.from_numpy(mask) if masked else None
    jm = jnp.asarray(mask) if masked else None
    at, rt = tl.gae_advantages(torch.from_numpy(values),
                               torch.from_numpy(rewards), 1.0, 0.95, tm)
    aj, rj = jl.gae_advantages(jnp.asarray(values), jnp.asarray(rewards),
                               1.0, 0.95, jm)
    _close(at, aj, atol=2e-6)
    _close(rt, rj, atol=2e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_ppo_losses_and_kl_rewards_match_jax(masked):
    _, f, mask = _data(3)
    args = [f(3, 7) * 0.1 for _ in range(6)]
    tm = torch.from_numpy(mask) if masked else None
    jm = jnp.asarray(mask) if masked else None
    lt, st = tl.ppo_losses(*map(torch.from_numpy, args), 0.2, 0.2, 2.3,
                           mask=tm)
    lj, sj = jl.ppo_losses(*map(jnp.asarray, args), 0.2, 0.2, 2.3, mask=jm)
    _close(lt, lj)
    assert sorted(st) == sorted(sj)
    for k in st:
        _close(st[k], sj[k])
    scores = f(3)
    rt, kt = tl.kl_penalty_rewards(torch.from_numpy(args[0]),
                                   torch.from_numpy(args[1]),
                                   torch.from_numpy(scores), 0.2, mask=tm)
    rj, kj = jl.kl_penalty_rewards(jnp.asarray(args[0]), jnp.asarray(args[1]),
                                   jnp.asarray(scores), 0.2, mask=jm)
    _close(rt, rj)
    _close(kt, kj)
