"""The port's logit warpers and token sampling (trlx_tpu_torch.ops.sampling)
against trlx_tpu's, from the same numpy logits: warped logits equal at
1e-6 for every warper setting the serving path takes (temperature,
top-k, top-p capped and exact, and their chain), greedy decode is the
argmax with the warpers skipped, and a sampled draw lands only in the
warped support and repeats under the same ``torch.Generator`` seed.
The two RNGs cannot agree token for token, so draws are not compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.sampling import SamplingParams as JaxSampling
from trlx_tpu.ops.sampling import warp_logits as jax_warp_logits
from trlx_tpu_torch.ops.sampling import (
    NEG_INF,
    SamplingParams,
    sample_token,
    warp_logits,
)

PARAMS = {
    "temperature": dict(temperature=0.7),
    "top_k": dict(top_k=5),
    "top_p_capped": dict(top_p=0.8, top_p_cap=16),
    "top_p_exact": dict(top_p=0.8, top_p_cap=0),
    "chain": dict(temperature=1.3, top_k=40, top_p=0.9, top_p_cap=32),
}


def _logits(seed=0, B=4, V=257):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, V)) * 3).astype(np.float32)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_warped_logits_match_jax(name):
    logits = _logits()
    ref = jax_warp_logits(jnp.asarray(logits), JaxSampling(**PARAMS[name]))
    out = warp_logits(torch.from_numpy(logits), SamplingParams(**PARAMS[name]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    kept = out > NEG_INF / 2
    assert kept.any(-1).all()  # the top-1 token always survives


def test_greedy_is_argmax_and_sampled_draws_stay_in_support():
    logits = torch.from_numpy(_logits(seed=1))
    greedy = sample_token(None, logits, SamplingParams(do_sample=False,
                                                       top_k=3))
    assert torch.equal(greedy, logits.argmax(-1))
    params = SamplingParams(top_k=5, top_p=0.9)
    support = warp_logits(logits, params) > NEG_INF / 2
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        draws.append(torch.stack([sample_token(gen, logits, params)
                                  for _ in range(50)]))
    assert torch.equal(draws[0], draws[1])  # same seed, same stream
    rows = torch.arange(logits.shape[0])
    assert all(support[rows, d].all() for d in draws[0])


def test_exponential_race_draws_what_multinomial_draws():
    """The sampler's draw, ``argmax(probs / E)`` with ``E ~ Exp(1)``, is
    ``torch.multinomial``'s one-sample computation: the same tokens from
    the same generator state, and the generator ends in the same state."""
    logits = torch.from_numpy(_logits(seed=2))
    params = SamplingParams(temperature=0.8, top_k=7)
    probs = torch.softmax(warp_logits(logits, params), dim=-1)
    ours, theirs = torch.Generator().manual_seed(3), \
        torch.Generator().manual_seed(3)
    for _ in range(20):
        mine = sample_token(ours, logits, params)
        ref = torch.multinomial(probs, 1, generator=theirs)[:, 0]
        assert torch.equal(mine, ref)
    assert torch.equal(ours.get_state(), theirs.get_state())
