"""The port's HydraPolicy (training half) against trlx_tpu's, from the same
param tree carried across (jax init -> numpy -> torch): ``forward``
(logits, reference logits, values) and ``forward_hidden``, with dense
attention and with the flash seam (JAX in interpret mode, the port's
plain kernel versions; ``_MIN_FUSED_T`` set to 0 on both sides), for
gpt2 and a GQA llama spec, left-padded prompts, real rows only, atol
2e-4 at float32. Also the gradient path: only the trainable branch gets
gradients, the reference branch and trunk record none."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelSpec as JaxSpec
from trlx_tpu.models.policy import HydraPolicy as JaxPolicy
from trlx_tpu.ops import pallas_attention as jpa
from trlx_tpu_torch.data.configs import ModelSpec
from trlx_tpu_torch.models.params import hydra_to_numpy, hydra_to_torch
from trlx_tpu_torch.models.policy import HydraPolicy
from trlx_tpu_torch.ops import flash_attention as tfa

ATOL = 2e-4
SPECS = {
    "gpt2": dict(arch="gpt2", vocab_size=97, n_layer=3, n_head=4,
                 d_model=64, n_positions=64),
    "llama_gqa": dict(arch="llama", vocab_size=97, n_layer=3, n_head=4,
                      n_kv_heads=2, d_model=64, n_positions=64,
                      tie_lm_head=False),
}


def _setup(name, flash, monkeypatch, k=2):
    jspec, spec = JaxSpec(**SPECS[name]), ModelSpec(**SPECS[name])
    jattn = tattn = None
    if flash:
        monkeypatch.setattr(jpa, "_MIN_FUSED_T", 0)
        monkeypatch.setattr(tfa, "_MIN_FUSED_T", 0)
        jattn = jpa.make_pallas_attention_fn(block=16)
        tattn = tfa.make_flash_attention_fn()
    jpol = JaxPolicy(spec=jspec, num_layers_unfrozen=k,
                     compute_dtype=jnp.float32, attention_fn=jattn)
    tpol = HydraPolicy(spec=spec, num_layers_unfrozen=k,
                       compute_dtype=torch.float32, attention_fn=tattn)
    params = jax.device_get(jpol.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    # perturb the trainable branch so policy and reference differ
    params["trainable"] = jax.tree_util.tree_map(
        lambda x: (x + 0.02 * rng.standard_normal(x.shape)).astype(x.dtype),
        params["trainable"])
    B, T = 3, 21
    tokens = rng.integers(0, 97, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, :5] = 0
    mask[2, :11] = 0
    return jpol, tpol, params, tokens, mask


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_forward_and_hidden_match_jax(name, flash, monkeypatch):
    jpol, tpol, params, tokens, mask = _setup(name, flash, monkeypatch)
    real = mask.astype(bool)
    tparams = hydra_to_torch(params)
    tt, tm = torch.from_numpy(tokens), torch.from_numpy(mask)
    jl, jr, jv = jpol.forward(params, jnp.asarray(tokens), jnp.asarray(mask))
    tl, tr, tv = tpol.forward(tparams, tt, tm)
    for t, j in ((tl, jl), (tr, jr), (tv, jv)):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.detach().numpy()[real],
                                   np.asarray(j)[real], atol=ATOL, rtol=0)
    jh, jhr, _ = jpol.forward_hidden(params, jnp.asarray(tokens),
                                     jnp.asarray(mask))
    th, thr, _ = tpol.forward_hidden(tparams, tt, tm)
    np.testing.assert_allclose(th.detach().numpy()[real],
                               np.asarray(jh)[real], atol=ATOL, rtol=0)
    np.testing.assert_allclose(thr.numpy()[real], np.asarray(jhr)[real],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("flash", [False, True])
def test_gradients_reach_only_the_trainable_branch(flash, monkeypatch):
    _, tpol, params, tokens, mask = _setup("gpt2", flash, monkeypatch)
    tparams = hydra_to_torch(params)
    logits, ref_logits, values = tpol.forward(
        tparams, torch.from_numpy(tokens), torch.from_numpy(mask))
    assert ref_logits.grad_fn is None and not ref_logits.requires_grad
    (logits.logsumexp(-1).mean() + values.mean()).backward()
    for branch, want in (("trainable", True), ("frozen_base", False),
                         ("ref", False)):
        leaves = []
        jax.tree_util.tree_map(leaves.append, tparams[branch])
        assert all((x.grad is not None) == want for x in leaves), branch
    back = hydra_to_numpy(tparams["ref"])
    np.testing.assert_array_equal(back["ln_f"]["scale"],
                                  params["ref"]["ln_f"]["scale"])
