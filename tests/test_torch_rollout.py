"""The port's rollout decoder (trlx_tpu_torch.models.generation.generate)
against trlx_tpu's ``generate``, from the same weights and left-padded
prompts at float32: greedy decode gives identical tokens, sequences,
``gen_mask`` and ``attention_mask``, and logprobs at atol 2e-4 — with
fixed-length decode, with eos termination and ``min_new_tokens``, and
with the early exit on or off. Sampled decode cannot agree token for
token (Philox vs threefry); its warped logits are held equal in
tests/test_torch_sampling.py, and here a sampled run keeps the output
contract. ``GenerationConfig.from_gen_kwargs`` translates like JAX's.

The decode step's attention: a layer's dense cache viewed as pages with
the decoder's page table, through the paged-decode kernel's plain
version, equals ``attention_scores`` over the cache (hd 64 and 256,
pages of 16 and 64, MHA and GQA, left-padded rows); the page-size rule
takes the kernel path at the PPO TL;DR rollout's shape and keeps the
plain one where no page size divides the keys or the kernel has no
build for the head dim or dtypes; at shapes it routes, greedy decode
still equals trlx_tpu's, and a rollout chunk counts its steps by path.

The trainer's rollouts: with ``train.continuous_rollouts`` the next
epoch's experience is dispatched before the epoch's updates, and equals
what trlx_tpu's continuous loop produces from the same pre-update
parameters (greedy, float32: tokens identical, logprobs, values and KL
rewards at atol 1e-5); the orchestrator's double-buffered harvest fills
the store exactly as harvesting each chunk in turn does, with the
``reward_fn`` calls in chunk order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelSpec as JaxSpec
from trlx_tpu.models import generation as jg
from trlx_tpu_torch.data.configs import ModelSpec
from trlx_tpu_torch.models import generation as tg
from trlx_tpu_torch.models.params import init_hydra_numpy
from trlx_tpu_torch.models.transformer import NEG_INF, attention_scores
from trlx_tpu_torch.ops.paged_attention import (
    paged_decode_attention_reference,
)

# an untied head: with gpt2's tied head a random model's greedy decode
# just repeats each row's last prompt token
SPEC = dict(arch="gpt2", vocab_size=257, n_layer=3, n_head=4, d_model=32,
            n_positions=64, tie_lm_head=False)
P, G = 7, 12


def _inputs(seed=0, spec=SPEC, p=P):
    spec = ModelSpec(**spec)
    tree = init_hydra_numpy(spec, num_layers_unfrozen=1, seed=seed)
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, 256, (4, p)).astype(np.int32)
    mask = np.ones((4, p), np.int32)
    for i, pad in enumerate((0, 2, 5, 6)):
        mask[i, :pad] = 0
        tokens[i, :pad] = 256
    return tree, tokens, mask


def _views(tree, to):
    embed = dict(tree["frozen_base"]["embed"],
                 lm_head=tree["trainable"]["lm_head"])
    blocks = (tree["frozen_base"]["blocks"], tree["trainable"]["blocks"])
    conv = lambda t: jax.tree_util.tree_map(to, t)  # noqa: E731
    return conv(blocks), conv(embed), conv(tree["trainable"]["ln_f"])


def _run_both(gen_kwargs, eos, early_exit=True, monkeypatch=None,
              decoder=None, spec=SPEC, p=P, g=G):
    tree, tokens, mask = _inputs(spec=spec, p=p)
    jcfg = jg.GenerationConfig.from_gen_kwargs(g, gen_kwargs, eos, 256, p)
    tcfg = tg.GenerationConfig.from_gen_kwargs(g, gen_kwargs, eos, 256, p)
    assert tuple(tcfg.sampling) == tuple(jcfg.sampling)
    assert (tcfg.gen_size, tcfg.eos_token_id, tcfg.pad_token_id,
            tcfg.min_new_tokens) == (jcfg.gen_size, jcfg.eos_token_id,
                                     jcfg.pad_token_id, jcfg.min_new_tokens)
    if monkeypatch is not None:
        monkeypatch.setattr(tg, "_EOS_EARLY_EXIT", early_exit)
        monkeypatch.setattr(jg, "_EOS_EARLY_EXIT", early_exit)
    jout = jg.generate(JaxSpec(**spec), *_views(tree, jnp.asarray),
                       jnp.asarray(tokens), jnp.asarray(mask),
                       jax.random.PRNGKey(0), jcfg,
                       compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    tout = tg.generate(ModelSpec(**spec),
                       *_views(tree, lambda x: torch.from_numpy(x.copy())),
                       torch.from_numpy(tokens), torch.from_numpy(mask),
                       None, tcfg, compute_dtype=torch.float32,
                       cache_dtype=torch.float32, decoder=decoder)
    return jout, tout


def _assert_same(jout, tout):
    for name in ("sequences", "gen_tokens", "gen_mask", "attention_mask"):
        np.testing.assert_array_equal(
            getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
            err_msg=name)
    np.testing.assert_allclose(tout.gen_logprobs.numpy(),
                               np.asarray(jout.gen_logprobs), atol=2e-4,
                               rtol=0)


GREEDY = {"max_length": G, "min_length": G, "top_k": 0, "top_p": 1.0,
          "do_sample": False}


def test_greedy_fixed_length_matches_jax():
    jout, tout = _run_both(GREEDY, eos=256)
    _assert_same(jout, tout)
    assert int(tout.gen_mask.sum()) == 4 * G


@pytest.mark.parametrize("early_exit", [True, False])
def test_greedy_eos_and_min_new_tokens_match_jax(early_exit, monkeypatch):
    """eos = a token greedy decode emits once the suppression is over, so
    some rows end early; min_length P + 2 keeps eos suppressed for the
    first 2 steps."""
    kwargs = dict(GREEDY, min_length=P + 2)
    _, tfree = _run_both(GREEDY, eos=-1)
    for eos in sorted(set(tfree.gen_tokens.numpy().ravel().tolist())):
        jout, tout = _run_both(kwargs, eos, early_exit, monkeypatch)
        if not tout.gen_mask.numpy().all():
            break
    _assert_same(jout, tout)
    gm = tout.gen_mask.numpy()
    assert gm[:, :3].all() and not gm.all()  # eos ended some rows
    ended = tout.gen_tokens.numpy()[gm == 0]
    assert (ended == 256).all()  # pads after eos


@pytest.mark.parametrize("every", [1, 3])
@pytest.mark.parametrize("early_exit", [True, False])
def test_chunked_decode_matches_jax(early_exit, every, monkeypatch):
    """The decode loop checks for the all-finished exit once every
    ``every`` steps (K = 1 leaves where JAX's loop leaves, K = 3 runs up
    to 2 steps of pads past it): tokens, sequences, ``gen_mask`` and
    logprobs equal trlx_tpu's either way, with eos ending rows early and
    ``min_new_tokens`` holding it back for the first 2 steps."""
    monkeypatch.setattr(tg, "_EXIT_CHECK_EVERY", every)
    kwargs = dict(GREEDY, min_length=P + 2)
    _, tfree = _run_both(GREEDY, eos=-1)
    for eos in sorted(set(tfree.gen_tokens.numpy().ravel().tolist())):
        jout, tout = _run_both(kwargs, eos, early_exit, monkeypatch)
        if not tout.gen_mask.numpy().all():
            break
    _assert_same(jout, tout)
    gm = tout.gen_mask.numpy()
    assert gm[:, :3].all() and not gm.all()


def test_decoder_reuses_its_buffers_and_hands_out_copies():
    """One decoder across calls (what a trainer holds): each shape gets
    one set of buffers and one step signature; a later call does not
    change what an earlier call returned."""
    decoder = tg.RolloutDecoder()
    jout, first = _run_both(GREEDY, eos=256, decoder=decoder)
    kept = [t.clone() for t in first]
    _, second = _run_both(dict(GREEDY, min_length=0), eos=256,
                          decoder=decoder)
    for a, b in zip(first, kept):
        assert torch.equal(a, b)
    _assert_same(jout, first)
    assert len(decoder._buffers) == 1
    # the two configs are two plain-leaf values: two signatures
    assert decoder.step.signatures() == 2


def test_sampled_decode_keeps_the_output_contract():
    tree, tokens, mask = _inputs()
    cfg = tg.GenerationConfig.from_gen_kwargs(
        G, {"max_length": 64, "min_length": 0, "temperature": 0.7,
            "do_sample": True}, 256, 256, P)
    gen = torch.Generator().manual_seed(0)
    run = lambda g: tg.generate(  # noqa: E731
        ModelSpec(**SPEC), *_views(tree, lambda x: torch.from_numpy(x.copy())),
        torch.from_numpy(tokens), torch.from_numpy(mask), g, cfg,
        compute_dtype=torch.float32, cache_dtype=torch.float32)
    out = run(gen)
    again = run(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(out.gen_tokens.numpy(),
                                  again.gen_tokens.numpy())
    assert out.sequences.shape == (4, P + G)
    np.testing.assert_array_equal(out.sequences[:, :P].numpy(), tokens)
    lp = out.gen_logprobs.numpy()
    assert (lp <= 0).all() and np.isfinite(lp).all()
    assert (lp[out.gen_mask.numpy() == 0] == 0).all()


def test_from_gen_kwargs_matches_jax():
    for kwargs in ({"max_length": 48, "min_length": 48},
                   {"max_length": 64, "min_length": 48, "top_k": 0,
                    "top_p": 1.0, "do_sample": True, "temperature": 0.7},
                   {"max_new_tokens": 5, "top_k": 3}):
        j = jg.GenerationConfig.from_gen_kwargs(64, kwargs, 256, 256, 4)
        t = tg.GenerationConfig.from_gen_kwargs(64, kwargs, 256, 256, 4)
        assert (t.gen_size, tuple(t.sampling), t.min_new_tokens) == (
            j.gen_size, tuple(j.sampling), j.min_new_tokens)
    with pytest.raises(ValueError, match="exceeds"):
        tg.GenerationConfig.from_gen_kwargs(4, {"max_new_tokens": 5})


# --------------------------------------------------------------------- #
# the trainer's rollouts: continuous mode and the harvest
# --------------------------------------------------------------------- #


def _ppo_pair(tmp_path=None, **train):
    """A trlx_tpu PPO stack and the port's from the same parameters:
    greedy decode, 16 prompts a chunk, one chunk of experience each."""
    from tests.test_ppo_e2e import PROMPTS, make_config, reward_fn
    from trlx_tpu.utils import loading as jl
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils import loading as tl

    jcfg = make_config(total_steps=10**6, epochs=2, num_rollouts=16,
                       chunk_size=16, batch_size=8, ppo_epochs=1)
    jcfg.method.gen_kwargs = dict(jcfg.method.gen_kwargs, do_sample=False)
    for k, v in train.items():
        setattr(jcfg.train, k, v)
    tcfg = TRLConfig.from_dict(jcfg.to_nested_dict())
    stacks = []
    for cfg, lib, kw in ((jcfg, jl, {}), (tcfg, tl, {"device": "cpu"})):
        if stacks:
            kw["params"] = jax.device_get(stacks[0][0].params)
        trainer = lib.get_model(cfg.model.model_type)(cfg, **kw)
        pipeline = lib.get_pipeline(cfg.train.pipeline)(
            PROMPTS, trainer.tokenizer, cfg)
        orch = lib.get_orchestrator(cfg.train.orchestrator)(
            trainer, pipeline, reward_fn=reward_fn,
            chunk_size=cfg.method.chunk_size)
        stacks.append((trainer, orch))
    return stacks


def _assert_same_experience(ours, theirs):
    for name in ("query_tensors", "response_tensors", "response_masks",
                 "query_masks"):
        np.testing.assert_array_equal(
            getattr(ours, name).numpy(), np.asarray(getattr(theirs, name)),
            err_msg=name)
    for name in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(
            getattr(ours, name).numpy(), np.asarray(getattr(theirs, name)),
            atol=1e-5, rtol=0, err_msg=name)


def test_continuous_rollouts_match_jax():
    """Two epochs with ``continuous_rollouts``: epoch 1's experience is
    dispatched before epoch 0's updates (against the initial parameters)
    and harvested after them, in both packages; the port's equals
    trlx_tpu's. Had the port scored after the updates, its logprobs would
    carry the update (lr 3e-3), far past 1e-5."""
    from trlx_tpu_torch import telemetry

    (jtrainer, jorch), (ttrainer, torch_orch) = _ppo_pair(
        continuous_rollouts=True)
    jorch.make_experience(16)
    torch_orch.make_experience(16)
    _assert_same_experience(ttrainer.store._stacked(),
                            jtrainer.store._stacked())
    assert ttrainer._will_refresh(ttrainer.config.train,
                                  ttrainer.config.method)
    before = ttrainer.params["trainable"]["ln_f"]["scale"].detach().clone()
    jtrainer.learn(log_fn=lambda stats: None)
    ttrainer.learn(log_fn=lambda stats: None)
    assert ttrainer.epoch == jtrainer.epoch == 2
    assert not torch.equal(before,
                           ttrainer.params["trainable"]["ln_f"]["scale"])
    _assert_same_experience(ttrainer.store._stacked(),
                            jtrainer.store._stacked())
    hists = telemetry.current().registry.hists
    assert "time/rollout_dispatch_stale" in hists
    assert "time/rollout_harvest" in hists


def test_double_buffered_harvest_matches_chunk_by_chunk():
    """Four chunks through ``finish_experience``: the store holds what
    harvesting each chunk in turn gives (the host reward on its decoded
    sequences, added at each row's last real token), and the reward_fn
    saw the chunks in order. The harvest's two host slots serve chunks
    0, 1, 2, 3 in turn."""
    from tests.test_ppo_e2e import reward_fn
    from trlx_tpu_torch.orchestrator import ppo_orchestrator as po

    (_, _), (trainer, orch) = _ppo_pair()
    orch.chunk_size = 8
    calls = []

    def recording(texts):
        calls.append(list(texts))
        return reward_fn(texts)

    orch.reward_fn = recording
    handle = orch.start_experience(32)
    assert handle["n_chunks"] == 4 and handle["device_scores"] == []
    want = []
    for out, query, qmask, logprobs, values, kl_rewards, _ in \
            handle["pendings"]:
        texts = trainer.tokenizer.batch_decode(
            out.sequences.numpy(), skip_special_tokens=True)
        scores = np.asarray(reward_fn(texts), np.float32)
        want.append((texts, trainer.finalize_rewards(
            kl_rewards, out.gen_mask, scores), out.gen_tokens, logprobs,
            values))
    slots = []
    real = po.HostHarvest.start

    def start(self, i):
        real(self, i)
        slots.append(id(self.slots[i % 2][0]))

    po.HostHarvest.start = start
    try:
        info = orch.finish_experience(handle)
    finally:
        po.HostHarvest.start = real
    assert info["rollouts"] == 32
    assert calls == [w[0] for w in want]
    assert slots[0] == slots[2] and slots[1] == slots[3] \
        and slots[0] != slots[1]
    for got, (_, rewards, gen_tokens, logprobs, values) in zip(
            trainer.store.history, want):
        assert torch.equal(got.rewards, rewards)
        assert torch.equal(got.response_tensors, gen_tokens)
        assert torch.equal(got.logprobs, logprobs)
        assert torch.equal(got.values, values)


# --------------------------------------------------------------------- #
# the decode step's attention through the paged-decode kernel
# --------------------------------------------------------------------- #


def _step_bias(buffer_mask, offset):
    """The additive [B, 1, 1, S] bias a decode step at buffer position
    ``offset`` attends with: keys up to ``offset`` of each row's mask."""
    S = buffer_mask.shape[1]
    valid = (torch.arange(S)[None, :] <= offset) & (buffer_mask > 0)
    return torch.where(valid, 0.0, NEG_INF).float()[:, None, None, :]


def _decoder_buffers(B, S, H, Hkv, hd, dtype=torch.float32, G=64):
    spec = ModelSpec(arch="llama", vocab_size=8, n_layer=1, n_head=H,
                     n_kv_heads=Hkv, d_model=H * hd, n_positions=1024)
    return tg.RolloutDecoder().buffers(spec, [1], B, S - G, G, dtype, dtype,
                                       torch.device("cpu"))


@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("hd", [64, 256])
def test_dense_cache_as_pages_matches_attention_scores(hd, ps, H, Hkv,
                                                       monkeypatch):
    """A layer's dense cache [B, 576, Hkv, hd] viewed as pages of ``ps``
    with the decoder's page table, through the kernel's plain version,
    equals ``attention_scores`` over the dense cache with the decoder's
    bias: rows left-padded by 0, 37 and 200, keys past the step masked."""
    monkeypatch.setattr(tg, "ROLLOUT_PAGE_SIZE", ps)
    B, S = 3, 576
    buf = _decoder_buffers(B, S, H, Hkv, hd)
    n = S // ps
    assert buf.page_table.dtype == torch.int32
    assert torch.equal(buf.page_table,
                       torch.arange(B * n, dtype=torch.int32).view(B, n))
    gen = torch.Generator().manual_seed(hd + ps + H)
    k, v = (torch.randn(B, S, Hkv, hd, generator=gen) for _ in range(2))
    q = torch.randn(B, H, hd, generator=gen)
    mask = torch.ones(B, S, dtype=torch.int32)
    for b, pad in enumerate((0, 37, 200)):
        mask[b, :pad] = 0
    bias = _step_bias(mask, S - 64 + 5)
    want = attention_scores(q[:, None], k, v, bias)[:, 0]
    pages = (-1, ps, Hkv, hd)
    got = paged_decode_attention_reference(
        q, k.view(pages), v.view(pages), buf.page_table, bias.reshape(B, S))
    assert torch.equal(got, want)


#: the PPO TL;DR rollout at gpt-j width: B 32, 512 + 64 keys, 16 heads
#: of 256, bf16
CELL = dict(B=32, S=576, H=16, Hkv=16, hd=256, q_dtype=torch.bfloat16,
            cache_dtype=torch.bfloat16, device="cuda")


@pytest.mark.parametrize("change,takes", [
    ({}, True),
    ({"device": "cpu"}, True),
    ({"H": 16, "Hkv": 4, "hd": 64, "q_dtype": torch.float32,
      "cache_dtype": torch.float32}, True),
    ({"S": 19}, False),
    ({"S": 600}, False),
    ({"hd": 8}, False),
    ({"q_dtype": torch.bfloat16, "cache_dtype": torch.float32}, False),
    ({"q_dtype": torch.float16, "cache_dtype": torch.float16}, False),
    ({"device": "meta"}, False),
    ({"B": 1024, "S": 65536}, False),
], ids=["cell", "cell-cpu", "gqa-f32", "S19", "S600", "hd8", "bf16-f32",
        "f16", "meta", "smem"])
def test_rollout_page_size_picks_the_path(change, takes):
    """The kernel path for the cell's shape (on the card and on the CPU)
    and a GQA float32 one; the plain path where the page size does not
    divide the keys, the kernel has no build for the head dim or the
    dtype pair, the device is neither, or one partition's bias row
    (4096 pages in one) overflows a block's shared memory."""
    ps = tg.rollout_page_size(**dict(CELL, **change))
    assert ps == (tg.ROLLOUT_PAGE_SIZE if takes else None)


#: shapes the decode step routes through the kernel's plain version:
#: (spec, prompt length, tokens), one or two pages of 16 a row
ROUTED = {
    "gpt2-hd16": (dict(SPEC, d_model=64), 7, 9),
    "gptj-hd32": (dict(arch="gptj", vocab_size=257, n_layer=2, n_head=4,
                       d_model=128, rotary_dim=16, n_positions=64,
                       tie_lm_head=False), 20, 12),
    "llama-gqa": (dict(arch="llama", vocab_size=257, n_layer=2, n_head=4,
                       n_kv_heads=2, d_model=64, n_positions=64,
                       tie_lm_head=False), 9, 7),
}


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("shape", sorted(ROUTED))
def test_routed_decode_matches_jax(shape, early_exit, monkeypatch):
    """Where the step attends through the kernel's plain version (the
    dense cache viewed as pages), greedy decode equals trlx_tpu's:
    fixed-length, and with eos ending rows early behind 2 steps of
    ``min_new_tokens``."""
    spec, p, g = ROUTED[shape]
    greedy = dict(GREEDY, max_length=g, min_length=g)
    decoder = tg.RolloutDecoder()
    jout, tout = _run_both(greedy, eos=256, decoder=decoder, spec=spec,
                           p=p, g=g)
    _assert_same(jout, tout)
    (buf,) = decoder._buffers.values()
    assert buf.page_table is not None
    assert buf.page_table.shape == (4, (p + g) // tg.ROLLOUT_PAGE_SIZE)
    for eos in sorted(set(tout.gen_tokens.numpy().ravel().tolist())):
        jout, tout = _run_both(dict(greedy, max_length=p + g,
                                    min_length=p + 2), eos,
                               early_exit, monkeypatch, spec=spec, p=p, g=g)
        if not tout.gen_mask.numpy().all():
            break
    _assert_same(jout, tout)
    assert not tout.gen_mask.numpy().all()


@pytest.mark.parametrize("path", ["kernel", "plain"])
def test_decode_counters_read_the_path_taken(path, monkeypatch):
    """A rollout chunk's ``generate`` (``phase_args`` given) counts its
    steps into ``rollout/decode_kernel_steps`` or
    ``rollout/decode_plain_steps`` by the path the step's attention
    took, the other at 0; the tokens are the same either way; a call
    without ``phase_args`` counts nothing."""
    from trlx_tpu_torch import telemetry

    spec, p, g = ROUTED["gpt2-hd16"]
    tree, tokens, mask = _inputs(spec=spec, p=p)
    cfg = tg.GenerationConfig.from_gen_kwargs(
        g, dict(GREEDY, max_length=g, min_length=g), 256, 256, p)
    rule = tg.rollout_page_size

    def run(kernel, decoder=None, **kw):
        monkeypatch.setattr(tg, "rollout_page_size",
                            rule if kernel else lambda *a: None)
        return tg.generate(
            ModelSpec(**spec),
            *_views(tree, lambda x: torch.from_numpy(x.copy())),
            torch.from_numpy(tokens), torch.from_numpy(mask), None, cfg,
            compute_dtype=torch.float32, cache_dtype=torch.float32,
            decoder=decoder, **kw)

    kernel = path == "kernel"
    decoder = tg.RolloutDecoder()
    session = telemetry.start()
    try:
        out = run(kernel, decoder, phase_args={"chunk": 0, "rows": 4})
        counters = dict(session.registry.counters)
        run(kernel, decoder)
        again = dict(session.registry.counters)
    finally:
        telemetry.stop()
    (buf,) = decoder._buffers.values()
    assert (buf.page_table is not None) == kernel
    other = "plain" if path == "kernel" else "kernel"
    assert counters[f"rollout/decode_{path}_steps"] == g
    assert counters[f"rollout/decode_{other}_steps"] == 0
    assert again == counters
    np.testing.assert_array_equal(out.gen_tokens.numpy(),
                                  run(not kernel).gen_tokens.numpy())
