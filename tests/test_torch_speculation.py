"""The port's speculative decoding (trlx_tpu_torch.serve.speculate, the
``verify_step`` primitive and the slot scheduler's propose -> verify ->
accept loop) against trlx_tpu's, on the CPU, from the same numpy weights
at float32: the n-gram index, the per-slot speculator and the radix
cache's read-only ``peek_continuation`` (ported from
tests/test_speculation.py, and against trlx_tpu's on the same inputs);
``verify_step`` against trlx_tpu's (candidates, counts, lanes, carried
logits, pool pages) and against K + 1 plain ``decode_step`` calls; greedy
tokens with speculation on equal to speculation off and to trlx_tpu's
engine at page sizes 3, 8 and 24 for both KV tiers, with 0 recompiles;
the acceptance floor on a repetitive trace; the ``serve_speculate``
chaos drills; the draft tier's full acceptance with the target's own
port checkpoint as the draft; the construction checks with trlx_tpu's
messages; and the CLI's flags."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_paged import build_engine
from test_serve import tiny_config_dict
from trlx_tpu.data.configs import TRLConfig as JaxConfig
from trlx_tpu.models import generation as jg
from trlx_tpu.serve import InferenceEngine as JaxEngine
from trlx_tpu.serve import ServeConfig as JaxServe
from trlx_tpu.serve.paged import RadixCache as JaxRadixCache
from trlx_tpu import telemetry as jax_telemetry
from trlx_tpu.serve.batcher import Request as JaxRequest
from trlx_tpu.serve.slots import SlotScheduler as JaxSlotScheduler
from trlx_tpu.serve.slots import _LiveSlot as JaxLiveSlot
from trlx_tpu.serve.speculate import NgramIndex as JaxNgramIndex
from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models import generation as tg
from trlx_tpu_torch.models.params import decode_views_from_numpy
from trlx_tpu_torch.models.transformer import tree_map
from trlx_tpu_torch.serve import (
    InferenceEngine,
    Request,
    ServeConfig,
    SlotScheduler,
)
from trlx_tpu_torch.serve.__main__ import build_parser, serve_config_from_args
from trlx_tpu_torch.serve.paged import RadixCache
from trlx_tpu_torch.serve.slots import _LiveSlot
from trlx_tpu_torch.serve.speculate import (
    DraftProposer,
    NgramIndex,
    SlotSpeculator,
)
from trlx_tpu_torch.supervisor import RunSupervisor, chaos
from trlx_tpu_torch.utils.checkpoint import save_components

ATOL = 2e-4
BUCKETS = [[2, 8, 8], [4, 8, 8]]
ROWS = [
    [3, 1, 4, 1, 5],
    [3, 1, 4, 1, 5, 9, 2, 6],  # shares a 5-token prefix with row 0
    [9, 2, 6],
    [3, 1, 4, 1, 5, 9, 2, 6],  # full repeat of row 1
]


@pytest.fixture(scope="module")
def tree():
    """trlx_tpu's tiny policy as numpy (the weights both packages load)."""
    return jax.device_get(build_engine()._init_params())


def port_engine(tree, config=None, **serve):
    telemetry.start()
    cfg = TRLConfig.from_dict(config or tiny_config_dict())
    return InferenceEngine(
        cfg, serve=ServeConfig(**{
            "buckets": BUCKETS, "max_queue": 64, "slots": 4,
            "page_size": 4, "speculation": "lookup", "spec_k": 4, **serve}),
        views=decode_views_from_numpy(tree, cfg.model.resolve_spec(), 1),
        device="cpu")


@pytest.fixture()
def fresh_registry():
    session = telemetry.start()
    yield session.registry
    telemetry.start()


def run_staggered(s, rows=ROWS, max_new=8):
    s.warmup()
    s.start()
    try:
        done = []
        for phase in (rows[:2], rows[2:]):
            # each phase's rows are queued while the scheduler's lock is
            # held (an RLock, so submit re-enters it): the worker then
            # admits them together, never the first alone. The lookup
            # tier reads other rows' committed pages, so its proposal
            # counts follow the admission order.
            with s._cond:
                reqs = [s.submit(list(r), max_new_tokens=max_new)
                        for r in phase]
            for r in reqs:
                r.wait(timeout=60.0)
            done += reqs
        return [r.result for r in done]
    finally:
        s.stop()


# --------------------------------------------------------------------- #
# the proposal tier
# --------------------------------------------------------------------- #


def test_ngram_index_longest_gram_wins_and_never_self_matches():
    idx = NgramIndex(ngram_max=3, max_keys=64)
    idx.extend([1, 2, 3, 9, 1, 2, 3, 7])
    assert idx.lookup([5, 1, 2, 3]) == 7
    assert idx.lookup([4, 4, 3]) == 7
    idx = NgramIndex(ngram_max=2, max_keys=64)
    h = [1, 2, 3]
    idx.extend(h)
    assert idx.lookup(h) is None
    h.append(4)
    idx.extend(h)
    assert idx.lookup([9, 2, 3]) == 3
    assert idx.lookup(h) is None
    idx = NgramIndex(ngram_max=2, max_keys=8)
    idx.extend(list(range(100)))
    assert len(idx) <= 8
    assert idx.lookup([97, 98]) == 99
    assert idx.lookup([1, 2]) is None
    with pytest.raises(ValueError, match="max_keys"):
        NgramIndex(max_keys=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_ngram_index_matches_trlx_tpu(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = NgramIndex(3, 16), JaxNgramIndex(3, 16)
    history = []
    for _ in range(60):
        history.extend(int(t) for t in rng.integers(0, 6, rng.integers(1, 4)))
        ours.extend(history)
        theirs.extend(history)
        probe = history[-int(rng.integers(1, 5)):]
        assert ours.lookup(probe) == theirs.lookup(probe)
        assert len(ours) == len(theirs)


def test_slot_speculator_proposes_from_own_history():
    sp = SlotSpeculator([1, 2, 3, 1, 2], spec_k=3)
    assert sp.propose() == [3, 1, 2]
    sp.append([9])
    assert sp.propose() == []


def test_radix_peek_continuation_is_read_only_and_matches_trlx_tpu():
    caches = [RadixCache(8, 2), JaxRadixCache(8, 2)]
    for c in caches:
        pages = c.alloc(3)
        c.commit([1, 2, 3, 4, 5, 6], pages)
        c.release_all(pages)
    c = caches[0]
    free_before, clock = c.free_pages(), c._clock
    assert c.peek_continuation([1, 2], 4) == [3, 4, 5, 6]
    assert c.peek_continuation([1, 2, 3], 2) == [4, 5]
    assert c.peek_continuation([9, 9], 4) == []
    for probe, k in (([1, 2], 4), ([1, 2, 3], 2), ([1], 9), ([], 3),
                     ([9, 9], 4), ([1, 2, 3, 4, 5], 1)):
        assert c.peek_continuation(probe, k) == \
            caches[1].peek_continuation(probe, k)
    # read-only: no refcount taken, no LRU clock tick
    assert c.free_pages() == free_before and c._clock == clock
    assert all(c.allocator.refcount(p) == 0 for p in pages)


@pytest.mark.parametrize("mode", ["lookup", "draft"])
def test_gathered_proposals_match_trlx_tpu(tree, mode):
    """Both tiers ship the first K tokens of their continuation of the
    slot's history, as trlx_tpu's scheduler does: the same [S, K]
    proposal batch from the same history and weights (the draft tier
    with the target injected as its own draft)."""
    history = [1, 2, 3, 1, 2, 3, 1]
    serve = {"speculation": mode, "spec_k": 3}
    if mode == "draft":
        serve["spec_draft_checkpoint"] = "unused-injected"
    jengine = build_engine(buckets=BUCKETS, **serve)
    jengine._install_params(tree)
    engine = port_engine(tree, **serve)
    jdraft = draft = None
    if mode == "draft":
        from trlx_tpu.serve.speculate import DraftProposer as JaxDraft

        jdraft = JaxDraft(jengine, spec_k=3, batch=jengine.slot_count())
        draft = DraftProposer(engine, spec_k=3, batch=engine.slot_count())
    got = []
    for sched, live_cls, req in (
            (JaxSlotScheduler(jengine, draft=jdraft), JaxLiveSlot,
             JaxRequest(list(history), 8, (8, 8))),
            (SlotScheduler(engine, draft=draft), _LiveSlot,
             Request(list(history), 8, (8, 8)))):
        sched._live[0] = live_cls(req)
        sched._spawn_speculator(0, req.tokens)
        props, n = sched._gather_proposals()
        got.append((props.tolist(), n.tolist()))
    assert got[1] == got[0]
    props, n = got[1]
    assert n[0] == 3 and not any(n[1:])
    if mode == "lookup":
        # the trigram [2, 3, 1] last continued with 2, 3, 1
        assert props[0] == [2, 3, 1]


# --------------------------------------------------------------------- #
# verify_step
# --------------------------------------------------------------------- #


def _jax_views(tree):
    to = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    return ((to(tree["frozen_base"]["blocks"]),
             to(tree["trainable"]["blocks"])),
            to(dict(tree["frozen_base"]["embed"])),
            to(tree["trainable"]["ln_f"]))


def _lanes_equal(tstate, jstate, num_pages):
    for name in ("valid", "offset", "pos", "generated", "max_new", "active",
                 "finished", "pages"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    rows = np.asarray(jstate.active)
    np.testing.assert_allclose(tstate.logits.numpy()[rows],
                               np.asarray(jstate.logits)[rows], atol=ATOL)


@pytest.mark.parametrize("page_size", [3, 8])
def test_verify_step_matches_trlx_tpu_and_plain_steps(tree, page_size):
    """Three slots admitted, two plain steps, then verify passes with
    proposals that are the greedy continuation (accepted), wrong after
    one token, and absent, one row close to its budget's end (its
    window runs past the buffer): candidates, counts, lanes, carried
    logits and pool pages against trlx_tpu's; and the emitted tokens and
    the carried logits against plain decode_steps from the same
    state."""
    engine = port_engine(tree)
    spec, cfg = engine.spec, engine.gen_config._replace(gen_size=8)
    jengine = build_engine()
    jspec, jcfg = jengine.spec, jengine._gen_base._replace(gen_size=8)
    jb, je, jl = _jax_views(tree)
    S, K, P = 3, 4, 8
    max_pages = -(-16 // page_size)
    T, num_pages = max_pages * page_size, S * max_pages
    tokens = np.full((S, P), 256, np.int32)
    mask = np.zeros((S, P), np.int32)
    for i, r in enumerate((ROWS[1], [7, 7, 2], [1, 2, 3, 1, 2, 3, 1])):
        tokens[i, :len(r)], mask[i, :len(r)] = r, 1
    tables = np.arange(num_pages, dtype=np.int32).reshape(S, max_pages)
    max_new = np.asarray([T - 8, 5, 9], np.int32)

    def fresh():
        tpool = tg.init_page_pool(spec, [1, 1], num_pages, page_size)
        tstate = tg.init_slot_state(S, T, 257, max_pages)
        tg.prefill_into_slots(
            spec, engine.blocks, engine.embed, engine.ln_f, tpool, tstate,
            tokens, mask, np.arange(S), max_new, compute_dtype=torch.float32,
            page_tables=tables, page_size=page_size, start=np.zeros(S))
        return tpool, tstate

    def plain(tpool, tstate, n):
        out = []
        for _ in range(n):
            _, _, tok, em, _ = tg.decode_step(
                spec, engine.blocks, engine.embed, engine.ln_f, tpool,
                tstate, None, cfg, compute_dtype=torch.float32)
            out.append((tok.numpy().copy(), em.numpy().copy(),
                        tstate.logits.clone()))
        return out

    tpool, tstate = fresh()
    jpool = jg.init_page_pool(jspec, [1, 1], num_pages, page_size)
    jstate = jg.init_slot_state(S, T, 257, max_pages=max_pages)
    jpool, jstate = jax.jit(lambda pool, st, pt: jg.prefill_into_slots(
        jspec, jb, je, jl, pool, st, tokens, mask,
        np.arange(S, dtype=np.int32), max_new, compute_dtype=jnp.float32,
        page_tables=pt, page_size=page_size,
        start=np.zeros(S, np.int32)))(jpool, jstate, tables)
    jstep = jax.jit(lambda pool, st, seed: jg.decode_step(
        jspec, jb, je, jl, pool, st, seed, jcfg, compute_dtype=jnp.float32))
    jverify = jax.jit(lambda pool, st, seed, pr, n: jg.verify_step(
        jspec, jb, je, jl, pool, st, seed, pr, n, jcfg,
        compute_dtype=jnp.float32))
    for i in range(2):
        jpool, jstate, _, _, _ = jstep(jpool, jstate, np.int32(i))
    plain(tpool, tstate, 2)
    _lanes_equal(tstate, jstate, num_pages)

    # the greedy continuation of each row, from a plain copy of the state
    cpool, cstate = fresh()
    plain(cpool, cstate, 2)
    ahead = plain(cpool, cstate, K + 1)
    greedy = np.stack([t for t, _, _ in ahead], 1)  # [S, K + 1]
    props = greedy[:, 1:].copy()
    props[1, 1:] = (props[1, 1:] + 1) % 256  # row 1: wrong after one
    nprop = np.asarray([K, K, 0], np.int32)  # row 2: nothing proposed

    for seed in (2, 3):
        jpool, jstate, jcand, jcounts, jfin = jverify(
            jpool, jstate, np.int32(seed), props, nprop)
        _, _, cand, counts, fin = tg.verify_step(
            spec, engine.blocks, engine.embed, engine.ln_f, tpool, tstate,
            None, torch.as_tensor(props), torch.as_tensor(nprop), cfg,
            compute_dtype=torch.float32)
        np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        np.testing.assert_array_equal(fin.numpy(), np.asarray(jfin))
        _lanes_equal(tstate, jstate, num_pages)
        for mine, theirs in zip(tpool, jpool):
            for x, y in zip(mine, theirs):
                np.testing.assert_allclose(x[:, :num_pages].float().numpy(),
                                           np.asarray(y, np.float32),
                                           atol=ATOL)
        if seed == 2:
            # the first pass against the plain steps: each row emitted
            # its greedy prefix and carries that prefix's next logits
            c = counts.numpy()
            assert c.tolist() == [K + 1, 2, 1]
            for s in range(S):
                assert cand.numpy()[s, :c[s]].tolist() == \
                    greedy[s, :c[s]].tolist()
                np.testing.assert_allclose(tstate.logits[s].numpy(),
                                           ahead[c[s] - 1][2][s].numpy(),
                                           atol=1e-5)
            props = np.zeros_like(props)  # second pass: all rejected


# --------------------------------------------------------------------- #
# the engine: speculation on == off == trlx_tpu
# --------------------------------------------------------------------- #


#: the staggered shared-prefix trace with a periodic row, whose own
#: history has proposals from its first step
SPEC_ROWS = [ROWS[0], ROWS[1], [1, 2, 3, 1, 2, 3, 1], ROWS[3]]


@pytest.mark.parametrize("page_size", [3, 8, 24])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_greedy_parity_spec_on_off_and_trlx_tpu(tree, page_size, kv_dtype):
    jengine = build_engine(buckets=BUCKETS, page_size=page_size,
                           kv_dtype=kv_dtype, speculation="lookup", spec_k=4)
    jengine._install_params(tree)
    want = run_staggered(JaxSlotScheduler(jengine), rows=SPEC_ROWS)
    jcounters = dict(jax_telemetry.current().registry.counters)
    off = run_staggered(SlotScheduler(port_engine(
        tree, page_size=page_size, kv_dtype=kv_dtype, speculation="off")),
        rows=SPEC_ROWS)
    engine = port_engine(tree, page_size=page_size, kv_dtype=kv_dtype)
    s = SlotScheduler(engine)
    on = run_staggered(s, rows=SPEC_ROWS)
    assert on == off == want, (page_size, kv_dtype)
    counters = telemetry.current().registry.counters
    assert counters["compile/recompiles"] == 0.0
    assert counters["serve/spec_proposed"] > 0
    for name in ("serve/spec_proposed", "serve/spec_accepted"):
        assert counters.get(name, 0.0) == jcounters.get(name, 0.0), name
    assert counters.get("serve/spec_fallbacks", 0.0) == 0.0
    assert s.runtime.verify_steps > 0
    assert s.free_slots() == s.runtime.num_slots and not s._speculators


def test_spec_effective_tokens_per_step_floor(tree, fresh_registry):
    engine = port_engine(tree, buckets=[[2, 8, 16], [4, 8, 16]])
    s = SlotScheduler(engine)
    s.warmup()
    s.start()
    try:
        rows = [[1, 2, 3, 1, 2, 3, 1], [7, 8, 7, 8, 7, 8]]
        reqs = [s.submit(r, max_new_tokens=16) for r in rows]
        for r in reqs:
            r.wait(timeout=60.0)
        generated = sum(len(r.result) for r in reqs)
        effective = generated / max(s._step_counter, 1)
        assert effective >= 1.5, effective
        reg = telemetry.current().registry
        accepted = reg.counters["serve/spec_accepted"]
        assert 0 < accepted <= reg.counters["serve/spec_proposed"]
        assert reg.counters["serve/spec_steps_saved"] == accepted
        assert reg.gauges["serve/spec_acceptance_rate"] > 0.0
        assert s.pool_stats()["speculation"]["accepted"] == accepted
        assert reg.counters["compile/recompiles"] == 0.0
    finally:
        s.stop()


def test_chaos_speculate_exc_falls_back_to_plain_decode(tree,
                                                         fresh_registry):
    off = run_staggered(SlotScheduler(port_engine(tree, speculation="off")),
                        rows=[[1, 2, 3, 1, 2, 3, 1]])
    engine = port_engine(tree)
    registry = telemetry.current().registry
    chaos.configure("serve_speculate:exc@1-2")
    try:
        got = run_staggered(SlotScheduler(engine),
                            rows=[[1, 2, 3, 1, 2, 3, 1]])
        assert registry.counters["serve/spec_fallbacks"] >= 1.0
        assert registry.counters.get("serve/request_errors", 0.0) == 0.0
        assert got == off
    finally:
        chaos.reset()


def test_chaos_speculate_hang_is_attributable_stall(tree, fresh_registry):
    exits = []
    sup = RunSupervisor(stall_timeout=0.3, stall_first_timeout=0.3,
                        stall_grace=10_000.0, exit_fn=exits.append)
    engine = port_engine(tree)
    registry = telemetry.current().registry
    s = SlotScheduler(engine, run_supervisor=sup)
    s.warmup()
    chaos.configure("serve_speculate:hang=60@1")
    s.start()
    try:
        req = s.submit([1, 2, 3, 1, 2], max_new_tokens=4)
        deadline = time.monotonic() + 15.0
        while sup.stalls == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sup.stalls >= 1
        assert sup.stalled_phase == "serve_decode"
        assert registry.counters["fault/stalls"] >= 1.0
        chaos.reset()  # the hang raises in _gather_proposals: fallback
        assert req.wait(timeout=15.0).result is not None
        assert registry.counters["serve/spec_fallbacks"] >= 1.0
        assert not exits
    finally:
        chaos.reset()
        s.stop()


# --------------------------------------------------------------------- #
# the draft tier
# --------------------------------------------------------------------- #


def test_draft_tier_full_acceptance_from_a_port_checkpoint(tree, tmp_path):
    """The target's own weights, saved as a port checkpoint, as the
    draft: the output equals speculation off, and the proposal and
    acceptance counts equal trlx_tpu's with the target injected as its
    own draft (both ship the first K drafted tokens; on this tiny
    policy, whose greedy tokens repeat, everything proposed is
    accepted, as tests/test_speculation.py finds). The injected-draft
    form agrees."""
    from trlx_tpu.serve.speculate import DraftProposer as JaxDraft

    ckpt = str(tmp_path / "step_1")
    save_components({"params": tree_map(torch.tensor, tree),
                     "config": tiny_config_dict()}, ckpt)
    rows = [[5, 6, 7], [9, 9, 2, 6], [3, 1, 4], [1, 2]]
    jengine = build_engine(buckets=BUCKETS, speculation="draft", spec_k=4,
                           spec_draft_checkpoint="unused-injected")
    jengine._install_params(tree)
    want = run_staggered(JaxSlotScheduler(jengine, draft=JaxDraft(
        jengine, spec_k=4, batch=jengine.slot_count())), rows=rows)
    jcounters = jax_telemetry.current().registry.counters
    off = run_staggered(SlotScheduler(port_engine(tree, speculation="off")),
                        rows=rows)
    assert off == want
    for inject in (False, True):
        engine = port_engine(tree, speculation="draft",
                             spec_draft_checkpoint=ckpt)
        draft = DraftProposer(engine, spec_k=4, batch=engine.slot_count()) \
            if inject else None
        s = SlotScheduler(engine, draft=draft)
        assert isinstance(s._draft, DraftProposer)
        assert run_staggered(s, rows=rows) == off
        reg = telemetry.current().registry
        proposed = reg.counters["serve/spec_proposed"]
        assert proposed > 0
        assert proposed == jcounters["serve/spec_proposed"]
        assert reg.counters["serve/spec_accepted"] == \
            jcounters["serve/spec_accepted"] == proposed
        assert reg.counters.get("serve/spec_fallbacks", 0.0) == 0.0
        assert reg.counters["compile/recompiles"] == 0.0
        assert s.free_slots() == s.runtime.num_slots


# --------------------------------------------------------------------- #
# construction checks and the CLI
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("bad", [
    dict(kv_layout="contiguous", page_size=64),
    dict(speculation="draft"),
    dict(spec_k=0),
    dict(speculation="banana"),
    dict(spec_index_max_keys=0),
    dict(spec_ngram_max=0),
    dict(scheduler="banana"),
    dict(kv_layout="banana"),
    dict(kv_layout="contiguous", attention="pallas", speculation="off"),
])
def test_refusals_carry_trlx_tpu_messages(tree, bad):
    serve = {"buckets": BUCKETS, "slots": 4, "page_size": 4,
             "speculation": "lookup", **bad}
    with pytest.raises(ValueError) as theirs:
        JaxEngine(JaxConfig.from_dict(tiny_config_dict()),
                  serve=JaxServe(**serve), init=False)
    with pytest.raises(ValueError) as ours:
        port_engine(tree, **bad)
    assert str(ours.value) == str(theirs.value)


def test_speculation_requires_greedy(tree):
    sampled = tiny_config_dict(do_sample=True)
    with pytest.raises(ValueError, match="greedy") as theirs:
        JaxEngine(JaxConfig.from_dict(sampled), serve=JaxServe(
            buckets=BUCKETS, speculation="lookup"), init=False)
    with pytest.raises(ValueError, match="greedy") as ours:
        port_engine(tree, config=sampled)
    assert str(ours.value) == str(theirs.value)


def test_cli_speculation_and_tier_flags():
    args = build_parser().parse_args([
        "--checkpoint", "ckpt", "--speculation", "lookup", "--spec-k", "6",
        "--spec-draft-checkpoint", "draft-ckpt", "--kv-dtype", "int8",
        "--weights-dtype", "int8",
    ])
    cfg = serve_config_from_args(args, {"serve": {"spec_k": 2}})
    assert (cfg.speculation, cfg.spec_k, cfg.spec_draft_checkpoint) == (
        "lookup", 6, "draft-ckpt")
    assert (cfg.kv_dtype, cfg.weights_dtype) == ("int8", "int8")
    cfg = serve_config_from_args(build_parser().parse_args(
        ["--checkpoint", "c"]), {"serve": {"speculation": "draft"}})
    assert cfg.speculation == "draft" and cfg.spec_k == 4
