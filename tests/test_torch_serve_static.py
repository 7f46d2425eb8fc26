"""The port's static micro-batcher and contiguous KV layout
(trlx_tpu_torch.serve) against trlx_tpu's, on the CPU, from the same
numpy weights at float32: the engine's per-bucket ``decode`` (greedy
tokens and mask identical, logprobs close), the micro-batcher's flush
rules, admission control and containment (ported from
tests/test_serve.py), the contiguous slot primitives (pool, lanes and
logits through a staggered admission and greedy steps) and the
contiguous slot engine's greedy tokens, plus the static scheduler behind
the HTTP server and the CLI's flags."""

import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_paged_kernel import ROWS
from test_serve import tiny_config_dict
from trlx_tpu import telemetry as jax_telemetry
from trlx_tpu.models import generation as jg
from trlx_tpu.serve import InferenceEngine as JaxEngine
from trlx_tpu.serve import ServeConfig as JaxServeConfig
from trlx_tpu.serve.slots import SlotScheduler as JaxSlotScheduler
from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models import generation as tg
from trlx_tpu_torch.models.params import decode_views_from_numpy
from trlx_tpu_torch.serve import (
    InferenceEngine,
    InferenceServer,
    MicroBatcher,
    QueueFull,
    ServeConfig,
    SlotScheduler,
)
from trlx_tpu_torch.serve.__main__ import build_parser, serve_config_from_args
from trlx_tpu_torch.supervisor import RunSupervisor, chaos

STATIC = dict(buckets=[[2, 8, 8], [4, 8, 8], [4, 16, 8]], max_wait_ms=40.0,
              max_queue=64, request_timeout=30.0, scheduler="static")
ATOL = 2e-4


@pytest.fixture(scope="module")
def pair():
    """A trlx_tpu engine and the port's on its weights (static lattice)."""
    jax_telemetry.start()
    jengine = JaxEngine(_jax_config(), serve=JaxServeConfig(**STATIC))
    tree = jax.device_get(jengine._init_params())
    views = decode_views_from_numpy(tree, jengine.spec, 1)
    return jengine, views, tree


def _jax_config():
    from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig

    return JaxTRLConfig.from_dict(tiny_config_dict())


def port_engine(views, **serve):
    telemetry.start()
    return InferenceEngine(TRLConfig.from_dict(tiny_config_dict()),
                           serve=ServeConfig(**{**STATIC, **serve}),
                           views=views, device="cpu")


@pytest.fixture(scope="module")
def engine(pair):
    return port_engine(pair[1])


@pytest.fixture()
def fresh_registry():
    session = telemetry.start()
    yield session.registry
    telemetry.start()


@pytest.fixture()
def batcher(engine):
    b = MicroBatcher(engine).start()
    yield b
    b.stop()


# --------------------------------------------------------------------- #
# the engine's static path against trlx_tpu's
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("bucket", [(2, 8, 8), (4, 16, 8)])
def test_static_decode_matches_trlx_tpu(pair, engine, bucket):
    jengine = pair[0]
    rows = [list(r) for r in ROWS[:bucket[0]]]
    rows[-1] = rows[-1][:2]  # a short row: left padding
    tokens, mask = engine.pad_batch(rows, bucket)
    jt, jm = jengine.pad_batch(rows, bucket)
    np.testing.assert_array_equal(tokens, jt)
    np.testing.assert_array_equal(mask, jm)
    want = jengine.decode(bucket, jt, jm, seed=0)
    got = engine.decode(bucket, tokens, mask, seed=0)
    np.testing.assert_array_equal(got.gen_tokens, np.asarray(want.gen_tokens))
    np.testing.assert_array_equal(got.gen_mask, np.asarray(want.gen_mask))
    np.testing.assert_allclose(got.gen_logprobs,
                               np.asarray(want.gen_logprobs), atol=ATOL)
    for i, r in enumerate(rows):
        assert engine.depad_row(got, i, 5) == jengine.depad_row(want, i, 5)


def test_lattice_helpers_match_trlx_tpu(pair, engine):
    jengine = pair[0]
    for shape in engine.shape_classes():
        assert engine.batch_sizes_for(shape) == \
            jengine.batch_sizes_for(shape)
    assert engine.span_name((4, 8, 8)) == jengine.span_name((4, 8, 8))


def test_warmup_runs_each_bucket_once(engine, fresh_registry):
    engine._decoders = {}
    engine.warmed = False
    latencies = engine.warmup()
    assert engine.warmed
    assert set(latencies) == {engine.span_name(b) for b in engine.buckets}
    assert fresh_registry.counters.get("compile/recompiles", 0.0) == 0.0
    b = engine.buckets[0]
    tokens, mask = engine.pad_batch([[1, 2]], b)
    engine.decode(b, tokens, mask, seed=3)
    assert fresh_registry.counters.get("compile/recompiles", 0.0) == 0.0
    assert len(engine._decoders) == len(engine.buckets)


# --------------------------------------------------------------------- #
# micro-batcher semantics (tests/test_serve.py's)
# --------------------------------------------------------------------- #


def test_deadline_flush_partial_batch(engine, fresh_registry, batcher):
    t0 = time.monotonic()
    req = batcher.submit([1, 2, 3], max_new_tokens=4)
    req.wait(timeout=30.0)
    assert req.result is not None and len(req.result) <= 4
    assert time.monotonic() - t0 < 25.0
    # one request in a batch-2 bucket: fill ratio 0.5
    assert fresh_registry.gauges["serve/batch_fill_ratio"] == 0.5
    assert fresh_registry.counters["serve/batches"] == 1.0
    assert fresh_registry.counters["serve/responses"] == 1.0
    assert "serve/request_latency{path=static}" in fresh_registry.hists
    # the result is the direct decode's row, cut to its own budget
    tokens, mask = engine.pad_batch([[1, 2, 3]], (2, 8, 8))
    direct = engine.decode((2, 8, 8), tokens, mask, seed=0)
    assert req.result == engine.depad_row(direct, 0, 4)


def test_full_bucket_flushes_before_deadline(engine, fresh_registry):
    b = MicroBatcher(engine, max_wait_ms=30_000.0).start()
    try:
        t0 = time.monotonic()
        reqs = [b.submit([i + 1], max_new_tokens=2) for i in range(4)]
        for r in reqs:
            r.wait(timeout=30.0)
        # the largest (8, 8) extent is 4: filling it must flush without
        # waiting out the 30 s deadline
        assert time.monotonic() - t0 < 20.0
        assert fresh_registry.gauges["serve/batch_fill_ratio"] == 1.0
    finally:
        b.stop()


def test_bucket_rounding_groups_same_shape_only(engine, batcher):
    short = batcher.submit([1, 2], max_new_tokens=8)  # (8, 8) class
    long = batcher.submit(list(range(1, 13)), max_new_tokens=8)  # (16, 8)
    short.wait(timeout=30.0)
    long.wait(timeout=30.0)
    assert short.shape == (8, 8)
    assert long.shape == (16, 8)


def test_queue_overflow_submit_validation_and_stop(engine, fresh_registry):
    b = MicroBatcher(engine, max_queue=3)  # not started: nothing drains
    for _ in range(3):
        b.submit([1, 2], max_new_tokens=2)
    with pytest.raises(QueueFull, match="retry with backoff"):
        b.submit([1, 2], max_new_tokens=2)
    assert fresh_registry.counters["serve/rejected"] == 1.0
    assert b.retry_after_s() >= 1
    with pytest.raises(ValueError, match="empty prompt"):
        b.submit([], max_new_tokens=2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        b.submit([1], max_new_tokens=0)
    with pytest.raises(ValueError, match="fits no serve bucket"):
        b.submit([1], max_new_tokens=99)
    with pytest.raises(TimeoutError, match="not decoded within"):
        b._queue[0].wait(timeout=0.05)
    pending = list(b._queue)
    b.stop()  # pending requests are failed, not stranded
    with pytest.raises(RuntimeError, match="batcher stopped"):
        pending[0].wait(timeout=1.0)


def test_chaos_exc_fails_batch_not_loop(engine, fresh_registry, batcher):
    chaos.configure("serve_decode:exc@1")
    try:
        bad = batcher.submit([1, 2], max_new_tokens=2)
        with pytest.raises(chaos.ChaosError):
            bad.wait(timeout=30.0)
        good = batcher.submit([1, 2], max_new_tokens=2)
        assert good.wait(timeout=30.0).result is not None
        assert fresh_registry.counters["serve/request_errors"] == 1.0
    finally:
        chaos.reset()


def test_chaos_hang_surfaces_as_watchdog_stall(engine, fresh_registry):
    """serve_decode:hang wedges the decode phase: the serve supervisor
    the worker entered flags a stall attributed to 'serve_decode'."""
    exits = []
    sup = RunSupervisor(stall_timeout=0.3, stall_first_timeout=0.3,
                        stall_grace=10_000.0, exit_fn=exits.append)
    chaos.configure("serve_decode:hang=60@1")
    b = MicroBatcher(engine, run_supervisor=sup).start()
    try:
        req = b.submit([1, 2], max_new_tokens=2)
        deadline = time.monotonic() + 15.0
        while sup.stalls == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sup.stalls >= 1
        assert sup.stalled_phase == "serve_decode"
        assert fresh_registry.counters["fault/stalls"] >= 1.0
        chaos.reset()  # the hang raises in the worker: the batch fails
        with pytest.raises(chaos.ChaosHang):
            req.wait(timeout=15.0)
        assert b.submit([1, 2], max_new_tokens=2).wait(30.0).result
        assert not exits
    finally:
        chaos.reset()
        b.stop()


def test_watchdog_abort_stops_the_followers_first(engine, monkeypatch):
    """The serve watchdog's abort on process 0 of a serve mesh: the
    server's exit hook sends the followers' ``stop`` first, bounded by
    ``ABORT_STOP_TIMEOUT`` (a follower stuck in the hung step never takes
    it), then exits with the watchdog's code."""
    import threading

    from trlx_tpu_torch.serve import server as server_mod

    events = []
    release = threading.Event()

    class Channel:
        leader = True
        hang = False

        def close(self):
            if self.hang:
                release.wait(30.0)
            events.append("stop")

    channel = Channel()
    monkeypatch.setattr(engine, "channel", channel)
    monkeypatch.setattr(engine.serve, "stall_timeout", 5.0)
    monkeypatch.setattr(server_mod, "_exit", events.append)
    monkeypatch.setattr(server_mod, "ABORT_STOP_TIMEOUT", 0.2)
    srv = InferenceServer(engine, host="127.0.0.1", port=0)
    assert srv.supervisor.stall_action == "abort"
    srv.supervisor.exit_fn(70)
    assert events == ["stop", 70]
    channel.hang = True
    srv.supervisor.exit_fn(70)  # the stop hangs: the exit comes anyway
    assert events == ["stop", 70, 70]
    release.set()


# --------------------------------------------------------------------- #
# the contiguous layout
# --------------------------------------------------------------------- #


def _jax_views(tree):
    to = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    return ((to(tree["frozen_base"]["blocks"]),
             to(tree["trainable"]["blocks"])),
            to(dict(tree["frozen_base"]["embed"])),
            to(tree["trainable"]["ln_f"]))


def _check_rows(tstate, jstate, tpool, jpool):
    S, T = tstate.valid.shape
    for name in ("valid", "offset", "pos", "generated", "max_new", "active",
                 "finished"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    assert tstate.pages is None and jstate.pages is None
    rows = np.asarray(jstate.active)
    np.testing.assert_allclose(tstate.logits.numpy()[rows],
                               np.asarray(jstate.logits)[rows], atol=ATOL)
    for (tk, tv), (jk, jv) in zip(tpool, jpool):
        for mine, theirs in ((tk, jk), (tv, jv)):
            np.testing.assert_allclose(
                mine[:, :S, :T].float().numpy(),
                np.asarray(theirs.astype(jnp.float32)), atol=ATOL)


def test_contiguous_primitives_match_trlx_tpu(pair):
    """Left-padded admission into slots 2 and 0 with a filler row, greedy
    steps, a second admission mid-decode into slot 1, more steps: pool,
    lanes and carried logits against trlx_tpu's after every call."""
    jengine, views, tree = pair
    spec, jspec = port_engine(views).spec, jengine.spec
    jb, je, jl = _jax_views(tree)
    S, T, P = 3, 16, 8
    cfg = port_engine(views).gen_config._replace(gen_size=8,
                                                 eos_token_id=-1)
    jcfg = jengine._gen_base._replace(gen_size=8, eos_token_id=-1)
    jpool = jg.init_slot_pool(jspec, [1, 1], S, T)
    jstate = jg.init_slot_state(S, T, 257)
    tpool = tg.init_slot_pool(spec, [1, 1], S, T)
    tstate = tg.init_slot_state(S, T, 257)
    assert tpool[0][0].shape[1:3] == (S + 1, T + 1)

    def admit(rows, slot_ids, max_new):
        nonlocal jpool, jstate
        tokens, mask = jengine.pad_batch(rows, (3, P, 0))
        jpool, jstate = jax.jit(
            lambda pool, st, *h: jg.prefill_into_slots(
                jspec, jb, je, jl, pool, st, *h, compute_dtype=jnp.float32)
        )(jpool, jstate, tokens, mask, np.asarray(slot_ids, np.int32),
          np.asarray(max_new, np.int32))
        tg.prefill_into_slots(
            spec, views.blocks, views.embed, views.ln_f, tpool, tstate,
            tokens, mask, np.asarray(slot_ids, np.int32),
            np.asarray(max_new, np.int32), compute_dtype=torch.float32)
        _check_rows(tstate, jstate, tpool, jpool)

    def steps(n):
        nonlocal jpool, jstate
        for i in range(n):
            jpool, jstate, jtok, jem, _ = jax.jit(
                lambda pool, st, seed: jg.decode_step(
                    jspec, jb, je, jl, pool, st, seed, jcfg,
                    compute_dtype=jnp.float32)
            )(jpool, jstate, np.int32(i))
            _, _, tok, em, _ = tg.decode_step(
                spec, views.blocks, views.embed, views.ln_f, tpool, tstate,
                None, cfg, compute_dtype=torch.float32)
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
            np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
            _check_rows(tstate, jstate, tpool, jpool)

    admit([ROWS[1], [7, 7, 2], [1]], [2, 0, S], [8, 2, 1])
    steps(3)
    admit([ROWS[2]], [1, S, S], [8, 1, 1])
    steps(7)  # slot 2 reaches offset == T: its last writes drop


def test_contiguous_prefill_drop_rows_touch_nothing(pair):
    """Filler rows (slot id == S) land in the drop row: the slots' pool
    regions and lanes are untouched."""
    spec = port_engine(pair[1]).spec
    views = pair[1]
    S, T = 2, 16
    pool = tg.init_slot_pool(spec, [1, 1], S, T)
    state = tg.init_slot_state(S, T, 257)
    tokens = np.full((2, 8), 256, np.int32)
    tokens[:, -1] = 5
    mask = np.zeros((2, 8), np.int32)
    mask[:, -1] = 1
    tg.prefill_into_slots(spec, views.blocks, views.embed, views.ln_f, pool,
                          state, tokens, mask, np.asarray([S, S], np.int32),
                          np.ones(2, np.int32), compute_dtype=torch.float32)
    for k, v in pool:
        assert not k[:, :S].any() and not v[:, :S].any()
        assert k[:, S].any()  # the drop row took the writes
    assert not state.active.any() and state.finished.all()
    assert not state.valid.any()


def _run_staggered(s, max_new=8):
    first = [s.submit(list(r), max_new_tokens=max_new) for r in ROWS[:2]]
    for r in first:
        r.wait(timeout=60.0)
    second = [s.submit(list(r), max_new_tokens=max_new) for r in ROWS[2:]]
    for r in second:
        r.wait(timeout=60.0)
    return [r.result for r in first + second]


def test_contiguous_slot_engine_tokens_identical_to_trlx_tpu(pair):
    slots = dict(buckets=[[2, 8, 8], [4, 8, 8]], scheduler="slots",
                 slots=4, kv_layout="contiguous", page_size=64)
    jax_telemetry.start()
    jengine = JaxEngine(_jax_config(), serve=JaxServeConfig(
        **{**STATIC, **slots}), params=pair[2])
    js = JaxSlotScheduler(jengine)
    js.warmup()
    js.start()
    try:
        expected = _run_staggered(js)
    finally:
        js.stop()
    engine = port_engine(pair[1], **slots)
    s = SlotScheduler(engine)
    assert s.cache is None
    stats = s.pool_stats()
    assert stats["kv_layout"] == "contiguous" and stats["slots"] == 4
    assert "pages_total" not in stats and stats["pool_gb"] > 0
    s.warmup()
    s.start()
    try:
        assert _run_staggered(s) == expected
    finally:
        s.stop()
    counters = telemetry.current().registry.counters
    assert counters["compile/recompiles"] == 0.0
    assert counters["serve/admissions"] == counters["serve/responses"] == 4
    assert s.free_slots() == 4


# --------------------------------------------------------------------- #
# the HTTP server and the CLI
# --------------------------------------------------------------------- #


def test_http_static_scheduler(engine, fresh_registry):
    tokens, mask = engine.pad_batch([ROWS[1]], (2, 8, 8))
    want = engine.depad_row(engine.decode((2, 8, 8), tokens, mask), 0, 8)
    server = InferenceServer(engine, host="127.0.0.1", port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        assert isinstance(server.scheduler, MicroBatcher)
        req = urllib.request.Request(
            f"{base}/generate",
            data=json.dumps({"tokens": ROWS[1], "max_new_tokens": 8,
                             "seed": 0}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        assert body["tokens"] == want and body["bucket"] == [8, 8]
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["scheduler"] == "static" and health["warmed"]
        assert "kv" not in health and health["recompiles"] == 0.0
    finally:
        server.stop()


def test_cli_static_and_layout_flags():
    args = build_parser().parse_args([
        "--config", "x.json", "--scheduler", "static", "--max-wait-ms", "5",
        "--kv-layout", "contiguous", "--pages", "32",
    ])
    cfg = serve_config_from_args(args, {"serve": {"max_wait_ms": 50.0,
                                                  "pages": 8}})
    assert (cfg.scheduler, cfg.max_wait_ms, cfg.kv_layout, cfg.pages) == (
        "static", 5.0, "contiguous", 32)
    cfg = serve_config_from_args(build_parser().parse_args(
        ["--config", "x.json"]), {"serve": {"scheduler": "static"}})
    assert cfg.scheduler == "static" and cfg.kv_layout == "paged"
