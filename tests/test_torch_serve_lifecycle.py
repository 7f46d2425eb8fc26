"""The port's crash-only serve lifecycle — poisoned-step replay, graceful
drain, hot-swap and the checkpoint watcher — against trlx_tpu's on the
CPU (tests/test_lifecycle.py is the reference's own file): greedy tokens
after a chaos-poisoned step (mid-prefill, mid-decode, behind a backlog,
at the prefix match) equal trlx_tpu's un-poisoned run at fp32 on the
same weights, swept over page sizes, with no leaked slot or page and 0
recompiles; ``max_replays`` exhaustion and a replay that outgrows the
lattice give ``ReplayExhausted`` (503); a drain under load finishes the
in-flight work while new requests get 429 and ``/readyz`` 503;
``DrainTimeout`` past ``drain_timeout``; the SIGTERM handler only sets an
event; a hot-swap between two port checkpoints serves what a fresh
engine on the new one serves, at ``model_version`` 2, with every engine
tensor at its old address and 0 recompiles, on both schedulers; a
``serve_reload`` fault or non-finite weights roll back, and a corrupt
checkpoint answers 409; ``watch_checkpoints`` swaps on its own."""

import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from test_paged import build_engine as jax_paged_engine
from test_serve import tiny_config_dict
from trlx_tpu.data.configs import TRLConfig as JaxConfig
from trlx_tpu.serve import InferenceEngine as JaxEngine
from trlx_tpu.serve import ServeConfig as JaxServe
from trlx_tpu.serve.slots import SlotScheduler as JaxSlotScheduler
from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.transformer import tree_map
from trlx_tpu_torch.serve import (
    InferenceEngine,
    InferenceServer,
    MicroBatcher,
    ServeConfig,
    SlotScheduler,
)
from trlx_tpu_torch.serve.batcher import DrainTimeout, ReplayExhausted
from trlx_tpu_torch.supervisor import RunSupervisor, chaos
from trlx_tpu_torch.utils.aotjit import tree_flatten
from trlx_tpu_torch.utils.checkpoint import save_step_checkpoint

BUCKETS = [[2, 8, 8]]
ROWS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 4, 6], [1, 3, 5, 7],
        [9, 8, 7]]
MAX_NEW = 4


@pytest.fixture(scope="module")
def trees():
    """Two trlx_tpu tiny policies (train seeds 0 and 1) as numpy."""
    out = []
    for seed in (0, 1):
        cfg = tiny_config_dict()
        cfg["train"]["seed"] = seed
        engine = JaxEngine(JaxConfig.from_dict(cfg), serve=JaxServe(
            buckets=BUCKETS, slots=4, page_size=4), init=False)
        out.append(jax.device_get(engine._init_params()))
    return out


@pytest.fixture(scope="module")
def run_dir(trees, tmp_path_factory):
    """A port run directory holding ``step_1`` (seed 0) and ``step_2``
    (seed 1), as the port's trainer writes them."""
    run = str(tmp_path_factory.mktemp("lifecycle") / "run")
    for step, tree in enumerate(trees, 1):
        save_step_checkpoint({"params": tree_map(torch.tensor, tree),
                              "config": tiny_config_dict()}, run, step)
    return run


def serve_cfg(**serve):
    return ServeConfig(**{"buckets": BUCKETS, "max_queue": 64,
                          "request_timeout": 30.0, "slots": 4,
                          "page_size": 4, **serve})


def port_engine(tree, **serve):
    telemetry.start()
    return InferenceEngine(TRLConfig.from_dict(tiny_config_dict()),
                           serve=serve_cfg(**serve), params=tree,
                           device="cpu")


def queue_all(s, rows=ROWS, max_new=MAX_NEW):
    """Every row queued under the scheduler's lock: one admission order."""
    with s._cond:
        return [s.submit(list(r), max_new_tokens=max_new) for r in rows]


def served(s, rows=ROWS, max_new=MAX_NEW):
    reqs = queue_all(s, rows, max_new)
    return [r.wait(timeout=60.0).result for r in reqs]


def live_ptrs(engine):
    return [t.data_ptr() for t in tree_flatten(
        (engine.blocks, engine.embed, engine.ln_f))[0]]


_WANT = {}


def trlx_tpu_tokens(tree):
    """trlx_tpu's slot scheduler on the same weights, no fault."""
    if not _WANT:
        jengine = jax_paged_engine(buckets=BUCKETS)
        jengine._install_params(tree)
        s = JaxSlotScheduler(jengine)
        s.warmup()
        s.start()
        try:
            _WANT["rows"] = served(s)
        finally:
            s.stop()
    return _WANT["rows"]


# --------------------------------------------------------------------- #
# replay: the unit of failure is the step
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("page_size", [3, 8, 16])  # 16 = bucket T_max
def test_replay_greedy_tokens_equal_trlx_tpu_unpoisoned(trees, page_size):
    """Kill the engine mid-prefill, mid-decode (with committed tokens),
    behind a queued backlog, and at the paged prefix match: every request
    completes with trlx_tpu's un-poisoned tokens, nothing leaks, nothing
    recompiles."""
    want = trlx_tpu_tokens(trees[0])
    engine = port_engine(trees[0], page_size=page_size, attention="pallas")
    registry = telemetry.current().registry
    s = SlotScheduler(engine)
    s.warmup()
    s.start()
    try:
        for kill, schedule in [("mid_prefill", "serve_admit:exc@1"),
                               ("mid_decode", "serve_decode:exc@2"),
                               ("queued_backlog", "serve_decode:exc@1"),
                               ("prefix_match", "serve_prefix_match:exc@2")]:
            chaos.configure(schedule)
            reqs = queue_all(s)
            got = [r.wait(timeout=60.0).result for r in reqs]
            chaos.reset()
            assert got == want, f"{kill}/page_size={page_size}"
            assert any(r.replays >= 1 for r in reqs), kill
            stats = s.pool_stats()
            assert s.free_slots() == 4, kill
            assert stats["pages_free"] + stats["pages_cached"] == \
                stats["pages_total"], f"{kill}: leaked pages"
        counters = registry.counters
        assert counters.get("serve/request_errors", 0.0) == 0.0
        assert counters["compile/recompiles"] == 0.0
        assert counters["serve/replays"] >= 4.0
        assert counters["chaos/injections"] == 4.0
    finally:
        chaos.reset()
        s.stop()


def test_replay_exhaustion_and_lattice_overflow(trees):
    """Past ``max_replays`` a request ends with ReplayExhausted (503), as
    does one whose prompt plus committed tokens outgrows the lattice; a
    fault at the ``serve_replay`` seam is a double fault that fails the
    batch; the loop keeps serving."""
    engine = port_engine(trees[0], max_replays=1)
    registry = telemetry.current().registry
    s = SlotScheduler(engine)
    s.warmup()
    s.start()
    try:
        chaos.configure("serve_decode:exc@*")
        r = s.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(ReplayExhausted, match="serve.max_replays"):
            r.wait(timeout=30.0)
        assert r.replays == 2
        chaos.configure("serve_decode:exc@4")  # after 3 committed tokens
        long = s.submit([1, 2, 3, 4, 5, 6], max_new_tokens=8)
        with pytest.raises(ReplayExhausted, match="no longer fit"):
            long.wait(timeout=30.0)
        chaos.configure("serve_decode:exc@1;serve_replay:exc@1")
        doomed = s.submit([1, 2], max_new_tokens=2)
        with pytest.raises(chaos.ChaosError, match="serve_replay"):
            doomed.wait(timeout=30.0)
        chaos.reset()
        assert s.submit([4, 5], max_new_tokens=2).wait(30.0).result
        assert registry.counters["serve/request_errors"] == 3.0
        assert s.free_slots() == 4
    finally:
        chaos.reset()
        s.stop()


def test_a_poisoned_cuda_context_takes_the_abort_path(trees, capsys):
    """A fault that leaves the device unusable (a sticky CUDA error: the
    probe launch after it fails too) is not replayed: the worker flushes
    telemetry and exits 70 through the run supervisor's exit function,
    as the watchdog's abort does. On the CPU the probe is stubbed."""
    codes = []
    s = SlotScheduler(port_engine(trees[0]), run_supervisor=RunSupervisor(
        stall_timeout=0.0, exit_fn=codes.append))
    s._device_poisoned = lambda: True
    s.warmup()
    s.start()
    chaos.configure("serve_decode:exc@1")
    try:
        r = s.submit([1, 2, 3], max_new_tokens=2)
        deadline = time.monotonic() + 30.0
        while not codes and time.monotonic() < deadline:
            time.sleep(0.01)
        assert codes == [70]
        assert "the CUDA context is poisoned" in capsys.readouterr().err
        assert r.replays == 0
    finally:
        chaos.reset()
        s.stop()


# --------------------------------------------------------------------- #
# graceful drain and SIGTERM
# --------------------------------------------------------------------- #


def _burst(srv, rows, max_new=8):
    out = [None] * len(rows)

    def call(i):
        out[i] = srv.http_generate(
            {"tokens": rows[i], "max_new_tokens": max_new}, {})

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(rows))]
    for t in threads:
        t.start()
    return out, threads


def test_drain_under_load(trees):
    """``POST /admin/drain`` mid-burst: 202, ``/readyz`` 503 while
    ``/healthz`` stays 200, a new request 429 with Retry-After, every
    in-flight request finishes 200, the drain is clean and dumps the
    flight recorder."""
    engine = port_engine(trees[0], drain_timeout=15.0)
    registry = telemetry.current().registry
    srv = InferenceServer(engine, port=0).start()
    try:
        assert srv.readyz()[0] == 200
        chaos.configure("serve_decode:slow=0.2@*")  # keep work in flight
        rows = [[1, 2, 3], [4, 5], [6, 7], [8, 9, 1], [2, 2], [3, 1, 4]]
        out, threads = _burst(srv, rows)
        # drain once every request is in the queue: one still on its way
        # would rightly get a 429
        deadline = time.monotonic() + 30.0
        while registry.counters["serve/requests"] < len(rows) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert registry.counters["serve/requests"] == len(rows)
        assert len(srv.scheduler._live) + srv.scheduler.queue_depth() > 0, \
            "the burst finished before the drain"
        code, body = srv.http_drain()
        assert code == 202 and body == {"draining": True,
                                        "drain_timeout": 15.0}
        code, body = srv.readyz()
        assert code == 503 and body["draining"] is True
        assert srv.healthz()[0] == 200
        code, body, headers = srv.http_generate({"tokens": [9, 9]}, {})
        assert code == 429 and "draining" in body["error"]
        assert int(headers["Retry-After"]) >= 1
        for t in threads:
            t.join(timeout=60.0)
        for code, body, _ in out:
            assert code == 200 and len(body["tokens"]) == 8, body
        assert srv._drain_done.wait(timeout=30.0)
        assert srv._drain_clean is True
        assert registry.counters["serve/drains"] == 1.0
        assert registry.counters["serve/flight_dumps"] >= 1.0
        assert registry.counters["serve/request_errors"] == 0.0
    finally:
        chaos.reset()
        srv.stop()


def test_drain_timeout_sheds_with_a_reason(trees):
    """Steps slowed past the drain budget: what is still in flight at the
    deadline ends with DrainTimeout (503), queued work too, and the drain
    reports it; the static path sheds its queue the same way."""
    engine = port_engine(trees[0])
    s = SlotScheduler(engine)
    s.warmup()
    s.start()
    chaos.configure("serve_decode:slow=0.2@*")
    try:
        reqs = queue_all(s, rows=ROWS, max_new=8)
        time.sleep(0.1)
        assert s.drain(timeout=0.3) is False
        for r in reqs:
            with pytest.raises(DrainTimeout, match="drain_timeout"):
                r.wait(timeout=10.0)
    finally:
        chaos.reset()
        s.stop()
    mb = MicroBatcher(engine)  # never started: nothing can finish
    queued = mb.submit([1, 2], max_new_tokens=2)
    assert mb.drain(timeout=0.1) is False
    with pytest.raises(DrainTimeout, match="drain_timeout"):
        queued.wait(timeout=1.0)


def test_sigterm_handler_only_sets_the_event(trees):
    """The handler runs on whatever frame the signal interrupted, so it
    only sets an event — even while the lifecycle lock is held — and
    admission flips at once; the poll loop's half starts the drain."""
    srv = InferenceServer(port_engine(trees[0]), port=0).start()
    try:
        delivered = threading.Event()

        def deliver():
            srv._on_sigterm(signal.SIGTERM, None)
            delivered.set()

        with srv._lifecycle_lock:
            threading.Thread(target=deliver, daemon=True).start()
            assert delivered.wait(timeout=5.0)
            assert srv._drain_requested.is_set()
        with srv._lifecycle_lock:
            assert srv._drain_thread is None
        assert srv.draining is True
        code, body = srv.readyz()
        assert code == 503 and body["draining"] is True
        assert srv.healthz()[0] == 200
        srv.begin_drain()
        srv._drain_requested.clear()
        assert srv._drain_done.wait(timeout=60.0)
        assert srv._drain_clean is True
    finally:
        srv.stop()


# --------------------------------------------------------------------- #
# hot-swap
# --------------------------------------------------------------------- #


def fresh_tokens(run_dir, step, **serve):
    telemetry.start()
    e = InferenceEngine.from_checkpoint(os.path.join(run_dir, step),
                                        serve=serve_cfg(**serve),
                                        device="cpu")
    s = SlotScheduler(e)
    s.warmup()
    s.start()
    try:
        return served(s), e
    finally:
        s.stop()


@pytest.mark.parametrize("weights_dtype", ["bf16", "int8"])
def test_hot_swap_between_port_checkpoints(run_dir, weights_dtype):
    """Serve step_1, reload the run directory (its newest, step_2): the
    engine then holds exactly what a fresh engine on step_2 holds and
    serves its tokens, at model_version 2, every tensor at its old
    address, 0 recompiles. Then a ``serve_reload`` chaos fault answers
    409 and rolls back; the next swap commits."""
    tier = {"weights_dtype": weights_dtype, "attention": "pallas"}
    want2, e2 = fresh_tokens(run_dir, "step_2", **tier)
    want1, _ = fresh_tokens(run_dir, "step_1", **tier)
    telemetry.start()
    engine = InferenceEngine.from_checkpoint(
        os.path.join(run_dir, "step_1"), serve=serve_cfg(**tier),
        device="cpu")
    registry = telemetry.current().registry
    srv = InferenceServer(engine, port=0).start()
    ptrs = live_ptrs(engine)
    try:
        assert served(srv.scheduler) == want1
        code, body = srv.http_reload({})
        assert code == 200, body
        assert body["reloaded"] is True and body["model_version"] == 2
        assert body["checkpoint"].endswith("step_2")
        for a, b in zip(tree_flatten((engine.blocks, engine.embed,
                                      engine.ln_f))[0],
                        tree_flatten((e2.blocks, e2.embed, e2.ln_f))[0]):
            assert torch.equal(a, b)
        assert served(srv.scheduler) == want2
        code, body, _ = srv.http_generate({"tokens": [1, 2]}, {})
        assert code == 200 and body["model_version"] == 2
        assert srv.readyz()[1]["model_version"] == 2

        chaos.configure("serve_reload:exc@1")
        code, body = srv.http_reload(
            {"checkpoint": os.path.join(run_dir, "step_1")})
        chaos.reset()
        assert code == 409 and "ChaosError" in body["reason"]
        assert engine.model_version == 2
        assert served(srv.scheduler) == want2  # rolled back
        code, body = srv.http_reload(
            {"checkpoint": os.path.join(run_dir, "step_1")})
        assert code == 200 and body["model_version"] == 3
        assert served(srv.scheduler) == want1
        assert live_ptrs(engine) == ptrs
        assert registry.counters["compile/recompiles"] == 0.0
        assert registry.counters["serve/reloads"] == 2.0
        assert registry.counters["serve/reload_failures"] == 1.0
        assert registry.gauges["serve/model_version"] == 3
    finally:
        chaos.reset()
        srv.stop()


def test_hot_swap_probe_rollback_static_path_and_refusals(trees, run_dir,
                                                          tmp_path):
    """Non-finite candidate weights fail the probe and roll back (slot
    and static paths alike, the old tokens served again); the static
    path commits a good swap in place; an engine serving its caller's
    own tensors refuses to be swapped; a corrupt checkpoint is a 409."""
    poisoned = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, np.nan, x.dtype)
        if np.issubdtype(x.dtype, np.floating) else x, trees[0])
    for make in (SlotScheduler, MicroBatcher):
        engine = port_engine(trees[0], scheduler="slots"
                             if make is SlotScheduler else "static")
        ptrs = live_ptrs(engine)
        s = make(engine)
        s.warmup()
        s.start()
        try:
            before = s.submit([1, 2, 3], max_new_tokens=3).wait(30).result
            res = s.request_swap(poisoned, label="poisoned")
            assert res["reloaded"] is False and "non-finite" in res["reason"]
            assert engine.model_version == 1
            assert s.submit([1, 2, 3], max_new_tokens=3).wait(30).result \
                == before
            res = s.request_swap(trees[1], label="good")
            assert res == {"reloaded": True, "model_version": 2,
                           "previous_version": 1}
            assert live_ptrs(engine) == ptrs
            assert telemetry.current().registry.counters[
                "compile/recompiles"] == 0.0
        finally:
            s.stop()
    from trlx_tpu_torch.models.params import decode_views_from_numpy

    telemetry.start()
    views = decode_views_from_numpy(trees[0], engine.spec, 1)
    lender = InferenceEngine(TRLConfig.from_dict(tiny_config_dict()),
                             serve=serve_cfg(), views=views, device="cpu")
    with pytest.raises(ValueError, match="caller's own"):
        lender.validate_swap(lender.strip_for_serve(trees[1]))

    import shutil

    bad_run = str(tmp_path / "bad")
    shutil.copytree(run_dir, bad_run)
    with open(os.path.join(bad_run, "step_2", "params.pt"), "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\x00" * 8)
    telemetry.start()
    engine = InferenceEngine.from_checkpoint(
        os.path.join(bad_run, "step_1"), serve=serve_cfg(), device="cpu")
    srv = InferenceServer(engine, port=0).start(warmup=False)
    try:
        code, body = srv.http_reload({})
        assert code == 409 and "checkpoint corrupt" in body["reason"]
        assert engine.model_version == 1
        assert any(".corrupt-" in n for n in os.listdir(bad_run))
        code, body = srv.http_reload({"checkpoint": str(tmp_path / "none")})
        assert code == 400 and "no committed checkpoint" in body["error"]
    finally:
        srv.stop()


def test_cli_lifecycle_flags_layer_over_the_serve_section():
    """The lifecycle flags trlx_tpu's CLI has layer over the config's
    serve section (its mesh flags too, since the serve-mesh slice)."""
    from trlx_tpu_torch.serve.__main__ import (
        build_parser,
        serve_config_from_args,
    )

    args = build_parser().parse_args([
        "--config", "x.json", "--max-queue", "9", "--request-timeout",
        "7", "--stall-timeout", "3", "--slo-ttft-ms", "250",
        "--flight-recorder-steps", "16", "--max-replays", "1",
        "--drain-timeout", "5", "--watch-checkpoints", "0.5",
        "--degrade-step-ms", "40", "--no-request-tracing"])
    cfg = serve_config_from_args(args, {"serve": {"stall_timeout": 60,
                                                  "max_replays": 4}})
    assert (cfg.max_queue, cfg.request_timeout, cfg.stall_timeout,
            cfg.slo_ttft_ms, cfg.flight_recorder_steps, cfg.max_replays,
            cfg.drain_timeout, cfg.watch_checkpoints, cfg.degrade_step_ms,
            cfg.request_tracing) == (9, 7.0, 3.0, 250.0, 16, 1, 5.0, 0.5,
                                     40.0, False)
    args = build_parser().parse_args(["--mesh", "tp=2",
                                      "--mesh-weights", "replicated"])
    assert (args.mesh, args.mesh_weights) == ("tp=2", "replicated")
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--mesh-weights", "sharded"])


def test_watch_checkpoints_swaps_when_latest_moves(trees, tmp_path):
    run = str(tmp_path / "run")
    save_step_checkpoint({"params": tree_map(torch.tensor, trees[0]),
                          "config": tiny_config_dict()}, run, 1)
    telemetry.start()
    engine = InferenceEngine.from_checkpoint(
        run, serve=serve_cfg(watch_checkpoints=0.2), device="cpu")
    srv = InferenceServer(engine, port=0).start()
    try:
        assert engine.model_version == 1
        save_step_checkpoint({"params": tree_map(torch.tensor, trees[1]),
                              "config": tiny_config_dict()}, run, 2)
        deadline = time.monotonic() + 20.0
        while engine.model_version < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert engine.model_version == 2, "the watcher never swapped"
        assert engine.checkpoint_path.endswith("step_2")
        code, body, _ = srv.http_generate({"tokens": [1, 2],
                                           "max_new_tokens": 2}, {})
        assert code == 200 and body["model_version"] == 2
    finally:
        srv.stop()
