"""The port's fleet router (trlx_tpu_torch.router) against trlx_tpu's on
the CPU (tests/test_router.py is the reference's own file): the affinity
index's block math, longest match, feedback decay and LRU cap equal
trlx_tpu's on the same token sequences; ``RouterConfig``'s field set,
defaults and validation messages equal trlx_tpu's; the shared-prefix
rows sent one at a time through trlx_tpu's router over two trlx_tpu
replicas and through the port's router over two port replicas on the
same fp32 weights give identical greedy tokens, the same backend picked
per request and equal affinity hit / miss counts. Then the port's fleet
on its own: the metrics and health surfaces, zero-loss failover on a
killed backend with debounced ejection and re-admission, an all-down
fleet answering 503 at once, a rolling upgrade under load (never below
N-1 admitting, each response equal to its version's direct tokens,
``router/fleet_model_version`` converging), the hop cap's typed 508 with
the hop echoed in the trace, and the ``router_route`` /
``router_probe`` / ``router_rollout`` chaos seams."""

import dataclasses
import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from test_router import PREFIX, ROWS, SERVE, _http
from test_serve import tiny_config_dict
from trlx_tpu import telemetry as jax_telemetry
from trlx_tpu.data.configs import TRLConfig as JaxConfig
from trlx_tpu.router import AffinityIndex as JaxAffinityIndex
from trlx_tpu.router import FleetRouter as JaxRouter
from trlx_tpu.router import RouterConfig as JaxRouterConfig
from trlx_tpu.serve import InferenceEngine as JaxEngine
from trlx_tpu.serve import InferenceServer as JaxServer
from trlx_tpu.serve import ServeConfig as JaxServe
from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.transformer import tree_map
from trlx_tpu_torch.router import AffinityIndex, FleetRouter, RouterConfig
from trlx_tpu_torch.serve import InferenceEngine, InferenceServer, \
    ServeConfig, SlotScheduler
from trlx_tpu_torch.serve.server import MAX_HOPS
from trlx_tpu_torch.supervisor import chaos
from trlx_tpu_torch.utils.checkpoint import save_step_checkpoint

MAX_NEW = 4
#: a second 4-token system prefix, so the least-loaded fallback has a
#: second replica to pick
SECOND = [[9, 8, 7, 6, 5], [9, 8, 7, 6, 1, 2], [9, 8, 7, 6, 3]]
#: routing knobs both routers get: the prober parked after start(), so
#: membership and queue depths move only when a test sweeps
ROUTER = dict(port=0, page_size=SERVE["page_size"], probe_interval=30.0,
              failover_backoff=0.01)


@pytest.fixture(scope="module")
def tree():
    """trlx_tpu's tiny policy (seed 0) as numpy: both fleets' weights."""
    engine = JaxEngine(JaxConfig.from_dict(tiny_config_dict()),
                       serve=JaxServe(**SERVE), init=False)
    return jax.device_get(engine._init_params())


def port_server(tree, port=0):
    engine = InferenceEngine(TRLConfig.from_dict(tiny_config_dict()),
                             serve=ServeConfig(**SERVE), params=tree,
                             device="cpu")
    return InferenceServer(engine, port=port).start(warmup=True)


#: warmed port replicas shared across tests, as tests/test_router.py
#: shares its pool: every test gets a fresh router and telemetry session;
#: a test that kills a pool server revives it in place or leaves it for
#: the next borrow to revive
_POOL = []


def pool(tree, n=2):
    while len(_POOL) < n:
        _POOL.append(port_server(tree))
    for i in range(n):
        if _POOL[i]._httpd is None:  # killed by an earlier test
            _POOL[i] = InferenceServer(_POOL[i].engine,
                                       port=0).start(warmup=True)
    return _POOL[:n]


@pytest.fixture(scope="module", autouse=True)
def _pool_teardown():
    yield
    for s in _POOL:
        s.stop()
    _POOL.clear()


def start_fleet(servers, **overrides):
    telemetry.start()
    return FleetRouter(RouterConfig(**{
        "backends": [f"127.0.0.1:{s.port}" for s in servers],
        **ROUTER, **overrides})).start()


def burst(port, rows, max_new=MAX_NEW):
    out = [None] * len(rows)

    def call(i):
        out[i] = _http(port, "/generate", "POST",
                       {"tokens": rows[i], "max_new_tokens": max_new})

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(rows))]
    for t in threads:
        t.start()
    return out, threads


def direct_tokens(engine, rows, max_new=MAX_NEW):
    """``rows`` through a fresh slot scheduler on ``engine``: the
    direct-engine oracle."""
    s = SlotScheduler(engine)
    s.warmup()
    s.start()
    try:
        with s._cond:
            reqs = [s.submit(list(r), max_new_tokens=max_new) for r in rows]
        return [r.wait(timeout=60.0).result for r in reqs]
    finally:
        s.stop()


# --------------------------------------------------------------------- #
# AffinityIndex and RouterConfig against trlx_tpu's
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("page_size", [1, 4, 16])
def test_affinity_block_math_equals_trlx_tpu(page_size):
    ours, theirs = AffinityIndex(page_size), JaxAffinityIndex(page_size)
    rng = np.random.default_rng(page_size)
    for n in list(range(0, 40)) + [63, 64, 65, 129]:
        tokens = [int(t) for t in rng.integers(0, 257, size=n)]
        assert ours.blocks(tokens) == theirs.blocks(tokens), n
        # the paged pool's rule: (L - 1) // page_size committed blocks
        assert len(ours.blocks(tokens)) == max((n - 1) // page_size, 0)
    assert ours.blocks("system prompt") == theirs.blocks("system prompt")


@pytest.mark.parametrize("max_entries", [6, 64])
def test_affinity_match_decay_lru_equal_trlx_tpu(max_entries):
    """One random sequence of inserts, matches, decays and drops on both
    indexes: every return value and the surviving entries are equal."""
    ours = AffinityIndex(4, max_entries=max_entries)
    theirs = JaxAffinityIndex(4, max_entries=max_entries)
    rng = np.random.default_rng(max_entries)
    prefixes = [[int(t) for t in rng.integers(0, 9, size=8)]
                for _ in range(3)]
    backends = ["A", "B", "C"]
    for step in range(300):
        row = prefixes[int(rng.integers(0, 3))] + [
            int(t) for t in rng.integers(0, 9, size=int(rng.integers(0, 10)))]
        op = int(rng.integers(0, 10))
        b = backends[int(rng.integers(0, 3))]
        if op < 4:
            got = ours.insert(row, b), theirs.insert(row, b)
        elif op < 8:
            banned = backends[int(rng.integers(0, 3))]
            got = (ours.match(row, lambda x: x != banned),
                   theirs.match(row, lambda x: x != banned))
        elif op < 9:
            reported, predicted = (int(rng.integers(0, 3)),
                                   int(rng.integers(0, 5)))
            got = (ours.decay(row, b, reported, predicted),
                   theirs.decay(row, b, reported, predicted))
        else:
            got = ours.drop_backend(b), theirs.drop_backend(b)
        assert got[0] == got[1], (step, op, got)
        assert ours._entries == theirs._entries, step
        assert len(ours) <= max(max_entries, 1) + 12
    assert len(ours) == len(theirs) > 0


def test_affinity_longest_match_decay_and_lru_cap():
    idx = AffinityIndex(page_size=4)
    long_row = list(range(17))  # 4 committed blocks
    assert idx.insert(long_row, "A") == 4
    assert idx.match(long_row, lambda x: True) == ("A", 4)
    assert idx.match(list(range(9)), lambda x: True) == ("A", 2)
    assert idx.match(long_row, lambda x: x != "A") == (None, 0)
    assert idx.decay(long_row, "A", reported_blocks=1,
                     predicted_blocks=4) == 3
    assert idx.match(long_row, lambda x: True) == ("A", 1)
    capped = AffinityIndex(page_size=2, max_entries=8)
    for i in range(20):
        capped.insert([i, i, i, i, i], f"b{i}")
    assert len(capped) <= 8


def test_router_config_fields_and_defaults_equal_trlx_tpu():
    ours = {f.name: f for f in dataclasses.fields(RouterConfig)}
    theirs = {f.name: f for f in dataclasses.fields(JaxRouterConfig)}
    assert list(ours) == list(theirs)
    a = RouterConfig(backends=["x:1"])
    b = JaxRouterConfig(backends=["x:1"])
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    cfg = RouterConfig.from_dict({"backends": ["127.0.0.1:8081"],
                                  "page_size": 16, "not_a_knob": True})
    assert cfg.page_size == 16


BAD_CONFIGS = [
    dict(backends=[]),
    dict(page_size=0),
    dict(probe_interval=0.0),
    dict(failover_retries=-1),
    dict(probe_failures_threshold=0),
    dict(breaker_threshold=2, breaker_cooldown=0.0),
    dict(retry_budget=4.0, retry_budget_refill=-1.0),
    dict(hedge_after_s=-0.1),
    dict(trace_ring=-1),
    dict(access_log_sample=0),
    dict(access_log_max_mb=0.0),
    dict(slo_target=1.0),
    dict(shed_pressure_threshold=1.5),
    dict(tenants={"a": 3}),
    dict(tenants={"a": {"rps": 1, "bogus": 2}}),
]


@pytest.mark.parametrize("bad", BAD_CONFIGS,
                         ids=[next(iter(b)) + str(i)
                              for i, b in enumerate(BAD_CONFIGS)])
def test_router_config_refusals_equal_trlx_tpu(bad):
    kwargs = {"backends": ["x:1"], **bad}
    with pytest.raises(ValueError) as ours:
        RouterConfig(**kwargs)
    with pytest.raises(ValueError) as theirs:
        JaxRouterConfig(**kwargs)
    assert str(ours.value) == str(theirs.value)


def test_prober_and_route_handlers_share_the_affinity_lock():
    """The prober's ejection (drop_backend walks the entry dict) against
    the route handlers' match / insert / decay from several threads: no
    torn entry, no 'dictionary changed size during iteration'."""
    telemetry.start()
    router = FleetRouter(RouterConfig(
        backends=["127.0.0.1:1", "127.0.0.1:2"], port=0, page_size=2,
        probe_failures_threshold=1))
    b1, b2 = router.backends
    for b in router.backends:
        b.admitted = b.ever_admitted = True
    rows = [[i] * 9 for i in range(8)]
    errors = []

    def prober():
        try:
            for i in range(200):
                router._apply_probe(b2, i % 2 == 1, 1, {"queue_depth": 0})
        except Exception as e:  # pragma: no cover - the regression
            errors.append(e)

    def handler(seed):
        try:
            for i in range(300):
                key = rows[(i + seed) % len(rows)]
                backend, depth, how = router._pick(key, exclude=())
                if backend is not None:
                    router._note_routed(backend, key, depth, how, 200,
                                        {"trace": {"prefix_blocks_hit": 1}})
                    router.fleet_state()
        except Exception as e:  # pragma: no cover - the regression
            errors.append(e)

    threads = [threading.Thread(target=prober, daemon=True)] + [
        threading.Thread(target=handler, args=(s,), daemon=True)
        for s in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads), "drill wedged"
    assert not errors, errors
    with router._lock:
        owners = {id(v[0]) for v in router.affinity._entries.values()}
    assert owners <= {id(b1), id(b2)}
    telemetry.start()


# --------------------------------------------------------------------- #
# the fleet against trlx_tpu's fleet on the same weights
# --------------------------------------------------------------------- #


def test_shared_prefix_rows_equal_trlx_tpu_fleet(tree):
    """The 8 shared-prefix rows (then 3 on a second prefix), one at a
    time through each package's router over two replicas of its own:
    identical greedy tokens, the same backend index picked per request,
    the same prefix blocks hit, equal affinity hit / miss counts."""
    jax_telemetry.start()
    jax_servers = [JaxServer(JaxEngine(
        JaxConfig.from_dict(tiny_config_dict()), serve=JaxServe(**SERVE),
        params=tree), port=0).start(warmup=True) for _ in range(2)]
    jax_router = None
    servers = pool(tree)
    router = start_fleet(servers)
    try:
        jax_router = JaxRouter(JaxRouterConfig(
            backends=[f"127.0.0.1:{s.port}" for s in jax_servers],
            **ROUTER)).start()
        for i, row in enumerate(ROWS + SECOND):
            picks = []
            for r, rport in ((jax_router, jax_router.port),
                             (router, router.port)):
                before = [b.requests for b in r.backends]
                status, headers, body = _http(
                    rport, "/generate", "POST",
                    {"tokens": row, "max_new_tokens": MAX_NEW,
                     "trace": True})
                assert status == 200, body
                assert headers.get("X-Request-Id") == body["trace_id"]
                after = [b.requests for b in r.backends]
                picks.append(([a - b for a, b in zip(after, before)]
                              .index(1), body["tokens"],
                              body["trace"]["prefix_blocks_hit"]))
            assert picks[0] == picks[1], (i, row, picks)
        ours = telemetry.current().registry.counters
        theirs = jax_telemetry.current().registry.counters
        for name in ("router/affinity_hits", "router/affinity_misses",
                     "router/requests", "router/responses",
                     "router/failovers", "router/affinity_decays"):
            assert ours[name] == theirs[name], name
        assert ours["router/affinity_hits"] >= len(ROWS) - 1
        assert ours["router/affinity_misses"] == 2  # one per prefix
        gauges = telemetry.current().registry.gauges
        assert gauges["router/affinity_hit_rate"] == pytest.approx(
            jax_telemetry.current().registry.gauges[
                "router/affinity_hit_rate"])
        assert ours["serve/prefix_tokens_saved"] >= 1.0
        assert ours.get("compile/recompiles", 0.0) == 0.0
    finally:
        router.stop()
        if jax_router is not None:
            jax_router.stop()
        for s in jax_servers:
            s.stop()
        jax_telemetry.start()
        telemetry.start()


def test_router_metrics_and_health_surfaces(tree):
    router = start_fleet(pool(tree))
    try:
        status, _, body = _http(router.port, "/healthz")
        assert status == 200 and body["admitting"] == 2
        assert len(body["backends"]) == 2
        assert body["backends"][0]["breaker"] == "closed"
        status, _, body = _http(router.port, "/readyz")
        assert status == 200 and body["ready"] is True
        assert body["fleet_size"] == 2
        status, _, metrics = _http(router.port, "/metrics")
        assert metrics["counters"]["router/requests"] == 0.0
        assert metrics["counters"]["router/breaker_opens"] == 0.0
        assert metrics["gauges"]["router/fleet_size"] == 2.0
        assert metrics["gauges"]["router/fleet_model_version"] == 1.0
        assert metrics["gauges"]["router/retry_budget_tokens"] == 16.0
        req = urllib.request.Request(
            f"http://127.0.0.1:{router.port}/metrics",
            headers={"Accept": "text/plain"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            text = resp.read().decode()
            assert resp.headers["Content-Type"].startswith("text/plain")
        assert "router_requests" in text and "router_fleet_size" in text
        status, _, body = _http(router.port, "/nope")
        assert status == 404 and "/admin/rollout" in body["error"]
        status, _, body = _http(router.port, "/nope", "POST", {})
        assert status == 404
    finally:
        router.stop()
        telemetry.start()


# --------------------------------------------------------------------- #
# failover, an empty fleet, the rolling upgrade
# --------------------------------------------------------------------- #


def test_failover_zero_loss_on_killed_backend(tree):
    servers = pool(tree)
    router = start_fleet(servers, failover_retries=1)
    registry = telemetry.current().registry
    try:
        want = direct_tokens(servers[0].engine, ROWS)
        for row in ROWS[:4]:  # the shared prefix lands on one replica
            status, _, body = _http(router.port, "/generate", "POST",
                                    {"tokens": row,
                                     "max_new_tokens": MAX_NEW})
            assert status == 200, body
        owner_url = max(router.fleet_state()["backends"],
                        key=lambda b: b["requests"])["url"]
        victim = next(s for s in servers
                      if owner_url.endswith(f":{s.port}"))
        victim_port = victim.port
        victim.stop()  # the kill: connection refused from here on
        out, threads = burst(router.port, ROWS)
        for t in threads:
            t.join(timeout=90.0)
        for i, (status, _, body) in enumerate(out):
            assert status == 200, f"request {i} lost in failover: {body}"
            assert body["tokens"] == want[i], i
        router.probe_fleet()
        assert router.admitting_count() == 2, "debounced: one sweep"
        router.probe_fleet()
        assert router.admitting_count() == 1
        assert registry.counters["router/ejections"] >= 1.0
        status, _, _ = _http(router.port, "/readyz")
        assert status == 200, "one dead replica must not unready the fleet"
        revived = InferenceServer(victim.engine,
                                  port=victim_port).start(warmup=True)
        _POOL[_POOL.index(victim)] = revived
        router.probe_fleet()
        assert router.admitting_count() == 2
        assert registry.counters["router/readmissions"] >= 1.0
        assert registry.counters["router/failovers"] >= 1.0
        assert registry.counters["router/retry_budget_spent"] == \
            registry.counters["router/failovers"]
        assert registry.counters.get("compile/recompiles", 0.0) == 0.0
    finally:
        router.stop()
        telemetry.start()


def test_all_backends_down_is_503_not_a_hang():
    telemetry.start()
    router = FleetRouter(RouterConfig(
        backends=["127.0.0.1:9"], port=0, page_size=4,
        probe_interval=30.0, probe_timeout=2.0, request_timeout=10.0,
        failover_retries=1, failover_backoff=0.01)).start()
    try:
        status, headers, body = _http(router.port, "/generate", "POST",
                                      {"tokens": [1, 2],
                                       "max_new_tokens": 1})
        assert status == 503
        assert "no admitting replica" in body["error"]
        assert int(headers["Retry-After"]) >= 1
        status, _, _ = _http(router.port, "/readyz")
        assert status == 503, "an empty fleet must not report ready"
    finally:
        router.stop()
        telemetry.start()


def test_rolling_upgrade_under_load(tree, tmp_path):
    """``POST /admin/rollout`` walks two checkpoint-backed port replicas
    while traffic flows: zero lost requests, never below N-1 admitting,
    every response equal to its version's direct tokens, and
    ``router/fleet_model_version`` converging on 2."""
    run = str(tmp_path / "run")
    negated = jax.tree_util.tree_map(
        lambda x: -x if np.issubdtype(np.asarray(x).dtype, np.floating)
        else x, tree)
    for step, t in ((1, tree), (2, negated)):
        save_step_checkpoint({"params": tree_map(torch.tensor, t),
                              "config": tiny_config_dict()}, run, step)
    step1 = os.path.join(run, "step_1")
    telemetry.start()
    servers = [InferenceServer(InferenceEngine.from_checkpoint(
        step1, serve=ServeConfig(**SERVE), device="cpu"),
        port=0).start(warmup=True) for _ in range(2)]
    router = None
    try:
        router = start_fleet(servers, rollout_timeout=60.0)
        registry = telemetry.current().registry
        row = ROWS[0]
        oracle = {1: direct_tokens(servers[0].engine, [row])[0]}
        results, done = [], threading.Event()
        min_admitting = [len(servers)]

        def traffic():
            while not done.is_set():
                results.append(_http(router.port, "/generate", "POST",
                                     {"tokens": row,
                                      "max_new_tokens": MAX_NEW}))
                min_admitting[0] = min(min_admitting[0],
                                       router.admitting_count())

        t = threading.Thread(target=traffic)
        t.start()
        try:
            status, _, body = _http(router.port, "/admin/rollout",
                                    "POST", {})
        finally:
            done.set()
            t.join(timeout=90.0)
        assert status == 200, body
        assert body["ok"] is True
        assert [s["model_version"] for s in body["steps"]] == [2, 2]
        assert min_admitting[0] >= len(servers) - 1
        oracle[2] = direct_tokens(servers[0].engine, [row])[0]
        assert oracle[2] != oracle[1], "step_2 must actually differ"
        assert results, "the traffic thread never completed a request"
        for status, _, body in results:
            assert status == 200, f"request lost mid-rollout: {body}"
            assert body["tokens"] == oracle[body["model_version"]]
        status, _, metrics = _http(router.port, "/metrics")
        assert metrics["gauges"]["router/fleet_model_version"] == 2.0
        assert metrics["counters"]["router/rollout_steps"] == 2.0
        assert metrics["counters"]["router/rollout_aborts"] == 0.0
        assert metrics["counters"].get("compile/recompiles", 0.0) == 0.0
        assert registry.gauges["router/rollout_in_progress"] == 0.0
        # one rollout at a time
        assert router._rollout_lock.acquire(blocking=False)
        try:
            busy = router.rollout()
        finally:
            router._rollout_lock.release()
        assert busy == {"ok": False, "reason": "a rollout is already in "
                                               "progress (one at a time)"}
    finally:
        if router is not None:
            router.stop()
        for s in servers:
            s.stop()
        telemetry.start()


# --------------------------------------------------------------------- #
# the hop cap and the router's chaos seams
# --------------------------------------------------------------------- #


def test_hop_count_cap_and_trace_echo(tree):
    servers = pool(tree, 1)
    router = start_fleet(servers)
    try:
        port = servers[0].port
        status, _, body = _http(port, "/generate", "POST",
                                {"tokens": [1, 2], "max_new_tokens": 1},
                                headers={"X-Hop-Count": str(MAX_HOPS + 1)})
        assert status == 508 and "hop" in body["error"].lower()
        status, _, body = _http(router.port, "/generate", "POST",
                                {"tokens": [1, 2], "max_new_tokens": 1,
                                 "trace": True})
        assert status == 200 and body["trace"]["hops"] == 1
        status, _, body = _http(router.port, "/generate", "POST",
                                {"tokens": [1, 2], "max_new_tokens": 1})
        assert status == 200 and "trace" not in body, (
            "the router strips the trace the client did not ask for")
        # at the cap the BACKEND overflows and the 508 passes through
        status, _, body = _http(router.port, "/generate", "POST",
                                {"tokens": [1, 2], "max_new_tokens": 1},
                                headers={"X-Hop-Count": str(MAX_HOPS)})
        assert status == 508
        status, _, body = _http(router.port, "/generate", "POST",
                                {"tokens": [1, 2]},
                                headers={"X-Hop-Count": "banana"})
        assert status == 400
        registry = telemetry.current().registry
        assert registry.counters["serve/hop_limit_rejects"] >= 2.0
        assert registry.counters["router/failovers"] == 0.0
    finally:
        router.stop()
        telemetry.start()


def test_chaos_router_route_surfaces_500_then_recovers(tree):
    router = start_fleet(pool(tree))
    registry = telemetry.current().registry
    chaos.configure("router_route:exc@1")
    try:
        status, _, body = _http(router.port, "/generate", "POST",
                                {"tokens": [1, 2], "max_new_tokens": 1})
        assert status == 500 and "ChaosError" in body["error"]
        assert registry.counters["router/request_errors"] == 1.0
        assert registry.counters["router/failovers"] == 0.0
        status, _, body = _http(router.port, "/generate", "POST",
                                {"tokens": [1, 2], "max_new_tokens": 1})
        assert status == 200, body
    finally:
        chaos.reset()
        router.stop()
        telemetry.start()


def test_chaos_router_probe_leaves_membership_untouched(tree):
    router = start_fleet(pool(tree))
    try:
        assert router.admitting_count() == 2
        chaos.configure("router_probe:exc@1")
        with pytest.raises(chaos.ChaosError):
            router.probe_fleet()
        assert router.admitting_count() == 2
        router.probe_fleet()
        assert router.admitting_count() == 2
    finally:
        chaos.reset()
        router.stop()
        telemetry.start()


def test_chaos_router_rollout_aborts_and_readmits(tree):
    router = start_fleet(pool(tree))
    registry = telemetry.current().registry
    chaos.configure("router_rollout:exc@1")
    try:
        status, _, body = _http(router.port, "/admin/rollout", "POST", {})
        assert status == 409
        assert body["ok"] is False and "ChaosError" in str(body)
        assert body["aborted_at"] == router.backends[0].url
        assert registry.counters["router/rollout_aborts"] == 1.0
        assert router.admitting_count() == 2
        with router._lock:
            assert all(b.model_version == 1 for b in router.backends)
        status, _, body = _http(router.port, "/generate", "POST",
                                {"tokens": PREFIX, "max_new_tokens": 1})
        assert status == 200, body
    finally:
        chaos.reset()
        router.stop()
        telemetry.start()


# --------------------------------------------------------------------- #
# the CLI: python -m trlx_tpu_torch.router
# --------------------------------------------------------------------- #


def test_cli_flags_equal_trlx_tpu():
    from trlx_tpu.router.__main__ import build_parser as jax_parser
    from trlx_tpu_torch.router.__main__ import build_parser

    def flags(parser):
        return [(a.option_strings, a.dest, a.default, a.type)
                for a in parser._actions]

    assert flags(build_parser()) == flags(jax_parser())


@pytest.mark.parametrize("argv", [
    ["--backends", "a:1, b:2,"],
    ["--backends", "a:1", "--page-size", "16", "--hedge-after", "0.25",
     "--retry-budget", "0", "--access-log", "x.jsonl",
     "--access-log-sample", "3", "--slo-target", "0.9",
     "--tenants", '{"premium": {"rps": 2, "burst": 4, "priority": 10}}',
     "--shed-pressure-threshold", "0.5", "--probe-failures-threshold", "3",
     "--breaker-threshold", "0", "--stall-timeout", "30"],
    ["--config", "CONFIG", "--port", "9000", "--breaker-cooldown", "7"],
], ids=["backends", "every-flag", "config"])
def test_router_config_from_args_equals_trlx_tpu(tmp_path, argv):
    from trlx_tpu.router.__main__ import build_parser as jax_parser
    from trlx_tpu.router.__main__ import \
        router_config_from_args as jax_config
    from trlx_tpu_torch.router.__main__ import (
        build_parser,
        router_config_from_args,
    )

    section = {"backends": ["10.0.0.1:8081", "10.0.0.2:8081"],
               "page_size": 32, "probe_interval": 0.25,
               "tenants": {"default": {"priority": 0}}, "unknown": 1}
    yml = tmp_path / "cfg.yml"
    yml.write_text(json.dumps({"router": section, "train": {}}))
    argv = [str(yml) if a == "CONFIG" else a for a in argv]
    ours = router_config_from_args(build_parser().parse_args(argv))
    theirs = jax_config(jax_parser().parse_args(argv))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    if "--config" in argv:  # the port also takes the section from JSON
        js = tmp_path / "cfg.json"
        js.write_text(yml.read_text())
        argv = [str(js) if a == str(yml) else a for a in argv]
        assert dataclasses.asdict(router_config_from_args(
            build_parser().parse_args(argv))) == dataclasses.asdict(theirs)


def test_router_cli_fronts_port_replicas(tree):
    """``python -m trlx_tpu_torch.router --backends ...`` as a program in
    front of two pool replicas: ready, routes a request, counts it."""
    import signal
    import socket
    import subprocess
    import sys
    import time

    servers = pool(tree)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "trlx_tpu_torch.router", "--backends",
         ",".join(f"127.0.0.1:{s.port}" for s in servers), "--port",
         str(port), "--page-size", str(SERVE["page_size"])],
        cwd=repo, env={**os.environ, "PYTHONPATH": repo},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60
        status = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                status, _, body = _http(port, "/readyz")
                if status == 200:
                    break
            except OSError:
                time.sleep(0.1)
        assert status == 200 and body["admitting"] == 2, proc.poll()
        status, _, body = _http(port, "/generate", "POST",
                                {"tokens": ROWS[0], "max_new_tokens": 2})
        assert status == 200 and len(body["tokens"]) == 2, body
        status, _, metrics = _http(port, "/metrics")
        assert metrics["counters"]["router/requests"] == 1.0
        assert metrics["gauges"]["router/fleet_size"] == 2.0
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out
    assert "[trlx_tpu_torch.router] routing http://127.0.0.1:" in out
    assert "interrupted; stopping" in out
