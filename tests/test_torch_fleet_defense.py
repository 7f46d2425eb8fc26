"""The port's fleet containment against trlx_tpu's on the CPU
(tests/test_defense.py and the router half of tests/test_overload.py are
the reference's own): the circuit breaker, retry budget and latency
window driven with the same time arguments through both packages give
equal state sequences; the prober's debounce; and each router defense
over scriptable stub replicas, run through both packages' routers on the
same stubs with equal answers and counters: the breaker opening on
request failures and recovering through one half-open trial, the typed
503 of an exhausted retry budget and of a tenant's slice, the edge shed
under fleet pressure, hedging with the first response winning, the
``router_hedge`` chaos seam, and malformed, garbage and truncated 200
bodies failing over. Last, the repaired ``checkpoint_verify`` seam: an
injected failure quarantines a port checkpoint as trlx_tpu's does, and
aborts a rolling upgrade of a port fleet with the old version kept."""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from test_defense import _StubReplica
from test_router import ROWS, SERVE, _http
from test_serve import tiny_config_dict
from trlx_tpu import telemetry as jax_telemetry
from trlx_tpu.router import FleetRouter as JaxRouter
from trlx_tpu.router import RouterConfig as JaxRouterConfig
from trlx_tpu.router import resilience as jax_resilience
from trlx_tpu.supervisor import chaos as jax_chaos
from trlx_tpu_torch import telemetry
from trlx_tpu_torch.models.transformer import tree_map
from trlx_tpu_torch.router import FleetRouter, RouterConfig, resilience
from trlx_tpu_torch.router.resilience import CircuitBreaker
from trlx_tpu_torch.serve import InferenceEngine, InferenceServer, \
    ServeConfig
from trlx_tpu_torch.supervisor import chaos
from trlx_tpu_torch.utils.checkpoint import (
    MANIFEST_KEY,
    META_NAME,
    CheckpointCorrupt,
    build_manifest,
    save_step_checkpoint,
    verify_checkpoint,
    verify_or_quarantine,
)

#: (router class, config class, telemetry module, chaos module) per
#: package: each stub drill runs through both
PACKAGES = {
    "port": (FleetRouter, RouterConfig, telemetry, chaos),
    "trlx_tpu": (JaxRouter, JaxRouterConfig, jax_telemetry, jax_chaos),
}


def router_over(pkg, stubs, **overrides):
    """A started router of ``pkg`` over ``stubs`` with a fresh telemetry
    session and the prober parked."""
    router_cls, config_cls, tel, _ = PACKAGES[pkg]
    tel.start()
    cfg = dict(backends=[f"127.0.0.1:{s.port}" for s in stubs], port=0,
               page_size=64, probe_interval=30.0, probe_timeout=5.0,
               request_timeout=10.0, failover_backoff=0.01)
    cfg.update(overrides)
    return router_cls(config_cls(**cfg)).start()


def router_counters(pkg):
    counters = PACKAGES[pkg][2].current().registry.counters
    return {k: v for k, v in counters.items() if k.startswith("router/")}


def both(drill, *args):
    """``drill(pkg, *args)`` through each package; the two results, which
    must be equal."""
    out = {}
    for pkg in PACKAGES:
        try:
            out[pkg] = drill(pkg, *args)
        finally:
            PACKAGES[pkg][3].reset()
            PACKAGES[pkg][2].start()
    assert out["port"] == out["trlx_tpu"], out
    return out["port"]


@pytest.fixture
def stub_pair():
    stubs = [_StubReplica(), _StubReplica()]
    yield stubs
    for s in stubs:
        s.stop()


# --------------------------------------------------------------------- #
# the state machines, time passed by argument
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("threshold,cooldown", [(0, 0.0), (1, 0.5),
                                                (3, 1.0)])
def test_circuit_breaker_sequence_equals_trlx_tpu(threshold, cooldown):
    ours = resilience.CircuitBreaker(threshold, cooldown)
    theirs = jax_resilience.CircuitBreaker(threshold, cooldown)
    rng = np.random.default_rng(threshold)
    now = 0.0
    for step in range(400):
        now += float(rng.exponential(0.2))
        op = int(rng.integers(0, 5))
        call = ("allow", "begin_trial", "record_success",
                "record_failure", "reset")[op]
        args = () if op in (2, 4) else (now,)
        got = (getattr(ours, call)(*args), getattr(theirs, call)(*args))
        assert got[0] == got[1], (step, call, got)
        assert (ours.state, ours.failures, ours.opened_at) == \
            (theirs.state, theirs.failures, theirs.opened_at), step


@pytest.mark.parametrize("capacity,refill", [(0.0, 0.0), (2.0, 1.0),
                                             (5.0, 0.25)])
def test_retry_budget_sequence_equals_trlx_tpu(capacity, refill):
    ours = resilience.RetryBudget(capacity, refill)
    theirs = jax_resilience.RetryBudget(capacity, refill)
    rng = np.random.default_rng(int(capacity))
    now = 0.0
    for step in range(300):
        now += float(rng.exponential(0.3))
        if rng.integers(0, 3):
            cost = float(rng.choice([0.5, 1.0, 2.0]))
            got = ours.try_spend(now, cost), theirs.try_spend(now, cost)
        else:
            got = ours.available(now), theirs.available(now)
        assert got[0] == got[1], (step, got)
        assert ours.tokens == theirs.tokens, step


@pytest.mark.parametrize("size,min_samples", [(16, 8), (128, 8), (4, 1)])
def test_latency_window_sequence_equals_trlx_tpu(size, min_samples):
    ours = resilience.LatencyWindow(size, min_samples)
    theirs = jax_resilience.LatencyWindow(size, min_samples)
    rng = np.random.default_rng(size)
    for step in range(200):
        sample = float(rng.lognormal(-3.0, 1.0))
        ours.add(sample)
        theirs.add(sample)
        assert (ours.p95(), len(ours)) == (theirs.p95(), len(theirs)), step


def test_circuit_breaker_state_machine():
    br = CircuitBreaker(threshold=2, cooldown=1.0)
    assert br.state == CircuitBreaker.CLOSED and br.allow(0.0)
    assert br.record_failure(0.0) is False
    assert br.record_success() is False
    assert br.record_failure(0.2) is False
    assert br.record_failure(0.3) is True
    assert br.state == CircuitBreaker.OPEN
    assert not br.allow(0.5), "open inside cooldown must refuse"
    assert br.allow(1.4) and br.state == CircuitBreaker.OPEN  # pure
    assert br.begin_trial(1.4) is True
    assert br.state == CircuitBreaker.HALF_OPEN
    assert not br.allow(1.5) and br.begin_trial(1.5) is False
    assert br.record_failure(1.6) is True  # one chance per cooldown
    assert br.begin_trial(2.7) is True
    assert br.record_success() is True
    assert br.state == CircuitBreaker.CLOSED and br.failures == 0


def debounce_drill(pkg):
    router_cls, config_cls, tel, _ = PACKAGES[pkg]
    tel.start()
    router = router_cls(config_cls(backends=["127.0.0.1:1"], port=0,
                                   page_size=4, probe_failures_threshold=2))
    (b,) = router.backends
    b.admitted = b.ever_admitted = True
    seen = []
    for ready, version, state in [
            (False, 0, {"probe_error": "timeout"}),
            (True, 1, {"queue_depth": 3, "degraded": True}),
            (False, 0, {}), (False, 0, {}), (False, 0, {}),
            (True, 2, {"queue_depth": 0,
                       "pressure": {"brownout": True}})]:
        if version == 2:  # the restarted replica's breaker is reset
            for _ in range(3):
                b.breaker.record_failure(0.0)
            seen.append(b.breaker.state)
        router._apply_probe(b, ready, version, state)
        seen.append((b.admitted, b.probe_failures, b.queue_depth,
                     b.degraded, b.model_version, b.pressure,
                     b.breaker.state))
    router._update_fleet_gauges()
    gauges = tel.current().registry.gauges
    return seen, router_counters(pkg), {
        k: gauges[k] for k in ("router/admitting",
                               "router/pressured_backends",
                               "router/fleet_model_version")}


def test_probe_debounce_equals_trlx_tpu():
    seen, counters, gauges = both(debounce_drill)
    assert seen[0][0] is True, "one failed sweep must not eject"
    assert seen[3][0] is False, "the second consecutive failure ejects"
    assert seen[-2] == CircuitBreaker.OPEN
    assert seen[-1][0] is True and seen[-1][-1] == CircuitBreaker.CLOSED
    assert counters["router/ejections"] == 1.0
    assert counters["router/readmissions"] == 1.0
    assert gauges == {"router/admitting": 1.0,
                      "router/pressured_backends": 1.0,
                      "router/fleet_model_version": 2.0}


# --------------------------------------------------------------------- #
# the defenses over stub replicas, both packages
# --------------------------------------------------------------------- #


def breaker_drill(pkg, stubs):
    sick, healthy = stubs
    sick.mode, healthy.mode = "e503", "ok"
    router = router_over(pkg, stubs, breaker_threshold=2,
                         breaker_cooldown=0.3, failover_retries=2)
    try:
        body = {"tokens": [1, 2, 3], "max_new_tokens": 1}
        statuses = [router.forward(dict(body))[0] for _ in range(2)]
        (sick_b,) = [b for b in router.backends
                     if b.url.endswith(f":{sick.port}")]
        opened = (sick_b.breaker.state, sick_b.admitted)
        before = router_counters(pkg)["router/failovers"]
        statuses.append(router.forward(dict(body))[0])
        gated = router_counters(pkg)["router/failovers"] - before
        sick.mode = "ok"
        time.sleep(0.35)
        statuses.append(router.forward(dict(body))[0])
        return (statuses, opened, gated, sick_b.breaker.state,
                router_counters(pkg))
    finally:
        router.stop()


def test_breaker_opens_on_request_failures_then_half_open_recovers(
        stub_pair):
    statuses, opened, gated, state, counters = both(breaker_drill,
                                                     stub_pair)
    assert statuses == [200] * 4
    assert opened == (CircuitBreaker.OPEN, True), (
        "the breaker must not touch prober membership")
    assert gated == 0, "an open breaker takes the replica out of picks"
    assert state == CircuitBreaker.CLOSED
    assert counters["router/breaker_opens"] == 1.0
    assert counters["router/breaker_half_opens"] == 1.0
    assert counters["router/breaker_closes"] == 1.0


def budget_drill(pkg, stubs):
    for s in stubs:
        s.mode = "e503"
    router = router_over(pkg, stubs, breaker_threshold=0,
                         retry_budget=1.0, retry_budget_refill=0.0,
                         failover_retries=5)
    try:
        out = router.forward({"tokens": [1, 2], "max_new_tokens": 1})
        gauges = PACKAGES[pkg][2].current().registry.gauges
        return out, router_counters(pkg), \
            gauges["router/retry_budget_tokens"]
    finally:
        router.stop()


def test_retry_budget_exhausted_is_typed_503(stub_pair):
    (status, payload, headers), counters, tokens = both(budget_drill,
                                                        stub_pair)
    assert status == 503 and payload["retry_budget_exhausted"] is True
    assert "router retry budget exhausted" in payload["error"]
    assert int(headers["Retry-After"]) >= 1
    assert counters["router/retry_budget_spent"] == 1.0
    assert counters["router/retry_budget_exhausted"] == 1.0
    assert counters["router/failovers"] == 1.0
    assert tokens == 0.0


def tenant_drill(pkg, stubs):
    for s in stubs:
        s.mode = "e503"
    router = router_over(pkg, stubs, breaker_threshold=0,
                         failover_retries=5, retry_budget=16.0,
                         retry_budget_refill=2.0,
                         tenants={"aggressor": {"rps": 0.5, "burst": 1}})
    try:
        first = router.forward({"tokens": [1, 2], "max_new_tokens": 1,
                                "tenant": "aggressor"})
        second = router.forward({"tokens": [3], "max_new_tokens": 1,
                                 "tenant": "premium"})
        return first, second[0], router_counters(pkg)
    finally:
        router.stop()


def test_tenant_budget_slice_exhausts_before_fleet(stub_pair):
    (status, payload, headers), second, counters = both(tenant_drill,
                                                        stub_pair)
    assert status == 503 and payload["tenant"] == "aggressor"
    assert "tenant 'aggressor'" in payload["error"]
    assert headers["Retry-After"] == "2", "1 token at 0.5 rps"
    assert counters["router/tenant_budget_exhausted{tenant=aggressor}"] \
        == 1.0
    assert counters["router/retry_budget_exhausted"] == 0.0
    assert second == 503
    assert counters["router/retry_budget_spent{tenant=premium}"] >= 2.0


def shed_drill(pkg):
    router_cls, config_cls, tel, _ = PACKAGES[pkg]
    tel.start()
    router = router_cls(config_cls(
        backends=["127.0.0.1:1", "127.0.0.1:2"], port=0, page_size=4,
        tenants={"premium": {"priority": 1}, "default": {"priority": 0}},
        shed_pressure_threshold=1.0))
    b1, b2 = router.backends
    for b in (b1, b2):
        b.admitted = True
    pressured = {"queue_depth": 9, "pressure": {
        "degraded": True, "brownout": True, "retry_after_s": 7}}
    router._apply_probe(b1, True, 1, pressured)
    half = router._shed_for_pressure("default")
    router._apply_probe(b2, True, 1, {**pressured, "pressure": {
        "brownout": True, "retry_after_s": 11}})
    shed = router.forward({"tokens": [1], "max_new_tokens": 1})
    premium = router._shed_for_pressure("premium")
    router._apply_probe(b1, True, 1, {"pressure": {"degraded": False}})
    return half, shed, premium, router._shed_for_pressure("default"), \
        router_counters(pkg)


def test_router_sheds_best_effort_under_fleet_pressure():
    half, (status, payload, headers), premium, cleared, counters = both(
        shed_drill)
    assert half is None, "1 of 2 pressured < threshold 1.0"
    assert status == 429 and payload["shed_pressure"] is True
    assert headers["Retry-After"] == "11", "the worst replica's pacing"
    assert premium is None and cleared is None
    assert counters["router/shed_pressure{tenant=default}"] == 1.0
    assert counters.get("router/request_errors", 0.0) == 0.0


def hedge_drill(pkg, chaos_spec):
    slow = _StubReplica(mode="slow", delay=0.6)
    fast = _StubReplica()
    router = router_over(pkg, [slow, fast], hedge_after_s=0.1)
    PACKAGES[pkg][3].configure(chaos_spec)
    try:
        status, payload, _ = router.forward({"tokens": [1, 2, 3],
                                             "max_new_tokens": 1})
        return status, payload["tokens"], fast.generate_calls, \
            router_counters(pkg)
    finally:
        router.stop()
        slow.stop()
        fast.stop()


def test_hedged_request_fires_and_first_response_wins():
    status, tokens, fast_calls, counters = both(hedge_drill, "")
    assert status == 200 and tokens == [1, 2, 3, 7]
    assert fast_calls == 1, "the hedge landed on the fast replica"
    assert counters["router/hedges"] == 1.0
    assert counters["router/hedge_wins"] == 1.0
    assert counters["router/retry_budget_spent"] == 1.0


def test_chaos_router_hedge_suppresses_but_request_completes():
    status, tokens, fast_calls, counters = both(hedge_drill,
                                                "router_hedge:exc@1")
    assert status == 200 and tokens == [1, 2, 3, 7]
    assert fast_calls == 0, "a suppressed hedge never launched"
    assert counters["router/hedges_suppressed"] == 1.0
    assert counters["router/hedges"] == 0.0


def invalid_body_drill(pkg, stubs, mode):
    bad, good = stubs
    bad.mode, good.mode = mode, "ok"
    router = router_over(pkg, stubs, breaker_threshold=3)
    try:
        status, payload, _ = router.forward({"tokens": [9, 9, 9],
                                             "max_new_tokens": 1})
        (bad_b,) = [b for b in router.backends
                    if b.url.endswith(f":{bad.port}")]
        return status, payload, bad_b.breaker.failures, \
            router_counters(pkg)
    finally:
        router.stop()


@pytest.mark.parametrize("mode", ["wrong_shape", "garbage", "truncated"])
def test_malformed_garbage_truncated_200_bodies_fail_over(stub_pair, mode):
    """A 200 whose body is not a /generate answer, is not JSON, or is
    cut short is a request failure: a breaker strike and a failover —
    never forwarded to the client."""
    status, payload, strikes, counters = both(invalid_body_drill,
                                              stub_pair, mode)
    assert status == 200 and payload["tokens"] == [9, 9, 9, 7]
    assert strikes == 1
    assert counters["router/failovers"] == 1.0
    assert counters["router/response_invalid"] == (
        1.0 if mode == "wrong_shape" else 0.0)


# --------------------------------------------------------------------- #
# the repaired checkpoint_verify seam
# --------------------------------------------------------------------- #


def fake_checkpoint(directory, payload=b"weights-bytes"):
    """A committed port checkpoint dir with a valid manifest."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "params.pt"), "wb") as f:
        f.write(payload)
    meta = {MANIFEST_KEY: {"algo": "sha256",
                           "files": build_manifest(directory)}}
    with open(os.path.join(directory, META_NAME), "w") as f:
        json.dump(meta, f)
    return directory


def test_chaos_checkpoint_verify_drives_quarantine(tmp_path):
    """``checkpoint_verify:exc@1`` is a verification failure: the port's
    ``verify_or_quarantine`` raises ``CheckpointCorrupt`` naming the
    injection and moves the directory aside, as trlx_tpu's does."""
    telemetry.start()
    registry = telemetry.current().registry
    ck = fake_checkpoint(str(tmp_path / "ck"))
    chaos.configure("checkpoint_verify:exc@1")
    try:
        with pytest.raises(CheckpointCorrupt, match="chaos-injected"):
            verify_or_quarantine(ck)
        assert registry.counters["checkpoint/verify_failures"] == 1.0
        assert registry.counters["checkpoint/quarantined"] == 1.0
        assert not os.path.isdir(ck)
        assert any(".corrupt-" in e for e in os.listdir(tmp_path))
    finally:
        chaos.reset()
        telemetry.start()


def test_chaos_checkpoint_verify_fires_per_call(tmp_path):
    """The seam counts verify calls: ``@2`` lets the first pass and fails
    the second, and a clean schedule verifies as before."""
    telemetry.start()
    registry = telemetry.current().registry
    ck = fake_checkpoint(str(tmp_path / "ck"))
    chaos.configure("checkpoint_verify:exc@2")
    try:
        assert verify_checkpoint(ck) is True
        with pytest.raises(CheckpointCorrupt, match="chaos-injected"):
            verify_checkpoint(ck)
        assert verify_checkpoint(ck) is True
        assert registry.counters["checkpoint/verified"] == 2.0
        assert registry.counters["checkpoint/verify_failures"] == 1.0
    finally:
        chaos.reset()
        telemetry.start()


def test_corrupt_rollout_aborts_with_the_old_version(tmp_path):
    """A rollout under ``checkpoint_verify:exc@1`` over two checkpoint-
    backed port replicas: the first replica's reload answers 409, the
    rollout aborts, both replicas stay admitted on version 1 with their
    tokens, and the step the drill hit is quarantined."""
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.serve import InferenceEngine as JaxEngine
    from trlx_tpu.serve import ServeConfig as JaxServe

    tree = jax.device_get(JaxEngine(
        JaxConfig.from_dict(tiny_config_dict()), serve=JaxServe(**SERVE),
        init=False)._init_params())
    run = str(tmp_path / "run")
    save_step_checkpoint({"params": tree_map(torch.tensor, tree),
                          "config": tiny_config_dict()}, run, 1)
    step1 = os.path.join(run, "step_1")
    telemetry.start()
    servers = [InferenceServer(InferenceEngine.from_checkpoint(
        step1, serve=ServeConfig(**SERVE), device="cpu"),
        port=0).start(warmup=True) for _ in range(2)]
    router = FleetRouter(RouterConfig(
        backends=[f"127.0.0.1:{s.port}" for s in servers], port=0,
        page_size=SERVE["page_size"], probe_interval=30.0,
        rollout_timeout=60.0)).start()
    registry = telemetry.current().registry
    try:
        row = {"tokens": ROWS[0], "max_new_tokens": 4}
        status, _, before = _http(router.port, "/generate", "POST", row)
        assert status == 200
        chaos.configure("checkpoint_verify:exc@1")
        try:
            status, _, body = _http(router.port, "/admin/rollout", "POST",
                                    {"checkpoint": step1})
        finally:
            chaos.reset()
        assert status == 409 and body["ok"] is False, body
        assert "chaos-injected" in body["steps"][0]["reason"]
        assert body["aborted_at"] == router.backends[0].url
        assert registry.counters["router/rollout_aborts"] == 1.0
        assert registry.counters["serve/reload_failures"] == 1.0
        assert registry.counters["checkpoint/quarantined"] == 1.0
        assert not os.path.isdir(step1)
        assert router.admitting_count() == 2
        router.probe_fleet()
        assert registry.gauges["router/fleet_model_version"] == 1.0
        for _ in range(2):
            status, _, after = _http(router.port, "/generate", "POST", row)
            assert status == 200 and after["model_version"] == 1
            assert after["tokens"] == before["tokens"]
        assert registry.counters.get("compile/recompiles", 0.0) == 0.0
    finally:
        router.stop()
        for s in servers:
            s.stop()
        telemetry.start()
