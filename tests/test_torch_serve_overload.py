"""The port's overload containment (tenant quotas, priorities and aging,
deadlines, brownout, the published pressure, the hop limit) against
trlx_tpu's on the CPU (tests/test_overload.py is the reference's own
file): ``TenantTable`` admits, refuses and paces exactly as trlx_tpu's
under a fake clock; ``QuotaExceeded`` is a typed ``QueueFull``; a bad
``tenants`` block (and every other lifecycle knob) fails at boot with
trlx_tpu's message; aging prevents starvation; the brownout state
machine's hysteresis and its best-effort-only clamp; ``pressure()``,
the 429 with ``Retry-After`` and ``/readyz``; deadline shedding in both
schedulers; the 508 hop limit; and the port's ``ServeConfig`` field set
equal to trlx_tpu's."""

import contextlib
import dataclasses
import time

import numpy as np
import pytest

from test_serve import tiny_config_dict
from trlx_tpu import telemetry as jax_telemetry
from trlx_tpu.data.configs import TRLConfig as JaxConfig
from trlx_tpu.serve import InferenceEngine as JaxEngine
from trlx_tpu.serve import ServeConfig as JaxServe
from trlx_tpu.serve.batcher import MicroBatcher as JaxMicroBatcher
from trlx_tpu.serve.batcher import TenantTable as JaxTenantTable
from trlx_tpu.serve.slots import SlotScheduler as JaxSlotScheduler
from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.serve import (
    InferenceEngine,
    InferenceServer,
    MicroBatcher,
    QueueFull,
    ServeConfig,
    SlotScheduler,
)
from trlx_tpu_torch.serve.batcher import (
    DEFAULT_TENANT,
    DeadlineExceeded,
    QuotaExceeded,
    TenantPolicy,
    TenantTable,
)
from trlx_tpu_torch.serve.server import MAX_HOPS
from trlx_tpu_torch.supervisor import chaos

SERVE = dict(buckets=[[2, 8, 8], [4, 8, 8]], max_queue=32,
             request_timeout=30.0, scheduler="slots", slots=2,
             kv_layout="contiguous")


@pytest.fixture(scope="module")
def engine():
    """One tiny greedy engine shared by the tests (each builds its own
    scheduler, which reads the knobs at construction)."""
    telemetry.start()
    return InferenceEngine(TRLConfig.from_dict(tiny_config_dict()),
                           serve=ServeConfig(**SERVE), device="cpu")


@pytest.fixture()
def registry():
    session = telemetry.start()
    yield session.registry
    telemetry.start()


@contextlib.contextmanager
def serve_overrides(engine, **overrides):
    saved = {k: getattr(engine.serve, k) for k in overrides}
    for k, v in overrides.items():
        setattr(engine.serve, k, v)
    try:
        yield engine
    finally:
        for k, v in saved.items():
            setattr(engine.serve, k, v)


# --------------------------------------------------------------------- #
# the config surface (fault 5) and the boot-time checks
# --------------------------------------------------------------------- #


def test_serve_config_fields_equal_trlx_tpu_less_deferred_knobs():
    """Every serve knob trlx_tpu honours is a field of the port's
    ServeConfig with trlx_tpu's default: none is deferred any more (the
    tp serve mesh, ``mesh`` / ``mesh_weights``, was the last) and none is
    dropped in silence."""
    ours = {f.name: f for f in dataclasses.fields(ServeConfig)}
    theirs = {f.name: f for f in dataclasses.fields(JaxServe)}
    assert set(ours) == set(theirs)
    ref = JaxServe()
    for name, value in dataclasses.asdict(ServeConfig()).items():
        assert value == getattr(ref, name), name
    full = dataclasses.asdict(ref)  # trlx_tpu's every knob, at defaults
    assert dataclasses.asdict(ServeConfig.from_dict(full)) == full
    cfg = ServeConfig.from_dict({"mesh": {"tp": 2},
                                 "mesh_weights": "replicated"})
    assert (cfg.mesh, cfg.mesh_weights) == ({"tp": 2}, "replicated")


@pytest.mark.parametrize("knobs", [
    {"tenants": {"x": {"bogus": 1}}},
    {"tenants": {"x": {"max_queue_share": 1.5}}},
    {"slo_ttft_ms": -1.0}, {"slo_target": 1.0},
    {"flight_recorder_steps": -1}, {"max_replays": -1},
    {"drain_timeout": 0.0}, {"watch_checkpoints": -1.0},
    {"degrade_step_ms": -1.0}, {"brownout_max_new": -1},
    {"brownout_after_s": 0.0}, {"brownout_recover_s": 0.0},
    {"priority_aging_rounds": -1},
])
def test_bad_knobs_fail_at_boot_with_trlx_tpu_message(knobs):
    with pytest.raises(ValueError) as theirs:
        JaxEngine(JaxConfig.from_dict(tiny_config_dict()),
                  serve=JaxServe(buckets=[[2, 8, 8]], **knobs), init=False)
    with pytest.raises(ValueError) as ours:
        InferenceEngine(TRLConfig.from_dict(tiny_config_dict()),
                        serve=ServeConfig(buckets=[[2, 8, 8]], **knobs),
                        device="cpu")
    assert str(ours.value) == str(theirs.value)


# --------------------------------------------------------------------- #
# quota primitives against trlx_tpu's, time passed by argument
# --------------------------------------------------------------------- #


def test_tenant_policy_knobs_and_validation():
    p = TenantPolicy("t", {"rps": 2, "priority": 1})
    assert (p.rps, p.burst, p.best_effort) == (2.0, 2.0, False)
    assert TenantPolicy("t", {}).best_effort
    assert TenantPolicy("t", {"rps": 0.5}).burst == 1.0
    with pytest.raises(ValueError, match="unknown keys"):
        TenantPolicy("t", {"bogus": 1})
    with pytest.raises(ValueError, match="max_queue_share"):
        TenantPolicy("t", {"max_queue_share": 1.5})


def test_quota_exceeded_is_a_typed_queue_full():
    e = QuotaExceeded("over quota", tenant="t", retry_after_s=3)
    assert isinstance(e, QueueFull)
    assert (e.tenant, e.retry_after_s) == ("t", 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tenant_table_matches_trlx_tpu_under_a_fake_clock(seed):
    """A random stream of admission attempts over three tenants (a rate
    bucket, an in-flight cap, a queue share; an unnamed tenant falls to
    "default"): the same admit / refuse sequence, the same refusal text
    and Retry-After, the same bucket snapshots."""
    config = {"rate": {"rps": 2.0, "burst": 3, "priority": 1},
              "cap": {"max_inflight": 3},
              "default": {"max_queue_share": 0.25, "rps": 0.5}}
    ours, theirs = TenantTable(config, 16), JaxTenantTable(config, 16)
    rng = np.random.default_rng(seed)
    now = 1000.0
    outcomes = []
    for _ in range(200):
        now += float(rng.exponential(0.3))
        tenant = str(rng.choice(["rate", "cap", "guest", "default"]))
        queued, inflight = int(rng.integers(0, 6)), int(rng.integers(0, 4))
        a = ours.try_admit(tenant, queued, inflight, now)
        b = theirs.try_admit(tenant, queued, inflight, now)
        assert (a is None) == (b is None)
        if a is not None:
            assert (str(a), a.tenant, a.retry_after_s) == (
                str(b), b.tenant, b.retry_after_s)
        assert ours.snapshot(now) == theirs.snapshot(now)
        assert (ours.priority_for(tenant), ours.best_effort(tenant)) == (
            theirs.priority_for(tenant), theirs.best_effort(tenant))
        outcomes.append(a is None)
    assert any(outcomes) and not all(outcomes)
    assert not TenantTable(None, 4).enabled


# --------------------------------------------------------------------- #
# admission: typed sheds, aging, brownout (no worker needed)
# --------------------------------------------------------------------- #


def test_slots_and_static_quota_shed_is_typed_not_global(engine, registry):
    with serve_overrides(engine, tenants={"free": {"rps": 0.01,
                                                   "burst": 2}}):
        for make in (SlotScheduler, MicroBatcher):
            telemetry.start()
            sched = make(engine)  # not started: the admission path only
            sched.submit([1, 2], max_new_tokens=4, tenant="free")
            sched.submit([1, 2], max_new_tokens=4, tenant="free")
            with pytest.raises(QuotaExceeded) as exc:
                sched.submit([1, 2], max_new_tokens=4, tenant="free")
            assert exc.value.tenant == "free"
            assert exc.value.retry_after_s >= 1
            ok = sched.submit([1, 2], max_new_tokens=4)
            assert ok.tenant == DEFAULT_TENANT
            counters = telemetry.current().registry.counters
            assert counters["serve/shed_quota{tenant=free}"] == 1.0
            assert counters["serve/rejected"] == 1.0


def test_serve_quota_chaos_seam_refuses_cleanly(engine, registry):
    with serve_overrides(engine, tenants={"default": {}}):
        sched = SlotScheduler(engine)
        chaos.configure("serve_quota:exc@1")
        try:
            with pytest.raises(chaos.ChaosError):
                sched.submit([1, 2], max_new_tokens=4)
            assert len(sched._queue) == 0
            assert sched.submit([1, 2], max_new_tokens=4) in sched._queue
        finally:
            chaos.reset()


def test_priority_aging_prevents_starvation(engine, registry):
    """A queued best-effort request gains one priority level every
    ``priority_aging_rounds`` scans, so fresh high-priority arrivals
    raise — never pin — its wait; with aging off it starves."""
    for rounds, low_first in ((2, True), (0, False)):
        with serve_overrides(engine, priority_aging_rounds=rounds):
            sched = SlotScheduler(engine)
            sched.warmup()
            sched._free = []  # park every slot: scans only age the queue
            low = sched.submit([5, 6], max_new_tokens=4, priority=0)
            for _ in range(4):
                sched._admit()
            assert low.age == 4
            highs = [sched.submit([5, 6], max_new_tokens=4, priority=1)
                     for _ in range(2)]
            sched._free = [0]  # one slot frees: exactly one admission
            sched._admit()
            assert (low not in sched._queue) == low_first, rounds
            assert sum(h in sched._queue for h in highs) == (
                2 if low_first else 1)


def test_brownout_hysteresis_matches_trlx_tpu(engine, registry):
    """The state machine over the same pressure signal and clock, tick
    for tick against trlx_tpu's: engages after brownout_after_s, a
    flapping signal moves neither edge, releases after
    brownout_recover_s, re-entry counts again."""
    knobs = dict(brownout_max_new=2, brownout_after_s=1.0,
                 brownout_recover_s=2.0)
    jengine = JaxEngine(JaxConfig.from_dict(tiny_config_dict()),
                        serve=JaxServe(**SERVE, **knobs), init=False)
    theirs = JaxSlotScheduler.__new__(JaxSlotScheduler)
    theirs.__dict__.update(engine=jengine, cache=None, _starved=False,
                           _last_step_ms=0.0, _brownout=False,
                           _pressure_since=0.0, _calm_since=0.0,
                           _brownout_max_new=2, _brownout_after_s=1.0,
                           _brownout_recover_s=2.0)
    jreg = jax_telemetry.start().registry
    with serve_overrides(engine, **knobs):
        ours = SlotScheduler(engine)
        ticks = [(0.0, True), (0.9, True), (1.0, True), (1.5, False),
                 (1.6, True), (2.0, False), (3.9, False), (4.0, False),
                 (5.0, True), (6.0, True), (6.5, False), (9.0, False)]
        seen = []
        for t, pressed in ticks:
            for s in (ours, theirs):
                s._starved = pressed
                s._update_brownout(100.0 + t)
            assert ours._brownout == theirs._brownout, t
            seen.append(ours._brownout)
        assert seen == [False, False, True, True, True, True, True, False,
                        False, True, True, False]
        assert registry.counters["serve/brownout_entries"] == \
            jreg.counters["serve/brownout_entries"] == 2.0
    with serve_overrides(engine, brownout_max_new=0):
        off = SlotScheduler(engine)
        off._starved = True
        off._update_brownout(1.0)
        off._update_brownout(100.0)
        assert not off._brownout


def test_brownout_clamps_best_effort_only(engine, registry):
    with serve_overrides(engine, brownout_max_new=2,
                         tenants={"premium": {"priority": 1},
                                  "default": {}}):
        sched = SlotScheduler(engine)
        sched._brownout = True
        r = sched.submit([1, 2], max_new_tokens=8, tenant="guest")
        assert r.degraded and r.max_new_tokens == 2 and r.shape == (8, 8)
        assert registry.counters["serve/brownout_clamped{tenant=guest}"] \
            == 1.0
        p = sched.submit([1, 2], max_new_tokens=8, tenant="premium")
        assert not p.degraded and p.max_new_tokens == 8
        s = sched.submit([1, 2], max_new_tokens=2, tenant="guest")
        assert not s.degraded


def test_pressure_block_and_halved_bound_when_degraded(engine, registry):
    with serve_overrides(engine, max_queue=4,
                         tenants={"default": {"rps": 5, "burst": 5}}):
        sched = SlotScheduler(engine)
        p = sched.pressure()
        assert p == {"degraded": False, "brownout": False,
                     "starved": False, "queue_depth": 0, "free_slots": 2,
                     "retry_after_s": 1}
        state = sched.debug_state()
        assert state["tenants"]["default"]["burst"] == 5.0
        sched._starved = True  # degraded: the bound halves to 2
        sched.submit([1], max_new_tokens=2)
        sched.submit([2], max_new_tokens=2)
        with pytest.raises(QueueFull, match="halved: engine degraded"):
            sched.submit([3], max_new_tokens=2)
        assert registry.gauges["serve/admission_limit"] == 2
        assert sched.pressure()["degraded"] is True


# --------------------------------------------------------------------- #
# deadlines: both schedulers shed what waited past its deadline
# --------------------------------------------------------------------- #


def test_deadline_shedding_in_both_schedulers_like_trlx_tpu(engine,
                                                            registry):
    """A request still queued past its ``deadline_ms`` ends with
    DeadlineExceeded before any slot or batch is spent on it — at the
    slot scheduler's admission scan and at the static path's flush, as
    in trlx_tpu; a request with room left is served."""
    jengine = JaxEngine(JaxConfig.from_dict(tiny_config_dict()),
                        serve=JaxServe(**SERVE))
    jreg = jax_telemetry.current().registry
    with pytest.raises(ValueError, match="deadline_ms=0 must be > 0"):
        SlotScheduler(engine).submit([1], deadline_ms=0)
    for ours, theirs in ((SlotScheduler(engine), JaxSlotScheduler(jengine)),
                         (MicroBatcher(engine), JaxMicroBatcher(jengine))):
        pairs = [(s, s.submit([1, 2], max_new_tokens=2, deadline_ms=1.0),
                  s.submit([1, 2], max_new_tokens=2, deadline_ms=60_000.0))
                 for s in (ours, theirs)]
        time.sleep(0.02)
        for s, late, fine in pairs:
            if hasattr(s, "_admit"):
                s.warmup()
                s._admit()
                assert late.done.is_set() and not fine.done.is_set()
            else:
                s._flush(list(s._queue))
                assert late.done.is_set() and fine.result
        (_, mine, _), (_, ref, _) = pairs
        assert isinstance(mine.error, DeadlineExceeded)
        assert type(ref.error).__name__ == "DeadlineExceeded"
        assert str(mine.error).split(" after ")[0] == \
            str(ref.error).split(" after ")[0]
    assert registry.counters["serve/shed_expired"] == \
        jreg.counters["serve/shed_expired"] == 2.0


# --------------------------------------------------------------------- #
# the HTTP edge: typed 429, Retry-After, /readyz pressure, 503, 508
# --------------------------------------------------------------------- #


def test_http_quota_429_degraded_flag_readyz_deadline_and_hops(engine):
    telemetry.start()
    with serve_overrides(engine, tenants={"miser": {"rps": 0.01,
                                                    "burst": 1}},
                         brownout_max_new=2):
        srv = InferenceServer(engine, port=0).start(warmup=True)
        body = {"tokens": [1, 2], "max_new_tokens": 2}
        try:
            code, _, _ = srv.http_generate(body, {"X-Tenant-Id": "miser"})
            assert code == 200
            code, payload, headers = srv.http_generate(
                body, {"X-Tenant-Id": "miser"})
            assert code == 429 and payload["tenant"] == "miser"
            assert int(headers["Retry-After"]) >= 1
            code, _, _ = srv.http_generate({**body, "tenant": "miser"}, {})
            assert code == 429  # the body field when no header is sent
            code, _, _ = srv.http_generate(body, {})
            assert code == 200  # other tenants are still served
            srv.scheduler._brownout = True
            code, payload, _ = srv.http_generate(
                {"tokens": [1, 2], "max_new_tokens": 6, "tenant": "guest"},
                {})
            assert code == 200 and payload["degraded"] is True
            assert len(payload["tokens"]) <= 2
            srv.scheduler._brownout = False
            code, ready = srv.readyz()
            assert code == 200 and ready["ready"] is True
            assert {"degraded", "brownout", "queue_depth", "free_slots",
                    "retry_after_s"} <= set(ready["pressure"])
            # a deadline that passes in the queue is trlx_tpu's 503: with
            # no slot free the request waits there, and the worker's next
            # admission scan sheds it
            free, srv.scheduler._free = srv.scheduler._free, []
            try:
                code, payload, _ = srv.http_generate(
                    {**body, "deadline_ms": 1}, {})
            finally:
                srv.scheduler._free = free
            assert code == 503 and "deadline_ms" in payload["error"]
            code, payload, _ = srv.http_generate(
                body, {"X-Hop-Count": str(MAX_HOPS + 1)})
            assert code == 508 and "routing loop" in payload["error"]
            assert srv.http_generate(body, {"X-Hop-Count": "x"})[0] == 400
            code, _, headers = srv.http_generate(
                body, {"X-Hop-Count": str(MAX_HOPS)})
            assert code == 200 and headers["X-Hop-Count"] == str(MAX_HOPS)
            counters = telemetry.current().registry.counters
            assert counters["serve/hop_limit_rejects"] == 1.0
            assert counters["serve/shed_expired"] == 1.0
        finally:
            srv.stop()
    telemetry.start()
