"""The port's request tracing (trlx_tpu_torch.serve.trace), its flight
recorder, the SLO gauges, the Prometheus exposition and the serve
watchdog, against trlx_tpu's on the CPU (tests/test_request_trace.py is
the reference's own file): ``SloEngine`` snapshots and
``RequestTrace.to_dict`` equal to trlx_tpu's for the same timestamps
(the static-decode approximation included), the flight recorder's bound
and dump format, ``prometheus_text`` with the ``serve/*`` and ``slo/*``
families predeclared at 0, every slot-scheduler request traced (greedy
tokens and the SLO histograms' counts equal to trlx_tpu's at fp32 on the
same weights), tracing off, a poisoned step dumping the recorder, a
chaos hang becoming a watchdog stall that runs the dump function, the
server's routes, and ``configs/ppo_config.yml`` arming the watchdog."""

import json
import time
import urllib.error
import urllib.request

import jax
import pytest

from test_paged import build_engine as jax_paged_engine
from test_serve import tiny_config_dict
from trlx_tpu import telemetry as jax_telemetry
from trlx_tpu.serve import trace as jax_trace
from trlx_tpu.serve.slots import SlotScheduler as JaxSlotScheduler
from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.serve import (
    InferenceEngine,
    InferenceServer,
    MicroBatcher,
    ServeConfig,
    SlotScheduler,
)
from trlx_tpu_torch.serve import trace as port_trace
from trlx_tpu_torch.serve.__main__ import build_parser, serve_config_from_args
from trlx_tpu_torch.supervisor import RunSupervisor, chaos

BUCKETS = [[2, 8, 8], [4, 8, 8]]
ROWS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 4, 6]]


@pytest.fixture(scope="module")
def tree():
    """trlx_tpu's tiny policy as numpy: the weights both packages load."""
    return jax.device_get(jax_paged_engine(buckets=BUCKETS)._init_params())


def port_engine(tree, **serve):
    telemetry.start()
    cfg = ServeConfig(**{
        "buckets": BUCKETS, "max_queue": 64, "request_timeout": 30.0,
        "slots": 4, "page_size": 4, "slo_ttft_ms": 0.0,
        "flight_recorder_steps": 32, **serve})
    return InferenceEngine(TRLConfig.from_dict(tiny_config_dict()),
                           serve=cfg, params=tree, device="cpu")


def run_rows(s, rows=ROWS, max_new=4):
    """Every row queued under the scheduler's lock (one admission order
    in both packages), then waited for."""
    s.warmup()
    s.start()
    try:
        with s._cond:
            reqs = [s.submit(list(r), max_new_tokens=max_new) for r in rows]
        for r in reqs:
            r.wait(timeout=60.0)
        return reqs
    finally:
        s.stop()


# --------------------------------------------------------------------- #
# the host types against trlx_tpu's
# --------------------------------------------------------------------- #


def test_slo_engine_snapshot_equals_trlx_tpu():
    """The same scored requests at the same fixed clock give the same
    windowed snapshot and the same gauges."""
    jax_telemetry.start()
    telemetry.start()
    ours = port_trace.SloEngine(target=0.9, fast_s=10.0, slow_s=100.0)
    theirs = jax_trace.SloEngine(target=0.9, fast_s=10.0, slow_s=100.0)
    events = [(True, 1.0, {"path": "slots"}), (False, 2.5, {"path": "slots"}),
              (True, 3.0, {"tenant": "a"}), (True, 50.0, {"path": "slots"}),
              (False, 55.0, {"tenant": "a"}), (True, 140.0, {"path": "static"})]
    for ok, now, labels in events:
        ours.record(ok, now=now, labels=labels)
        theirs.record(ok, now=now, labels=labels)
        for t in (now, now + 7.0, now + 120.0):
            assert ours.snapshot(now=t) == theirs.snapshot(now=t)
    gauges = telemetry.current().registry.gauges
    want = jax_telemetry.current().registry.gauges
    slo = {k: v for k, v in want.items() if k.startswith("slo/")}
    assert slo and {k: gauges[k] for k in slo} == slo
    assert ours.burn_rate(0.5) == theirs.burn_rate(0.5)


def _stamp(tr, static=False):
    tr.enqueued = 100.0
    tr.admitted = 100.5
    tr.bucket = (2, 8)
    if static:
        tr.note_static_decode(100.5, 102.0, n_tokens=5)
    else:
        tr.prefill_start = 100.5
        tr.prefill_end = 100.6
        tr.pages_reserved, tr.prefix_blocks_hit, tr.suffix_len = 3, 1, 4
        for t in (101.0, 101.2, 101.3, 101.7):
            tr.note_token(t)
        tr.replays, tr.model_version = 1, 2
    tr.harvested = 102.0
    tr.responded = 102.25
    return tr


@pytest.mark.parametrize("static", [False, True])
def test_request_trace_to_dict_equals_trlx_tpu(static):
    """to_dict, TTFT and the ITL aggregate for the same timestamps, the
    static path's uniform approximation included; then complete()
    observes the same SLO family in both registries."""
    reg = telemetry.start().registry
    jreg = jax_telemetry.start().registry
    ours = _stamp(port_trace.RequestTrace("abc", received=99.75), static)
    theirs = _stamp(jax_trace.RequestTrace("abc", received=99.75), static)
    assert ours.to_dict() == theirs.to_dict()
    assert (ours.ttft(), ours.itl_mean()) == (theirs.ttft(),
                                              theirs.itl_mean())
    path = "static" if static else "slots"
    ours.complete(path, slo_ttft_s=1.0)
    theirs.complete(path, slo_ttft_s=1.0)
    assert {k: (h.count, h.total) for k, h in reg.hists.items()} == \
        {k: (h.count, h.total) for k, h in jreg.hists.items()}
    assert reg.counters["serve/slo_total"] == \
        jreg.counters["serve/slo_total"] == 1.0
    assert reg.gauges["serve/goodput"] == jreg.gauges["serve/goodput"]


def test_flight_recorder_bounded_and_dumps_like_trlx_tpu(capsys):
    telemetry.start()
    jax_telemetry.start()
    ours, theirs = port_trace.FlightRecorder(4), jax_trace.FlightRecorder(4)
    for i in range(10):
        for fr in (ours, theirs):
            fr.record(step=i, active=1, pages_free=10 - i)
    assert ours.snapshot() == theirs.snapshot()
    assert [r["step"] for r in ours.snapshot()] == [6, 7, 8, 9]
    ours.dump("unit drill")
    mine = capsys.readouterr().err
    theirs.dump("unit drill")
    ref = capsys.readouterr().err
    assert mine.replace("trlx_tpu_torch.serve", "trlx_tpu.serve") == ref
    assert "FLIGHT RECORDER (unit drill): last 4 engine steps" in mine
    assert ours.dumps == 1
    assert telemetry.current().registry.counters["serve/flight_dumps"] == 1


def test_prometheus_text_has_serve_and_slo_families(tree):
    """A started server predeclares the serve/* and SLO counters, so the
    Prometheus text carries them at 0 before any request; one request
    then adds the ttft / itl summaries and the labeled slo gauges."""
    srv = InferenceServer(port_engine(tree), port=0)
    srv.start(warmup=False)
    try:
        text = telemetry.prometheus_text()
        for name in ("serve_requests", "serve_replays", "serve_shed_quota",
                     "serve_drains", "serve_reloads", "serve_slo_good",
                     "serve_slo_total", "serve_flight_dumps"):
            assert f"trlx_tpu_{name}_total 0.0" in text, name
        assert "trlx_tpu_serve_goodput 0.0" in text
        code, _, _ = srv.http_generate({"tokens": [1, 2, 3],
                                        "max_new_tokens": 3}, {})
        assert code == 200
        text = telemetry.prometheus_text()
        assert 'trlx_tpu_serve_ttft_seconds{quantile="0.5"}' in text
        assert "trlx_tpu_serve_itl_seconds_count 2.0" in text
        assert 'trlx_tpu_slo_goodput_5m{path="slots"} 1.0' in text
        assert 'trlx_tpu_slo_burn_rate_fast{tenant="default"} 0.0' in text
    finally:
        srv.stop()


# --------------------------------------------------------------------- #
# the scheduler end to end
# --------------------------------------------------------------------- #


def test_slot_requests_carry_complete_traces_like_trlx_tpu(tree):
    """Every request completes with a trace whose edges are ordered; the
    greedy tokens and the SLO histograms' counts equal trlx_tpu's on the
    same rows; tracing adds no recompile."""
    jengine = jax_paged_engine(buckets=BUCKETS, slo_ttft_ms=0.0,
                               flight_recorder_steps=32)
    jengine._install_params(tree)
    jreqs = run_rows(JaxSlotScheduler(jengine))
    jhists = jax_telemetry.current().registry.hists
    engine = port_engine(tree)
    reg = telemetry.current().registry
    reqs = run_rows(SlotScheduler(engine))
    assert [r.result for r in reqs] == [r.result for r in jreqs]
    for r in reqs:
        tr = r.trace
        assert tr.received <= tr.enqueued <= tr.admitted
        assert tr.admitted <= tr.prefill_start <= tr.prefill_end
        assert tr.prefill_end <= tr.first_token <= tr.last_token
        assert tr.last_token <= tr.harvested
        assert tr.bucket[1] == 8 and tr.pages_reserved >= 1
        assert tr.itl_count == len(r.result) - 1
        assert tr.model_version == r.model_version == 1
    for name in ("serve/ttft", "serve/itl", "serve/queue_time",
                 "serve/prefill_time", "serve/decode_time",
                 "serve/request_latency{path=slots}"):
        assert reg.hists[name].count == jhists[name].count, name
    assert reg.hists["serve/ttft"].count == len(ROWS)
    assert reg.gauges["serve/goodput"] == 1.0
    assert reg.counters["compile/recompiles"] == 0.0


def test_static_path_traces_with_the_uniform_approximation(tree):
    """The micro-batcher traces too: a batch has no per-step times, so
    the first token lands at decode end and each request observes one
    uniform inter-token gap, as in trlx_tpu."""
    engine = port_engine(tree, scheduler="static", max_wait_ms=1.0)
    reg = telemetry.current().registry
    reqs = run_rows(MicroBatcher(engine), rows=ROWS[:2], max_new=4)
    for r in reqs:
        tr = r.trace
        assert tr.first_token == tr.last_token == tr.harvested
        assert tr.itl_count == len(r.result) - 1
        assert tr.to_dict()["tokens"] == len(r.result)
    assert reg.hists["serve/ttft"].count == 2
    assert reg.hists["serve/itl"].count == 2
    assert reg.hists["serve/request_latency{path=static}"].count == 2


def test_tracing_off_yields_no_traces(tree):
    engine = port_engine(tree, request_tracing=False)
    reg = telemetry.current().registry
    (r,) = run_rows(SlotScheduler(engine), rows=[[1, 2]], max_new=2)
    assert r.trace is None and r.result
    assert "serve/ttft" not in reg.hists
    assert reg.hists["serve/request_latency{path=slots}"].count == 1


def test_flight_recorder_records_engine_steps(tree):
    s = SlotScheduler(port_engine(tree))
    run_rows(s, rows=[[1, 2, 3]])
    snap = s.flight.snapshot()
    assert snap
    for rec in snap:
        assert {"step", "t", "active", "finished", "admitted",
                "occupancy", "step_ms", "pages_free"} <= set(rec)
    assert sum(rec["finished"] for rec in snap) == 1
    assert sum(rec["admitted"] for rec in snap) == 1


def test_poisoned_step_dumps_flight_recorder(tree, capsys):
    """A poisoned step dumps the recorder; the request survives it by
    replay, and its trace records the replay and the queue re-entry."""
    engine = port_engine(tree)
    reg = telemetry.current().registry
    s = SlotScheduler(engine)
    s.warmup()
    s.start()
    chaos.configure("serve_decode:exc@1")
    try:
        r = s.submit([1, 2, 3], max_new_tokens=2)
        assert r.wait(timeout=30.0).result is not None
        assert s.flight.dumps >= 1
        assert reg.counters["serve/flight_dumps"] >= 1.0
        assert "FLIGHT RECORDER (poisoned step" in capsys.readouterr().err
        assert r.trace.replays == 1 and r.trace.queue_reentries >= 1
        assert r.trace.to_dict()["replays"] == 1
        ok = s.submit([4, 5], max_new_tokens=2)
        assert ok.wait(timeout=30.0).result is not None
    finally:
        chaos.reset()
        s.stop()


def test_watchdog_stall_runs_the_flight_recorder_dump(tree, capsys):
    """A chaos-hung decode step becomes a watchdog stall, whose dump
    functions (the server's wiring) print the flight recorder beside the
    stack dump; the released hang is then replayed."""
    engine = port_engine(tree)
    reg = telemetry.current().registry
    sup = RunSupervisor(stall_timeout=0.3, stall_first_timeout=0.3,
                        stall_grace=10_000.0, stall_action="abort",
                        exit_fn=lambda code: None)
    s = SlotScheduler(engine, run_supervisor=sup)
    sup.add_dump_fn(s.dump_flight_recorder)
    s.warmup()
    s.start()
    try:
        s.submit([1, 2], max_new_tokens=1).wait(timeout=30.0)
        chaos.configure("serve_decode:hang=60@1")
        hung = s.submit([3, 4], max_new_tokens=2)
        deadline = time.monotonic() + 15.0
        while s.flight.dumps == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sup.stalls >= 1 and sup.stalled_phase == "serve_decode"
        assert reg.counters["fault/stalls"] >= 1.0
        err = capsys.readouterr().err
        assert "FLIGHT RECORDER (watchdog stall)" in err
        assert "STALL: phase 'serve_decode'" in err
        chaos.reset()  # release: the ChaosHang is a poisoned step
        assert hung.wait(timeout=15.0).result is not None
        assert hung.replays == 1
    finally:
        chaos.reset()
        s.stop()


def test_ppo_config_arms_the_serve_watchdog(tree):
    """``python -m trlx_tpu_torch.serve --config configs/ppo_config.yml``
    takes ``stall_timeout: 60`` from the serve section, and the server
    builds an abort-mode watchdog with the flight recorder's dump."""
    args = build_parser().parse_args(["--config", "configs/ppo_config.yml",
                                      "--device", "cpu"])
    from trlx_tpu_torch.serve.__main__ import load_config_file

    cfg = serve_config_from_args(args, load_config_file(args.config))
    assert (cfg.stall_timeout, cfg.flight_recorder_steps,
            cfg.slo_ttft_ms) == (60, 256, 500)
    cfg.buckets = BUCKETS  # the tiny model's lattice
    cfg.slots, cfg.page_size = 4, 4
    telemetry.start()
    engine = InferenceEngine(TRLConfig.from_dict(tiny_config_dict()),
                             serve=cfg, params=tree, device="cpu")
    srv = InferenceServer(engine)
    assert srv.supervisor is srv.scheduler.run_supervisor
    assert (srv.supervisor.stall_timeout, srv.supervisor.stall_action) == (
        60.0, "abort")
    assert srv.supervisor.dump_fns == [srv.scheduler.dump_flight_recorder]
    assert InferenceServer(port_engine(tree)).supervisor is None


# --------------------------------------------------------------------- #
# the HTTP surface
# --------------------------------------------------------------------- #


def _http(port, path, method="GET", payload=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(payload).encode() if payload is not None else None,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def test_http_trace_metrics_negotiation_and_debug_routes(tree):
    srv = InferenceServer(port_engine(tree), port=0).start()
    try:
        code, headers, body = _http(
            srv.port, "/generate", "POST",
            {"tokens": [1, 2, 3], "max_new_tokens": 3, "trace": True},
            headers={"X-Request-Id": "req-42"})
        body = json.loads(body)
        assert code == 200 and body["trace_id"] == "req-42"
        assert headers["X-Request-Id"] == "req-42"
        tr = body["trace"]
        assert tr["trace_id"] == "req-42" and tr["tokens"] == 3
        assert tr["ttft_ms"] > 0 and tr["total_ms"] >= tr["ttft_ms"]
        assert body["model_version"] == 1
        code, _, body = _http(srv.port, "/generate", "POST",
                              {"tokens": [4, 5], "max_new_tokens": 2})
        body = json.loads(body)
        assert "trace" not in body and len(body["trace_id"]) == 16

        code, headers, text = _http(srv.port, "/metrics",
                                    headers={"Accept": "text/plain"})
        assert code == 200 and headers["Content-Type"].startswith(
            "text/plain; version=0.0.4")
        assert "trlx_tpu_serve_ttft_seconds" in text
        code, headers, body = _http(srv.port, "/metrics")
        assert headers["Content-Type"] == "application/json"
        assert json.loads(body)["timings"]["serve/ttft"]["count"] == 2

        code, _, body = _http(srv.port, "/debug/state")
        state = json.loads(body)
        assert code == 200 and state["scheduler"] == "slots"
        assert state["flight_recorder"] and state["model_version"] == 1
        assert {"pressure", "kv", "slots", "draining"} <= set(state)
        code, _, body = _http(srv.port, "/debug/slo")
        slo = json.loads(body)
        assert code == 200 and slo["target"] == 0.99
        assert {"path": "slots"} in [s["labels"] for s in slo["series"]]
        code, _, body = _http(srv.port, "/debug/nowhere")
        assert code == 404 and "/debug/slo" in json.loads(body)["error"]
        code, _, body = _http(srv.port, "/generate", "POST",
                              {"tokens": [1, 2], "max_new_tokens": 2,
                               "tenant": "t", "priority": 3,
                               "deadline_ms": 60_000, "seed": 5})
        assert code == 200 and len(json.loads(body)["tokens"]) == 2
    finally:
        srv.stop()
