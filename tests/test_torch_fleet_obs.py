"""The port's fleet observability (trlx_tpu_torch.router.obs and
trlx_tpu_torch.obs) against trlx_tpu's on the CPU (tests/test_obs.py is
the reference's own file): ``FleetTrace``, ``TraceRing``, ``AccessLog``
and ``RouterObs`` give the same records as trlx_tpu's for the same event
sequence on one fake clock, sampling, tail capture and rotation
included; ``read_records``, ``summarize``, ``format_summary``,
``find_record``, ``perfetto_events`` and ``format_line`` give the same
output from both packages on the fixture access log and on a log the
port's router wrote; the ``summarize`` / ``trace`` / ``tail`` CLI as a
program prints what trlx_tpu's prints; and the router's
``/debug/trace`` / ``/debug/slo`` endpoints over stub replicas."""

import json
import os
import pathlib
import subprocess
import sys
import urllib.request

import pytest

import trlx_tpu.obs as jax_obslib
import trlx_tpu.router.obs as jax_router_obs
import trlx_tpu_torch.obs as obslib
import trlx_tpu_torch.router.obs as router_obs
from test_defense import _StubReplica
from test_router import _http
from trlx_tpu import telemetry as jax_telemetry
from trlx_tpu_torch import telemetry
from trlx_tpu_torch.obs.__main__ import main as obs_main
from trlx_tpu_torch.router import FleetRouter, RouterConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURE_LOG = str(REPO / "tests" / "obs_fixtures" / "access.jsonl")
TRACE_ID = "feedbeefcafe0001"


class FakeClock:
    def __init__(self, step=0.0125):
        self.t, self.step = 100.0, step

    def __call__(self):
        self.t += self.step
        return self.t


@pytest.fixture
def clocks(monkeypatch):
    """One fake monotonic clock per package, ticking alike."""
    monkeypatch.setattr(router_obs, "monotonic", FakeClock())
    monkeypatch.setattr(jax_router_obs, "monotonic", FakeClock())


EVENTS = [
    ("pick", {"backend": "b1", "how": "affinity", "depth": 2}),
    ("attempt", {"backend": "b1"}),
    ("attempt_fail", {"backend": "b1", "status": 503}),
    ("breaker_strike", {"backend": "b1", "failures": 1}),
    ("retry_budget_spend", {"reason": "failover", "tenant": "default"}),
    ("failover", {"n": 1, "delay_s": 0.05, "error": "b1 answered 503"}),
    ("pick", {"backend": "b2", "how": "least_loaded", "depth": 0}),
    ("hedge_fire", {"backend": "b2", "depth": 0, "after_s": 0.1}),
    ("breaker_open", {"backend": "b1"}),
    ("hedge_win", {"backend": "b2"}),
    ("hedge_lose", {"backend": "b1"}),
]


def stitched(module, events, **finish):
    ft = module.FleetTrace("abc123")
    for kind, fields in events:
        ft.event(kind, **fields)
    return ft.finish(**finish)


@pytest.mark.parametrize("finish", [
    dict(status=200, backend="b2",
         replica_trace={"ttft_ms": 80.0, "decode_ms": 40.0, "hops": 1},
         slo_ttft_ms=50.0),
    dict(status=200, backend="b1", replica_trace={"ttft_ms": 10.0},
         slo_ttft_ms=50.0),
    dict(status=503, error="no admitting replica"),
], ids=["breached", "clean", "error"])
def test_fleet_trace_records_equal_trlx_tpu(clocks, finish):
    for n in (0, 2, len(EVENTS)):
        ours = stitched(router_obs, EVENTS[:n], **finish)
        theirs = stitched(jax_router_obs, EVENTS[:n], **finish)
        assert ours == theirs, n
        assert router_obs.is_tail(ours) == jax_router_obs.is_tail(theirs)
    assert ours["hedged"] and ours["failed_over"] and ours["breaker_opened"]
    assert [e["event"] for e in ours["events"]] == [k for k, _ in EVENTS]
    assert router_obs.is_tail(ours)


def test_trace_ring_equals_trlx_tpu():
    ours, theirs = router_obs.TraceRing(3), jax_router_obs.TraceRing(3)
    for i in [0, 1, 2, 3, 1, 4, 1, 5]:
        for ring in (ours, theirs):
            ring.put({"trace_id": f"t{i}", "status": 200 + i})
        assert ours.ids() == theirs.ids()
        assert [ours.get(t) for t in ours.ids()] == \
            [theirs.get(t) for t in theirs.ids()]
    assert ours.get("t0") is None and ours.ids()[0] == "t5"
    assert router_obs.TraceRing(0).capacity == 1


@pytest.mark.parametrize("sample_every,max_bytes", [(1, 10_000), (3, 10_000),
                                                    (1, 300), (2, 120)])
def test_access_log_sampling_and_rotation_equal_trlx_tpu(
        tmp_path, sample_every, max_bytes):
    paths = {}
    for name, module in (("ours", router_obs), ("theirs", jax_router_obs)):
        path = str(tmp_path / name / "access.jsonl")
        log = module.AccessLog(path, sample_every=sample_every,
                               max_bytes=max_bytes)
        written = [log.write({"trace_id": f"r{i}", "pad": "p" * (i * 7),
                              "status": 503 if i % 5 == 4 else 200},
                             force=i % 5 == 4) for i in range(12)]
        paths[name] = (path, written, log.stats())
    (ours, w_ours, s_ours), (theirs, w_theirs, s_theirs) = \
        paths["ours"], paths["theirs"]
    assert w_ours == w_theirs and s_ours == s_theirs
    for suffix in ("", ".1"):
        assert os.path.exists(ours + suffix) == \
            os.path.exists(theirs + suffix)
        if os.path.exists(ours + suffix):
            with open(ours + suffix) as a, open(theirs + suffix) as b:
                assert a.read() == b.read()
    if max_bytes < 1000:
        assert os.path.exists(ours + ".1"), "rotation expected"
        assert os.path.getsize(ours) <= max_bytes


def test_router_obs_sinks_equal_trlx_tpu(tmp_path, clocks):
    """RouterObs.begin / finish: the ring gets every record, the log the
    sampled ones plus every tail; no telemetry session records nothing."""
    records = {}
    for name, module, tel in (("ours", router_obs, telemetry),
                              ("theirs", jax_router_obs, jax_telemetry)):
        tel.start()
        obs = module.RouterObs(trace_ring=4,
                               access_log=str(tmp_path / f"{name}.jsonl"),
                               access_log_sample=3)
        out = []
        for i in range(7):
            ft = obs.begin(f"id{i}")
            ft.event("pick", backend="b1", how="affinity", depth=1)
            out.append(obs.finish(ft, 200 if i != 5 else 503,
                                  backend="b1",
                                  replica_trace={"ttft_ms": 5.0 * i},
                                  slo_ttft_ms=20.0))
        tel.stop()
        off = obs.begin("never")
        tel.start()
        with open(tmp_path / f"{name}.jsonl") as f:
            lines = f.read()
        records[name] = (out, obs.ring.ids(), lines, off,
                         obs.finish(None, 200))
    assert records["ours"] == records["theirs"]
    out, ids, lines, off, none = records["ours"]
    assert off is None and none is None
    assert ids == ["id6", "id5", "id4", "id3"]
    logged = [json.loads(ln)["trace_id"] for ln in lines.splitlines()]
    # every 3rd, plus the breaches (ttft > 20 ms) and the 503
    assert logged == ["id0", "id3", "id5", "id6"]


# --------------------------------------------------------------------- #
# the obs library on the fixture log
# --------------------------------------------------------------------- #


def test_obs_library_equals_trlx_tpu_on_the_fixture():
    ours = obslib.read_records(FIXTURE_LOG)
    theirs = jax_obslib.read_records(FIXTURE_LOG)
    assert ours == theirs and len(ours) == 5  # the torn line skipped
    report = obslib.summarize(ours)
    assert report == jax_obslib.summarize(theirs)
    assert obslib.format_summary(report) == \
        jax_obslib.format_summary(report)
    assert report["totals"]["requests"] == 5
    assert report["totals"]["hedge_win_rate"] == 1.0
    for record in ours:
        tid = record["trace_id"]
        assert obslib.find_record(ours, tid) == \
            jax_obslib.find_record(theirs, tid)
        assert obslib.perfetto_events(record) == \
            jax_obslib.perfetto_events(record)
        for color in (True, False):
            assert obslib.format_line(record, color=color) == \
                jax_obslib.format_line(record, color=color)
    assert obslib.find_record(ours, "zz") is None
    for values, q in (([], 0.5), ([3.0, 1.0, 2.0], 0.5),
                      ([float(i) for i in range(20)], 0.95)):
        assert obslib.percentile(values, q) == \
            jax_obslib.percentile(values, q)


def test_perfetto_events_reconstruct_both_tracks():
    record = obslib.find_record(obslib.read_records(FIXTURE_LOG), TRACE_ID)
    events = obslib.perfetto_events(record)
    (span,) = [e for e in events if e["name"].startswith("fleet/request")]
    assert span["dur"] == pytest.approx(912.4 * 1000.0)
    replica = [e for e in events if e["ph"] == "X" and e.get("tid") == 1]
    assert [e["name"] for e in replica] == [
        "replica/queue", "replica/prefill", "replica/decode"]
    assert replica[0]["ts"] == pytest.approx(150.6 * 1000.0)


def test_cli_in_process_equals_trlx_tpu(tmp_path, capsys):
    from trlx_tpu.obs.__main__ import main as jax_obs_main

    runs = [["summarize", FIXTURE_LOG, "--json"],
            ["summarize", FIXTURE_LOG],
            ["trace", TRACE_ID, "--log", FIXTURE_LOG, "--no-color"],
            ["trace", "nope", "--log", FIXTURE_LOG],
            ["tail", FIXTURE_LOG, "-n", "3", "--no-follow", "--no-color"]]
    for argv in runs:
        rc = obs_main(argv)
        ours = capsys.readouterr()
        assert rc == jax_obs_main(argv), argv
        theirs = capsys.readouterr()
        assert ours.out == theirs.out, argv
        assert ours.err == theirs.err, argv
    out = {}
    for name, main in (("ours", obs_main), ("theirs", jax_obs_main)):
        path = str(tmp_path / f"{name}.json")
        assert main(["trace", TRACE_ID, "--log", FIXTURE_LOG,
                     "--perfetto", "-o", path]) == 0
        with open(path) as f:
            out[name] = json.load(f)
    assert out["ours"] == out["theirs"]
    assert any(e["name"] == "replica/decode"
               for e in out["ours"]["traceEvents"])


def run_cli(package, *argv):
    return subprocess.run(
        [sys.executable, "-m", f"{package}.obs", *argv],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
        env={**os.environ, "PYTHONPATH": str(REPO)})


def test_cli_subprocess_equals_trlx_tpu():
    """The CLI as a program: each command's output, exit code and error
    text equal trlx_tpu's."""
    for argv in (["summarize", FIXTURE_LOG, "--json"],
                 ["tail", FIXTURE_LOG, "--no-follow", "--no-color"],
                 ["trace", "nope", "--log", FIXTURE_LOG]):
        ours = run_cli("trlx_tpu_torch", *argv)
        theirs = run_cli("trlx_tpu", *argv)
        assert (ours.returncode, ours.stdout) == \
            (theirs.returncode, theirs.stdout), argv
        assert ours.stderr.replace("trlx_tpu_torch", "trlx_tpu") == \
            theirs.stderr, argv
    assert json.loads(run_cli("trlx_tpu_torch", "summarize", FIXTURE_LOG,
                              "--json").stdout)["totals"]["requests"] == 5


# --------------------------------------------------------------------- #
# the router's endpoints and its access log over stub replicas
# --------------------------------------------------------------------- #


def test_router_stitched_trace_endpoints_and_access_log(tmp_path):
    stubs = [_StubReplica(), _StubReplica()]
    telemetry.start()
    log_path = str(tmp_path / "access.jsonl")
    router = FleetRouter(RouterConfig(
        backends=[f"127.0.0.1:{s.port}" for s in stubs], port=0,
        page_size=64, probe_interval=30.0, probe_timeout=5.0,
        request_timeout=10.0, failover_backoff=0.01,
        trace_ring=8, access_log=log_path, access_log_sample=1)).start()
    try:
        tid = "feedfacecafebeef"
        status, _, headers = router.forward(
            {"tokens": [1, 2, 3], "max_new_tokens": 1}, trace_id=tid)
        assert status == 200 and headers["X-Request-Id"] == tid
        stubs[0].mode = stubs[1].mode = "e503"
        status, _, _ = router.forward({"tokens": [4], "max_new_tokens": 1},
                                      trace_id="deadbeef00000002")
        assert status == 503
        st, _, body = _http(router.port, f"/debug/trace/{tid}")
        assert st == 200 and body["trace_id"] == tid
        kinds = [e["event"] for e in body["events"]]
        assert kinds[:3] == ["pick", "attempt", "attempt_ok"]
        st, _, listing = _http(router.port, "/debug/trace")
        assert st == 200 and listing["traces"] == ["deadbeef00000002", tid]
        st, _, miss = _http(router.port, "/debug/trace/unknown00")
        assert st == 404 and "capacity 8" in miss["error"]
        st, _, slo = _http(router.port, "/debug/slo")
        assert st == 200 and slo["series"]
        assert all("backend" in s["labels"] for s in slo["series"])
        records = obslib.read_records(log_path)
        assert [r["trace_id"] for r in records] == [tid, "deadbeef00000002"]
        report = obslib.summarize(records)
        assert report == jax_obslib.summarize(records)
        counters = telemetry.current().registry.counters
        assert report["totals"]["requests"] == counters["router/requests"]
        assert report["totals"]["errors"] == 1
        assert report["totals"]["failovers"] == counters["router/failovers"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{router.port}/metrics",
            headers={"Accept": "text/plain"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            text = resp.read().decode()
        assert "trlx_tpu_router_requests_total 2.0" in text
        assert 'trlx_tpu_slo_goodput_5m{backend="http://' in text
    finally:
        router.stop()
        for s in stubs:
            s.stop()
        telemetry.start()


def test_router_trace_ring_disabled_is_a_typed_404():
    stub = _StubReplica()
    telemetry.start()
    router = FleetRouter(RouterConfig(
        backends=[f"127.0.0.1:{stub.port}"], port=0, page_size=64,
        probe_interval=30.0, probe_timeout=5.0, request_timeout=10.0,
        trace_ring=0, access_log="")).start()
    try:
        st, _, body = _http(router.port, "/debug/trace/whatever")
        assert st == 404 and "disabled" in body["error"]
        st, _, slo = _http(router.port, "/debug/slo")
        assert st == 200 and "series" in slo
    finally:
        router.stop()
        stub.stop()
        telemetry.start()
