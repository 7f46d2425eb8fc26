"""The port's phase spans (trlx_tpu_torch.telemetry) on the CPU:

- one clock: spans from ``span()`` and ``add_span()`` land, through the
  tracer's anchor, on the Unix-epoch clock ``torch.profiler`` stamps its
  events on, within 1 ms of ``time.time_ns()``, and carry the enclosing
  span on their thread as ``args.parent``; ``trace.jsonl`` opens with
  the anchor;
- a device phase creates no CUDA event and no ``record_function`` range
  while no profiler records, and opens the range and times a pair of
  events while one does (the events faked on the CPU), resolved into
  ``args.device_ms`` only once the device has passed the second;
- the ILQL trainer's ``step_events`` keep five events per update;
- a tiny slot-scheduler run spans each working turn as one
  ``serve/iteration`` with its ``serve/admit``, ``serve/slot_step`` and
  ``serve/harvest`` children, and each admission's ``positions`` /
  ``needed`` / ``hit`` add up to what the requests held;
- a tiny PPO ``make_experience`` emits the five rollout phases per chunk
  under ``rollout``;
- the benchmark's six readers of these spans (perfbench/metrics/) give
  the expected numbers on synthetic spans and a synthetic timeline, and
  None where there is nothing to read."""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.telemetry import tracer as tracer_mod
from trlx_tpu_torch.telemetry.registry import MetricsRegistry
from trlx_tpu_torch.telemetry.tracer import SpanTracer
from trlx_tpu_torch.utils.profiling import annotate


@pytest.fixture(autouse=True)
def _no_session():
    telemetry.stop()
    yield
    telemetry.stop()


# --------------------------------------------------------------------- #
# the clock and the parents
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["span", "add_span"])
def test_spans_land_on_the_profilers_clock_with_their_parent(kind,
                                                             tmp_path):
    tracer = SpanTracer(registry=MetricsRegistry())
    before = time.time_ns()
    with tracer.span("outer"):
        if kind == "span":
            with tracer.span("inner", {"chunk": 3}):
                time.sleep(0.002)
        else:
            start = time.monotonic()
            time.sleep(0.002)
            tracer.add_span("inner", start, time.monotonic(),
                            args={"chunk": 3})
    after = time.time_ns()
    events = {e["name"]: e for e in tracer.events}
    for name in ("outer", "inner"):
        start, end = tracer.epoch_ns(events[name])
        assert before - 1_000_000 <= start <= end <= after + 1_000_000
    inner = events["inner"]
    assert inner["args"]["chunk"] == 3
    assert 1.5e6 <= tracer.epoch_ns(inner)[1] - tracer.epoch_ns(inner)[0]
    if kind == "span":
        assert inner["args"]["parent"] == "outer"
    else:  # stamped elsewhere: no live parent
        assert "parent" not in inner["args"]
    assert "parent" not in events["outer"].get("args", {})
    assert abs(tracer.to_epoch_ns(time.monotonic()) - time.time_ns()) \
        < 1_000_000
    lines = [json.loads(x) for x in
             open(tracer.write_jsonl(str(tmp_path / "trace.jsonl")))]
    assert lines[0]["name"] == "clock_anchor" and lines[0]["ph"] == "M"
    assert lines[0]["args"]["epoch_ns"] == tracer.anchor_ns
    assert [e["name"] for e in lines[1:]] == [e["name"]
                                              for e in tracer.events]


def test_a_parent_is_the_enclosing_span_on_the_same_thread():
    tracer = SpanTracer()
    opened, release = threading.Event(), threading.Event()

    def other():
        with tracer.span("worker"):
            opened.set()
            release.wait(5)

    t = threading.Thread(target=other)
    t.start()
    opened.wait(5)
    with tracer.span("main"):
        with tracer.span("child"):
            pass
    release.set()
    t.join(5)
    by = {e["name"]: e.get("args", {}) for e in tracer.events}
    assert by["child"]["parent"] == "main"
    assert "parent" not in by["main"] and "parent" not in by["worker"]


# --------------------------------------------------------------------- #
# device phases: only while a profiler records
# --------------------------------------------------------------------- #


class _FakeEvent:
    """Stands in for a timing CUDA event on the CPU."""

    made = []

    def __init__(self):
        self.passed = False
        self.at = len(_FakeEvent.made)
        _FakeEvent.made.append(self)

    def query(self):
        return self.passed

    def elapsed_time(self, end):
        return 2.5 * (end.at - self.at)


@pytest.fixture
def fake_events(monkeypatch):
    _FakeEvent.made = []
    ranges = []
    real = torch.autograd.profiler.record_function

    class Counted(real):
        def __init__(self, name, *a, **kw):
            ranges.append(name)
            super().__init__(name, *a, **kw)

    monkeypatch.setattr(tracer_mod, "timing_event", _FakeEvent)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counted)
    return ranges


@pytest.mark.parametrize("entry", ["device_phase", "annotate"])
def test_a_phase_times_the_device_only_while_a_profiler_records(
        entry, fake_events):
    from torch.profiler import ProfilerActivity, profile

    session = telemetry.start()

    def phase(name):
        return telemetry.device_phase(name, rows=4) \
            if entry == "device_phase" else annotate(name)

    with phase("quiet"):
        pass
    assert _FakeEvent.made == [] and fake_events == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with phase("traced"):
            torch.ones(4).sum()
    assert fake_events == ["traced"] and len(_FakeEvent.made) == 2
    assert "traced" in {e.name for e in prof.events()}
    events = {e["name"]: e for e in session.tracer.events}
    assert "device_ms" not in events["traced"].get("args", {})
    assert "device_ms" not in events["quiet"].get("args", {})
    assert session.tracer.resolve_device() == 1  # not passed yet
    for ev in _FakeEvent.made:
        ev.passed = True
    with telemetry.span("host"):  # a host span never polls
        pass
    assert "device_ms" not in events["traced"]["args"]
    with telemetry.device_phase("later"):  # a later device phase polls
        pass
    assert events["traced"]["args"]["device_ms"] == 2.5
    assert session.tracer.resolve_device() == 0


def test_a_device_phase_ends_its_device_part_early(fake_events):
    """``end_device()`` records the pair's second event where it is
    called (before a read that waits for the device), once; with no
    profiler recording, or without a session, it does nothing."""
    from torch.profiler import ProfilerActivity, profile

    with telemetry.device_phase("alone") as phase:
        phase.end_device()
    session = telemetry.start()
    with telemetry.device_phase("quiet") as phase:
        phase.end_device()
    assert _FakeEvent.made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.device_phase("step") as phase:
            phase.end_device()
            phase.end_device()
            assert len(_FakeEvent.made) == 2
            _FakeEvent()  # work after the device part: not in its time
    assert len(_FakeEvent.made) == 3
    for ev in _FakeEvent.made:
        ev.passed = True
    session.tracer.resolve_device()
    step = next(e for e in session.tracer.events if e["name"] == "step")
    assert step["args"]["device_ms"] == 2.5


@pytest.mark.parametrize("device", [False, True])
def test_a_dropped_span_records_nothing(device, fake_events):
    from torch.profiler import ProfilerActivity, profile

    session = telemetry.start()
    enter = telemetry.device_phase if device else telemetry.span
    with profile(activities=[ProfilerActivity.CPU]):
        with enter("idle") as idle:
            idle.set(requests=0)
            idle.drop()
        with telemetry.span("after"):
            pass
    names = [e["name"] for e in session.tracer.events]
    assert names == ["after"]
    assert "parent" not in session.tracer.events[0].get("args", {})
    assert "time/idle" not in session.registry.hists
    assert session.tracer.resolve_device() == 0
    assert fake_events == (["idle"] if device else [])


def test_device_phases_from_many_threads_resolve_each_pair_once(
        monkeypatch):
    """Threads (more than cores) close device phases while others poll:
    every phase gets its device time, none is lost from the pending list
    or resolved twice."""
    import os
    import sys

    monkeypatch.setattr(tracer_mod, "timing_event", _FakeEvent)
    monkeypatch.setattr(tracer_mod, "profiler_recording", lambda: True)
    _FakeEvent.made = []
    tracer = SpanTracer()
    passed = [0]

    class Once(_FakeEvent):
        def elapsed_time(self, end):
            passed[0] += 1
            return 1.0

        def query(self):
            return True

    monkeypatch.setattr(tracer_mod, "timing_event", Once)
    workers, each = 2 * (os.cpu_count() or 2) + 2, 200

    def work():
        for _ in range(each):
            with tracer.span("phase", device=True):
                pass
            tracer.resolve_device()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert tracer.resolve_device() == 0
    phases = [e for e in tracer.events if e["name"] == "phase"]
    assert len(phases) == workers * each == passed[0]
    assert all(e["args"]["device_ms"] == 1.0 for e in phases)


def test_without_a_session_a_phase_opens_only_the_range(fake_events):
    from torch.profiler import ProfilerActivity, profile

    with telemetry.device_phase("alone"):
        pass
    assert fake_events == []
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.device_phase("alone"):
            pass
    assert fake_events == ["alone"] and _FakeEvent.made == []


def test_ilql_step_events_keep_five_events_per_update(monkeypatch):
    from tests.test_torch_ilql import _batch, _config_dict
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.ilql_types import ILQLBatch
    from trlx_tpu_torch.trainers import ilql_trainer
    from trlx_tpu_torch.utils.loading import get_model

    _FakeEvent.made = []
    monkeypatch.setattr(ilql_trainer, "timing_event", _FakeEvent)
    trainer = get_model("JaxILQLTrainer")(
        TRLConfig.from_dict(_config_dict()), device="cpu")
    batch = ILQLBatch(**{k: torch.from_numpy(v)
                         for k, v in _batch().items()})
    trainer.train_step(batch)
    assert _FakeEvent.made == []  # step_events None: nothing recorded
    trainer.step_events = []
    for _ in range(2):
        trainer.train_step(batch)
    assert [len(ev) for ev in trainer.step_events] == [5, 5]
    assert trainer.step_events[1] == _FakeEvent.made[5:]
    assert len(ilql_trainer.STEP_PARTS) == 4


# --------------------------------------------------------------------- #
# the serving scheduler's loop
# --------------------------------------------------------------------- #


def _tiny_scheduler():
    from tests.test_serve import tiny_config_dict
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.serve import InferenceEngine, ServeConfig
    from trlx_tpu_torch.serve import SlotScheduler

    engine = InferenceEngine(
        TRLConfig.from_dict(tiny_config_dict()),
        serve=ServeConfig(buckets=[[2, 8, 8], [4, 8, 8], [4, 16, 8]],
                          max_queue=64, slots=4, page_size=4),
        device="cpu")
    s = SlotScheduler(engine)
    s.warmup()
    return s


def test_slot_scheduler_spans_each_working_turn():
    session = telemetry.start()
    s = _tiny_scheduler()
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(0, 250, 8)]
    prompts = [(shared + [int(t) for t in rng.integers(0, 250, n)])[:15]
               for n in (3, 5, 2, 6, 4, 7)]
    s.start()
    try:
        first = s.submit(prompts[0], max_new_tokens=3)
        first.wait(timeout=60.0)  # its pages committed: the rest hit
        reqs = [s.submit(p, max_new_tokens=3) for p in prompts[1:]]
        for r in reqs:
            r.wait(timeout=60.0)
    finally:
        s.stop()
    events = [e for e in session.tracer.events if e["ph"] == "X"]
    turns = [e for e in events if e["name"] == "serve/iteration"]
    spans = {}
    for e in events:
        spans.setdefault(e["name"], []).append(e)
    steps = spans["serve/slot_step"]
    steps = [e for e in steps if e.get("args", {}).get("parent")]
    assert len(steps) == s.runtime.steps - 1  # warmup's step has none
    assert len(turns) >= len(steps)
    children = {}
    for name in ("serve/admit", "serve/slot_step", "serve/harvest"):
        for e in spans.get(name, []):
            parent = e.get("args", {}).get("parent")
            if parent is not None:
                assert parent == "serve/iteration", (name, parent)
                children.setdefault(name, []).append(e)
    assert len(children["serve/harvest"]) == len(steps)
    # every turn admitted or stepped: each holds one of those children
    held = [e for name in ("serve/admit", "serve/slot_step")
            for e in children[name]]
    for turn in turns:
        lo, hi = turn["ts"], turn["ts"] + turn["dur"]
        assert any(lo <= c["ts"] and c["ts"] + c["dur"] <= hi + 1e-3
                   for c in held), turn
    admits = [e["args"] for e in children["serve/admit"]
              if e["args"]["requests"]]
    assert sum(a["requests"] for a in admits) == len(prompts)
    for a in admits:
        assert a["positions"] >= a["needed"] > 0
        assert a["positions"] % 8 == 0  # Bp x P of its prompt classes
    hit = sum(a["hit"] for a in admits)
    assert hit > 0
    assert sum(a["needed"] for a in admits) + hit == sum(map(len, prompts))
    counters = session.registry.counters
    assert counters["serve/prefill_positions"] == sum(
        a["positions"] for a in admits)
    assert counters["serve/prefill_tokens_needed"] == sum(
        a["needed"] for a in admits)
    assert counters["serve/prefix_tokens_saved"] == hit


def test_an_admission_after_the_turns_snapshot_is_spanned():
    """A request that arrives after the loop's snapshot read an empty
    queue is still admitted in that turn: the turn is a
    ``serve/iteration`` holding its ``serve/admit``, and the spans' sums
    match the counters. A turn with nothing to do records no span."""
    session = telemetry.start()
    s = _tiny_scheduler()
    tracer = session.tracer
    before = len(tracer.events)
    s._turn(False, False, True)  # nothing queued, nothing live
    assert len(tracer.events) == before
    req = s.submit(list(range(1, 12)), max_new_tokens=2)
    s._turn(False, False, True)  # the snapshot predates the request
    turns = [e for e in tracer.events[before:]
             if e["name"] == "serve/iteration"]
    admits = [e for e in tracer.events[before:]
              if e["name"] == "serve/admit"]
    assert len(turns) == 1 and len(admits) == 1
    assert admits[0]["args"]["parent"] == "serve/iteration"
    a = admits[0]["args"]
    assert a["requests"] == 1 and a["needed"] == 11 and a["hit"] == 0
    counters = session.registry.counters
    assert counters["serve/prefill_positions"] == a["positions"] >= 11
    assert counters["serve/prefill_tokens_needed"] == 11
    for _ in range(8):
        if req.done.is_set():
            break
        assert s._turn(False, False, True)  # it stepped
    req.wait(timeout=0)
    ended = len(tracer.events)
    assert not s._turn(False, False, True)
    assert len(tracer.events) == ended


# --------------------------------------------------------------------- #
# the PPO rollout
# --------------------------------------------------------------------- #


ROLLOUT_PHASES = ("rollout/prefill", "rollout/decode", "rollout/score",
                  "rollout/reward_model", "rollout/harvest")


def test_make_experience_emits_five_phases_per_chunk_under_rollout():
    from tests.test_torch_reward import _ppo
    from trlx_tpu_torch.examples.ppo_tldr import build_reward_model

    _, cfg, trainer, get_orchestrator, get_pipeline, prompts, _ = _ppo()
    rm = build_reward_model(cfg, trainer, head_seed=3)
    pipeline = get_pipeline("PPOPipeline")(prompts, trainer.tokenizer, cfg)
    orch = get_orchestrator("PPOOrchestrator")(trainer, pipeline,
                                               reward_fn=rm, chunk_size=8)
    session = telemetry.current()
    n = len(session.tracer.events)
    orch.make_experience(24)
    events = session.tracer.events[n:]
    rollout = [e for e in events if e["name"] == "rollout"]
    assert len(rollout) == 1
    lo, hi = rollout[0]["ts"], rollout[0]["ts"] + rollout[0]["dur"]
    for name in ROLLOUT_PHASES:
        mine = [e for e in events if e["name"] == name]
        assert [e["args"]["chunk"] for e in mine] == [0, 1, 2], name
        for e in mine:
            assert e["args"]["rows"] == 8
            assert e["args"]["parent"] == "rollout"
            assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi + 1e-3
            assert "device_ms" not in e["args"]  # no profiler recorded


# --------------------------------------------------------------------- #
# the benchmark's readers of these spans
# --------------------------------------------------------------------- #


def _readings(window):
    from perfbench.harness import Readings
    from perfbench.tracing import Timeline

    return Readings(None, {}, Timeline(window, [], []), None)


def _synthetic_session():
    """A session whose tracer holds hand-made spans, 1 s after its
    anchor: a traced part from 1 s to 2 s."""
    session = telemetry.start()
    tr = session.tracer
    tr.events.clear()

    def add(name, at_ms, dur_ms, **args):
        tr.events.append({"name": name, "ph": "X", "ts": at_ms * 1e3,
                          "dur": dur_ms * 1e3, "pid": 0, "tid": 0,
                          "args": args})

    for chunk, (ms, rows) in enumerate([(40.0, 8), (20.0, 8)]):
        base = 1000 + 100 * chunk
        add("rollout/prefill", base, 5, chunk=chunk, rows=rows,
            device_ms=ms, parent="rollout")
        add("rollout/decode", base + 5, 5, chunk=chunk, rows=rows,
            device_ms=2 * ms, parent="rollout")
        add("rollout/score", base + 10, 5, chunk=chunk, rows=rows,
            device_ms=ms / 2, parent="rollout")
        add("rollout/reward_model", base + 15, 5, chunk=chunk, rows=rows,
            device_ms=ms / 4, parent="rollout")
    # outside the traced part: never read
    add("rollout/prefill", 500, 5, chunk=0, rows=8, device_ms=999.0)
    add("serve/admit", 2500, 1, requests=1, positions=1000, needed=0)
    # three turns with a step: host 4, 6 and 10 ms; one admits only
    for at, total, step in ((1200, 24, 20), (1300, 26, 20),
                            (1400, 30, 20)):
        add("serve/iteration", at, total)
        add("serve/slot_step", at + 2, step, parent="serve/iteration")
    add("serve/iteration", 1500, 3)
    add("serve/admit", 1500, 2, parent="serve/iteration", requests=2,
        positions=768, needed=192, hit=384)
    add("serve/admit", 1200, 1, parent="serve/iteration", requests=1,
        positions=256, needed=64, hit=0)
    return session


EXPECTED = {
    "ppo.prefill_ms_per_sample": 60.0 / 16,
    "ppo.decode_ms_per_sample": 120.0 / 16,
    "ppo.score_ms_per_sample": 30.0 / 16,
    "ppo.reward_ms_per_sample": 15.0 / 16,
    "serve.host_ms_per_step": 6.0,
    "serve.prefill_waste": 100.0 * (1 - 256 / 1024),
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_span_readers_on_synthetic_spans(metric):
    from perfbench.harness import load_module

    read = load_module("metrics", metric).read
    session = _synthetic_session()
    lo = session.tracer.anchor_ns + 1_000_000_000
    r = _readings((lo, lo + 1_000_000_000))
    assert read(r) == pytest.approx(EXPECTED[metric])
    # nothing to read: an empty traced part, no traced part, no session,
    # a program whose tracer has no clock anchor
    assert read(_readings((lo - 10**9 + 1, lo - 10**9 + 2))) is None
    assert read(_readings((0, 1))) is None
    r.timeline = None
    assert read(r) is None
    telemetry.stop()
    assert read(_readings((lo, lo + 1_000_000_000))) is None
    session = _synthetic_session()
    session.tracer = types.SimpleNamespace(events=session.tracer.events)
    assert read(_readings((lo, lo + 1_000_000_000))) is None
