"""The port's telemetry (trlx_tpu_torch.telemetry) against trlx_tpu's, on
the CPU:

- the registry: the same sequence of ``inc`` / ``set_gauge`` /
  ``observe`` with explicit durations gives equal ``summary()``,
  ``tracker_stats()`` and ``cumulative_buckets()``, and identical
  Prometheus text;
- the tracer: the same ``add_span`` / ``name_track`` calls, and the same
  ``span`` calls on a scripted clock, give identical trace JSONL;
- the analytic FLOPs agree integer for integer on gpt2-124M, the presets
  and the repo's configs; the peak table is NVIDIA's (H100 SXM 989e12),
  and off the card there is no peak, no MFU and no device gauge;
- the learn loop's emission (the repaired F1): a tiny PPO run in both
  packages, logged through ``tracker: "jsonl:<path>"``, gives records
  with the same key sets, ``time/ppo_update`` being the registry's LAST
  duration; the run writes ``telemetry.json`` and ``trace.jsonl`` under
  ``telemetry_dir`` (F3) with the reference's counter keys;
- the gates: ``telemetry: false`` records nothing, and the checkpoint
  dir fallback writes only once the directory exists."""

import json
import os
import types

import numpy as np
import pytest
import torch

from trlx_tpu import telemetry as jtel
from trlx_tpu.telemetry import flops as jflops
from trlx_tpu.telemetry import prometheus as jprom
from trlx_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from trlx_tpu.telemetry.tracer import SpanTracer as JaxTracer
from trlx_tpu_torch import telemetry
from trlx_tpu_torch.telemetry import device as tdevice
from trlx_tpu_torch.telemetry import flops as tflops
from trlx_tpu_torch.telemetry import prometheus as tprom
from trlx_tpu_torch.telemetry.registry import MetricsRegistry
from trlx_tpu_torch.telemetry.tracer import SpanTracer


@pytest.fixture(autouse=True)
def _no_session():
    telemetry.stop()
    jtel.stop()
    yield
    telemetry.stop()
    jtel.stop()


def _drive(registry, seed):
    """A seeded sequence of updates: counters (some labeled), gauges and
    durations spread over every latency bucket and past the last."""
    rng = np.random.default_rng(seed)
    registry.predeclare(("fault/stalls", "chaos/injections"))
    for i in range(60):
        kind = rng.integers(0, 3)
        name = ["fault/host_retries", "serve/requests", "time/rollout"][
            rng.integers(0, 3)]
        labels = {"path": "slots"} if rng.random() < 0.3 else None
        if kind == 0:
            registry.inc(name, float(rng.integers(1, 4)), labels=labels)
        elif kind == 1:
            registry.set_gauge(name, float(rng.standard_normal()),
                               labels=labels)
        else:
            registry.observe(name, float(10 ** rng.uniform(-3.5, 2.7)),
                             labels=labels)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_matches_reference(seed):
    ours, theirs = MetricsRegistry(), JaxRegistry()
    _drive(ours, seed)
    _drive(theirs, seed)
    assert ours.summary() == theirs.summary()
    assert ours.tracker_stats() == theirs.tracker_stats()
    assert ours.hists.keys() == theirs.hists.keys()
    for key, hist in ours.hists.items():
        assert hist.cumulative_buckets() == \
            theirs.hists[key].cumulative_buckets()
        assert hist.cumulative_buckets()[-1][1] <= hist.count
    assert tprom.render(ours) == jprom.render(theirs)
    assert tprom.sanitize("serve/ttft") == jprom.sanitize("serve/ttft")


def test_histograms_emit_last_and_keep_first_apart():
    reg = MetricsRegistry()
    for s in (0.5, 0.01, 0.02, 0.03, 0.04):
        reg.observe("time/step", s)
    assert reg.tracker_stats()["time/step"] == 0.04
    stats = reg.hists["time/step"].stats()
    assert stats["first_s"] == 0.5 and stats["count"] == 5
    assert stats["first_over_p50"] > 10
    assert stats["total_s"] == pytest.approx(0.6)


def _scripted_clock(times):
    it = iter(times)
    return lambda: next(it)


def test_tracer_writes_identical_jsonl(tmp_path):
    """The same calls give the reference's trace, but for what the port
    adds: the clock anchor first, each live span's parent, and
    ``add_span``'s stamps read on the tracer's own clock (the reference
    anchors them apart, at ``t0_monotonic``)."""
    times = [0.0] + [0.001 * i for i in range(1, 40)]
    ours = SpanTracer(registry=MetricsRegistry(), max_events=9,
                      clock=_scripted_clock(times))
    theirs = JaxTracer(registry=JaxRegistry(), max_events=9,
                       clock=_scripted_clock(times))
    theirs.t0_monotonic = 100.0
    for tracer, base in ((ours, 0.0), (theirs, 100.0)):
        with tracer.span("rollout"):
            with tracer.span("reward_fn"):
                pass
        tracer.name_track(7, "req 7")
        tracer.name_track(7, "again")  # once per tid
        for i in range(8):  # overflows the 9-event ring
            tracer.add_span("decode", base + 0.5 + i, base + 0.25 + 2 * i,
                            tid=7, args={"i": i})
    paths = [t.write_jsonl(str(tmp_path / f"{n}.jsonl"))
             for n, t in (("ours", ours), ("theirs", theirs))]
    mine, ref = ([json.loads(x) for x in open(p)] for p in paths)
    anchor = mine.pop(0)
    assert anchor == {"name": "clock_anchor", "ph": "M",
                      "pid": os.getpid(), "tid": 0,
                      "args": {"epoch_ns": ours.anchor_ns}}
    assert mine[0]["name"] == "reward_fn"
    assert mine[0]["args"].pop("parent") == "rollout"
    assert mine == ref
    assert "dropped" in mine[-1]["name"]
    assert ours.registry.counters["telemetry/trace_events_dropped"] == 1
    assert ours.registry.summary() == theirs.registry.summary()


def _specs():
    from trlx_tpu.data.configs import ModelSpec as JaxSpec
    from trlx_tpu_torch.data.configs import ModelSpec

    for name in ("gpt2", "gpt2-medium", "gpt2-large", "gpt2-xl",
                 "gpt-j-6b", "llama-2-7b", "llama-3-8b"):
        yield ModelSpec.preset(name), JaxSpec.preset(name)


def _flops(mod, spec, k, two_qs):
    return (mod.ppo_train_flops_per_token(spec, k),
            mod.ilql_train_flops_per_token(spec, k, two_qs),
            mod.decode_flops_per_token(spec),
            mod.kv_bytes_per_token(spec, "bf16"),
            mod.kv_bytes_per_token(spec, "int8"))


def test_flops_match_reference_on_presets():
    for ours, theirs in _specs():
        for k in (-1, 0, 1, 2):
            for two_qs in (True, False):
                a = _flops(tflops, ours, k, two_qs)
                b = _flops(jflops, theirs, k, two_qs)
                assert a == b and all(isinstance(x, int) for x in a)


CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
_MODEL_PATH_PRESET = {"gpt2": "gpt2", "lvwerra/gpt2-imdb": "gpt2",
                      "EleutherAI/gpt-j-6B": "gpt-j-6b"}


@pytest.mark.parametrize("name", sorted(os.listdir(CONFIGS)))
def test_flops_match_reference_on_repo_configs(name):
    from trlx_tpu.data.configs import ModelSpec as JaxSpec
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu_torch.data.configs import ModelSpec, TRLConfig

    path = os.path.join(CONFIGS, name)
    cfg, jcfg = TRLConfig.load_yaml(path), JaxConfig.load_yaml(path)
    if cfg.model.model_spec is not None:
        ours, theirs = cfg.model.resolve_spec(), jcfg.model.resolve_spec()
    else:
        preset = _MODEL_PATH_PRESET[cfg.model.model_path]
        ours, theirs = ModelSpec.preset(preset), JaxSpec.preset(preset)
    k = cfg.model.num_layers_unfrozen
    two_qs = getattr(cfg.method, "two_qs", True)
    assert _flops(tflops, ours, k, two_qs) == _flops(jflops, theirs, k,
                                                     two_qs)


def test_peak_table_is_the_cards_and_absent_off_the_card():
    assert tflops.PEAK_FLOPS["NVIDIA H100 80GB HBM3"] == 989e12
    assert not set(tflops.PEAK_FLOPS) & set(jflops.PEAK_FLOPS)
    assert tflops.peak_flops(torch.device("cpu")) is None
    assert tflops.mfu_estimate(1e6, 1e9, torch.device("cpu")) is None
    if not torch.cuda.is_available():
        assert tflops.peak_flops() is None
        reg = MetricsRegistry()
        tdevice.sample_device_stats(reg)
        assert reg.gauges == {} and tdevice._available is False


def test_disabled_records_nothing_and_gates_resolve_the_run_dir(tmp_path):
    with telemetry.span("rollout"):
        telemetry.inc("fault/skipped_steps")
        telemetry.set_gauge("g", 1.0)
        telemetry.observe("time/x", 0.5)
    assert telemetry.current() is None and telemetry.summary() == {}
    assert telemetry.prometheus_text() == ""
    off = types.SimpleNamespace(train=types.SimpleNamespace(
        telemetry=False, checkpoint_dir="ckpts"))
    assert telemetry.start_from_config(off) is None
    cfg = types.SimpleNamespace(train=types.SimpleNamespace(
        telemetry=True, telemetry_dir="",
        checkpoint_dir=str(tmp_path / "ckpt")))
    session = telemetry.start_from_config(cfg)
    assert session.run_dir == cfg.train.checkpoint_dir
    assert not session.force_dir and session.write() is None
    os.makedirs(cfg.train.checkpoint_dir)
    assert session.write()["summary"].endswith("telemetry.json")
    cfg.train.telemetry_dir = str(tmp_path / "tel")
    session = telemetry.start_from_config(cfg)
    assert session.force_dir
    with telemetry.span("ppo_update"):
        pass
    paths = session.write()
    summary = json.load(open(paths["summary"]))
    assert summary["timings"]["time/ppo_update"]["count"] == 1
    assert set(summary["counters"]) == set(jtel._PREDECLARED_COUNTERS)
    assert "trlx_tpu_fault_stalls_total 0.0" in telemetry.prometheus_text()


# --------------------------------------------------------------------- #
# the learn loop's emission in both packages (F1, F2, F3)
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """A tiny PPO run in each package (tests/test_telemetry.py's smoke
    configuration), learn() called WITHOUT a log_fn so the emissions go
    through ``train.tracker = "jsonl:<run>/metrics.jsonl"``, with
    ``telemetry_dir`` the same run directory."""
    from tests.test_ppo_e2e import PROMPTS, make_config, reward_fn
    from trlx_tpu.utils import loading as jloading
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils import loading

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs = {}
    for name, load, port in (("jax", jloading, False),
                             ("torch", loading, True)):
        run = str(tmp_path_factory.mktemp(name))
        config = make_config(total_steps=4, epochs=2, ppo_epochs=1,
                             num_rollouts=32, chunk_size=16, batch_size=16)
        config.train.log_interval = 1
        config.train.telemetry_dir = run
        config.train.tracker = f"jsonl:{run}/metrics.jsonl"
        kwargs = {}
        if port:
            config = TRLConfig.from_dict(config.to_nested_dict())
            kwargs = {"device": "cpu"}
        trainer = load.get_model(config.model.model_type)(config, **kwargs)
        pipeline = load.get_pipeline("PPOPipeline")(PROMPTS,
                                                    trainer.tokenizer, config)
        orch = load.get_orchestrator("PPOOrchestrator")(
            trainer, pipeline, reward_fn=reward_fn, chunk_size=16)
        orch.make_experience(32)
        trainer.learn()
        session = (telemetry if port else jtel).current()
        with open(os.path.join(run, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        runs[name] = {"run": run, "records": records,
                      "hists": session.registry.hists}
    telemetry.stop()
    jtel.stop()
    torch.set_num_threads(threads)
    return runs


#: the counters the port's rollout decode adds: its steps by the path
#: their attention took
ROLLOUT_COUNTERS = {"rollout/decode_kernel_steps",
                    "rollout/decode_plain_steps"}

#: the keys the port's rollout phases add to an emission (the reward
#: here is a host ``reward_fn``: no ``rollout/reward_model``)
ROLLOUT_PHASE_KEYS = {
    key for phase in ("prefill", "decode", "score", "harvest")
    for key in (f"time/rollout/{phase}",
                f"compile/rollout/{phase}_first_s")} | ROLLOUT_COUNTERS


def test_f1_per_iteration_keys_match_reference(tiny_runs):
    ours, theirs = tiny_runs["torch"]["records"], tiny_runs["jax"]["records"]
    assert len(ours) == len(theirs) == 5  # 4 iterations + one refresh
    for a, b in zip(ours, theirs):
        # the port adds its rollout phases (``time/rollout/*`` and their
        # first-call gauges); every key of the reference's is there
        assert set(b) <= set(a)
        assert set(a) - set(b) <= ROLLOUT_PHASE_KEYS, set(a) - set(b)
    iters = [r for r in ours if "loss" in r]
    assert [r["iter"] for r in iters] == [1, 2, 3, 4]
    for key in ("throughput/samples_per_sec", "throughput/tokens_per_sec",
                "time/rollout", "time/reward_fn", "compile/ppo_update_first_s",
                "fault/stalls", "fault/host_retries"):
        assert key in iters[-1], key
    hist = tiny_runs["torch"]["hists"]["time/ppo_update"]
    # the LAST duration, not the running total (the F1 repair)
    assert iters[-1]["time/ppo_update"] == hist.last
    assert hist.count == 4 and hist.last < hist.total
    assert iters[0]["time/ppo_update"] == hist.first


def test_f2_jsonl_tracker_holds_every_emission(tiny_runs):
    records = tiny_runs["torch"]["records"]
    # iterations 1-2, the refresh after the first epoch, iterations 3-4
    assert [r.get("iter") for r in records] == [1, 2, 2, 3, 4]
    assert "rollouts" in records[2] and "loss" not in records[2]
    assert all(isinstance(v, (int, float)) for r in records
               for v in r.values())


def test_f3_run_dir_holds_summary_and_trace(tiny_runs):
    summaries = {}
    for name in ("torch", "jax"):
        run = tiny_runs[name]["run"]
        with open(os.path.join(run, "telemetry.json")) as f:
            summaries[name] = json.load(f)
        with open(os.path.join(run, "trace.jsonl")) as f:
            events = [json.loads(line) for line in f]
        if name == "torch":  # the port's clock anchor opens the file
            assert events.pop(0)["name"] == "clock_anchor"
        names = {e["name"] for e in events}
        assert {"rollout", "reward_fn", "ppo_update",
                "rollout_refresh"} <= names, (name, names)
        assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    ours, theirs = summaries["torch"], summaries["jax"]
    assert ours["metric"] == theirs["metric"] == "ppo_learn_samples_per_sec"
    assert ours["unit"] == "samples/s" and ours["value"] > 0
    counters = {k: v for k, v in ours["counters"].items()
                if k not in ROLLOUT_COUNTERS}
    assert set(ours["counters"]) - set(counters) == ROLLOUT_COUNTERS
    assert counters == theirs["counters"]  # all zero here
    # 4 + 8 keys: no page size divides them, so the plain path
    assert ours["counters"]["rollout/decode_kernel_steps"] == 0
    assert ours["counters"]["rollout/decode_plain_steps"] > 0
    extra = set(ours["timings"]) - set(theirs["timings"])
    assert set(theirs["timings"]) <= set(ours["timings"])
    assert extra == {k for k in ROLLOUT_PHASE_KEYS if k.startswith("time/")}
    assert ours["timings"]["time/ppo_update"]["count"] == 4
