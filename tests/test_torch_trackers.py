"""The port's trackers (trlx_tpu_torch.utils.trackers) against
trlx_tpu's, on the CPU:

- the print sink's text, the JSONL sink's file (its parent directory
  made at the first emission, fsynced at ``finish``), the table helpers
  and the wandb sink's step reuse (on a stub) are the reference's;
- ``make_tracker``: print, none, ``jsonl:<path>``, and ``wandb``
  falling back to print with the notice (the package is absent here,
  as on the card's machine); nothing off the main process;
- ``ResilientTracker``: the same failing sink gives the same
  ``fault/tracker_*`` counters, a hung sink is timed out and degrades,
  the ``tracker`` chaos seam consumes retries, ``finish`` also finishes
  the failed sink;
- the ILQL learn loop, one warm stack in each package: it logs through
  ``train.tracker`` (the repaired F2) with the reference's record keys
  and writes ``telemetry.json`` and ``trace.jsonl`` in its run dir
  (F3); and the supervisor's drills on it (a hung eval reward attempt,
  an update SIGTERM, the walltime, a permanent stall) give the
  reference's counters."""

import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

import trlx_tpu.utils.trackers as jtrk
import trlx_tpu_torch.utils.trackers as trk
from trlx_tpu import telemetry as jtel
from trlx_tpu.supervisor import chaos as jchaos
from trlx_tpu_torch import telemetry
from trlx_tpu_torch.supervisor import chaos


@pytest.fixture(autouse=True)
def _clean():
    for tel, ch in ((telemetry, chaos), (jtel, jchaos)):
        tel.stop()
        ch.reset()
    yield
    for tel, ch in ((telemetry, chaos), (jtel, jchaos)):
        tel.stop()
        ch.reset()


STATS = [
    {"iter": 3, "loss": 0.123456, "note": "x",
     "generations_table": {"columns": ["query", "response", "score"],
                           "rows": [["a" * 100, "b", 1.0],
                                    ["q", "r", np.float32(0.5)]]}},
    {"iter": 4, "loss": np.float32(0.25), "samples_per_sec": 12.0,
     "samples": ["s1", "s2"]},
    {"mean_score": 0.5,
     "samples_table": {"columns": ["sample"], "rows": [["x"]] * 6}},
]


def test_print_tracker_matches_reference(capsys):
    texts = []
    for mod in (trk, jtrk):
        tracker = mod.PrintTracker()
        for stats in STATS:
            tracker(stats)
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1]
    assert "'loss': 0.12346" in texts[0] and "a" * 61 + "..." in texts[0]


def test_jsonl_tracker_matches_reference(tmp_path):
    texts = []
    for name, mod in (("ours", trk), ("theirs", jtrk)):
        path = str(tmp_path / name / "runs" / "x" / "log.jsonl")
        tracker = mod.JsonlTracker(path)  # the directory does not exist
        for stats in STATS:
            tracker(stats)
        tracker.finish()
        texts.append(open(path).read())
    assert texts[0] == texts[1]
    assert [json.loads(x).get("iter") for x in texts[0].splitlines()] == \
        [3, 4, None]
    trk.JsonlTracker(str(tmp_path / "never" / "log.jsonl")).finish()
    assert not (tmp_path / "never").exists()


def test_tables_and_multi_tracker_match_reference(tmp_path):
    args = (["q1", "q2"], ["r1", "r2"], [2.0, np.float32(1.5)])
    assert trk.generations_table(*args) == jtrk.generations_table(*args)
    samples = [f"s{i}" for i in range(200)]
    for rewards in (None, list(range(200))):
        ours = trk.samples_table(samples, rewards)
        assert ours == jtrk.samples_table(samples, rewards)
        assert len(ours["rows"]) == 128
    path = str(tmp_path / "m.jsonl")
    multi = trk.MultiTracker(trk.JsonlTracker(path), None)
    multi({"iter": 7})
    multi.finish()
    assert json.loads(open(path).read())["iter"] == 7


def test_wandb_tracker_reuses_last_step_like_reference():
    logged = {"ours": [], "theirs": []}

    def stub(into):
        class _Wandb:
            @staticmethod
            def log(payload, step=None):
                into.append((sorted(payload), step))

            class Table:
                def __init__(self, columns, rows):
                    self.columns, self.rows = columns, rows

        return _Wandb

    for name, mod in (("ours", trk), ("theirs", jtrk)):
        tracker = mod.WandbTracker.__new__(mod.WandbTracker)
        tracker._wandb = stub(logged[name])
        tracker._last_step = None
        for stats in STATS + [{"eval_only": 1.0}]:
            tracker(stats)
    assert logged["ours"] == logged["theirs"]
    assert [s for _, s in logged["ours"]] == [3, 4, 4, 4]


def test_make_tracker_kinds(tmp_path, monkeypatch, capsys):
    assert isinstance(trk.make_tracker(kind="print"), trk.PrintTracker)
    trk.make_tracker(kind="none")({"iter": 1})
    sink = trk.make_tracker(kind=f"jsonl:{tmp_path}/a/x.jsonl")
    assert isinstance(sink, trk.ResilientTracker)
    sink({"iter": 1})
    assert (tmp_path / "a" / "x.jsonl").exists()
    if importlib.util.find_spec("wandb") is None:
        sink = trk.make_tracker(kind="wandb")  # the package is absent
    else:
        def boom(*a, **k):
            raise ImportError("no wandb")

        monkeypatch.setattr(trk, "WandbTracker", boom)
        sink = trk.make_tracker(kind="wandb")
    sink({"iter": 1, "loss": 1.0})
    out = capsys.readouterr().out
    assert "falling back to stdout" in out and "'loss': 1.0" in out
    import trlx_tpu_torch.utils as tutils

    monkeypatch.setattr(tutils, "is_main_process", lambda: False)
    quiet = trk.make_tracker(kind=f"jsonl:{tmp_path}/b.jsonl")
    quiet({"iter": 1})
    assert not (tmp_path / "b.jsonl").exists()


class _AlwaysFails:
    def __init__(self):
        self.calls = 0
        self.finished = False

    def __call__(self, stats):
        self.calls += 1
        raise ConnectionError("api down")

    def finish(self):
        self.finished = True


def test_resilient_tracker_counters_match_reference(capsys):
    runs = []
    for tel, mod in ((telemetry, trk), (jtel, jtrk)):
        session = tel.start()
        inner = _AlwaysFails()
        tracker = mod.ResilientTracker(inner, retries=1, backoff=0.0,
                                       max_consecutive_failures=2)
        for i in range(4):
            tracker({"iter": i})
        tracker.finish()
        runs.append((inner.calls, inner.finished, tracker.degraded,
                     dict(session.registry.counters)))
    capsys.readouterr()
    assert runs[0] == runs[1]
    calls, finished, degraded, counters = runs[0]
    assert (calls, finished, degraded) == (4, True, True)
    assert counters["fault/tracker_emissions_lost"] == 2
    assert counters["fault/tracker_degraded"] == 1
    assert counters["fault/host_retries"] == 2
    assert counters["fault/host_giveups"] == 2


def test_resilient_tracker_bounds_a_hung_sink_and_drills_the_seam(capsys):
    session = telemetry.start()
    release = threading.Event()
    tracker = trk.ResilientTracker(lambda stats: release.wait(10),
                                   retries=0, backoff=0.0,
                                   max_consecutive_failures=1, timeout=0.1)
    tracker({"iter": 1})
    release.set()
    assert tracker.degraded
    assert session.registry.counters["fault/seam_timeouts"] == 1
    assert session.registry.counters["fault/tracker_degraded"] == 1

    runs = []
    for tel, ch, mod in ((telemetry, chaos, trk), (jtel, jchaos, jtrk)):
        session = tel.start()
        ch.configure("tracker:exc@1,2")
        got = []
        tracker = mod.ResilientTracker(got.append, retries=1, backoff=0.0)
        for i in range(3):
            tracker({"iter": i})
        runs.append((got, dict(session.registry.counters)))
    capsys.readouterr()
    assert runs[0] == runs[1]
    got, counters = runs[0]
    assert got == [{"iter": 1}, {"iter": 2}]  # the first emission lost
    assert counters["chaos/injections"] == 2
    assert counters["fault/tracker_emissions_lost"] == 1


# --------------------------------------------------------------------- #
# the ILQL learn loop's run floor, in both packages: train.tracker (F2),
# the run dir (F3) and the supervisor's drills
# --------------------------------------------------------------------- #


class _IlqlStack:
    """One warm supervised ILQL stack (tiny random walks) of one package,
    with that package's telemetry, chaos and checkpoint modules."""

    def __init__(self, pkg, base):
        from tests.test_torch_ilql import _config_dict
        from trlx_tpu_torch.examples.randomwalks_data import (
            generate_random_walks,
        )

        if pkg == "jax":
            from trlx_tpu.data.configs import TRLConfig
            from trlx_tpu.utils import checkpoint, loading
            self.tel, self.chaos, kwargs = jtel, jchaos, {}
        else:
            from trlx_tpu_torch.data.configs import TRLConfig
            from trlx_tpu_torch.utils import checkpoint, loading
            self.tel, self.chaos = telemetry, chaos
            kwargs = {"device": "cpu"}
        self.pkg, self.base, self.checkpoint = pkg, base, checkpoint
        walks, logit_mask, stats_fn, reward_fn = generate_random_walks(
            seed=3, n_walks=32)
        cfg = _config_dict(epochs=10)
        cfg["model"]["model_spec"]["vocab_size"] = logit_mask.shape[0]
        # one of the two layers unfrozen: at full unfreeze the frozen
        # trunk has zero-size leaves, which the reference's checkpoint
        # save refuses (tests/test_faults.py::
        # test_save_restore_zero_size_leaves)
        cfg["model"]["num_layers_unfrozen"] = 1
        cfg["train"].update(
            log_interval=1, eval_interval=2, host_retries=2,
            host_retry_backoff=0.0, stall_timeout=0.25,
            stall_first_timeout=0.25, stall_grace=600.0,
            host_call_timeout=0.5,
            tracker=f"jsonl:{base}/{pkg}/metrics.jsonl")
        self.config = TRLConfig.from_dict(cfg)
        self.trainer = loading.get_model("JaxILQLTrainer")(
            self.config, logit_mask=logit_mask, **kwargs)
        loading.get_orchestrator("OfflineOrchestrator")(
            self.trainer, walks, np.arange(1, 5).reshape(-1, 1),
            reward_fn=reward_fn, stats_fn=stats_fn)

    def drill(self, name, schedule="", tracker=False, **train):
        """Four more updates through learn() (evals at even steps) with
        ``schedule`` installed, a fresh telemetry session and run
        directory ``<base>/<pkg>/<name>``; learn() logs through
        ``train.tracker`` when ``tracker``. Returns (logs, counters of
        the run's telemetry.json)."""
        t, tr = self.config.train, self.trainer
        run = os.path.join(self.base, self.pkg, name)
        for k, v in {"stall_timeout": 0.25, "max_walltime": 0.0,
                     "host_retries": 2, "eval_interval": 2,
                     **train}.items():
            setattr(t, k, v)
        t.checkpoint_dir = t.telemetry_dir = run
        self.tel.start_from_config(self.config)
        self.chaos.configure(schedule)
        t.total_steps = tr.iter_count + 4
        logs = []
        try:
            tr.learn() if tracker else tr.learn(log_fn=logs.append)
        finally:
            self.chaos.reset()
        with open(os.path.join(run, "telemetry.json")) as f:
            return logs, json.load(f)["counters"]

    def latest_step(self):
        found = self.checkpoint.find_latest_checkpoint(
            self.config.train.checkpoint_dir)
        return found and int(os.path.basename(found).split("_")[1])


@pytest.fixture(scope="module")
def ilql(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    base = str(tmp_path_factory.mktemp("ilql"))
    yield {pkg: _IlqlStack(pkg, base) for pkg in ("jax", "torch")}
    torch.set_num_threads(threads)


#: counters that depend on timing (a stall dump also counts a slow
#: first call, and JAX's first calls compile)
TIMING_COUNTERS = ("fault/stalls",)


def _same_counters(runs):
    ours, theirs = runs["torch"], runs["jax"]
    assert set(ours) == set(theirs)
    for key in ours:
        if key not in TIMING_COUNTERS:
            assert ours[key] == theirs[key], (key, ours[key], theirs[key])
    return ours


def test_ilql_learn_logs_through_the_configured_tracker(ilql):
    """learn() with no log_fn: the records in ``train.tracker``'s file
    have the reference's keys, and telemetry.json and trace.jsonl land
    in the run dir."""
    runs = {}
    for pkg, stack in ilql.items():
        stack.drill("tracker", tracker=True)
        run = stack.config.train.checkpoint_dir
        with open(os.path.join(stack.base, pkg, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        with open(os.path.join(run, "telemetry.json")) as f:
            summary = json.load(f)
        with open(os.path.join(run, "trace.jsonl")) as f:
            names = {json.loads(line)["name"] for line in f}
        runs[pkg] = (records, summary, names)
    (ours, summary, names), (theirs, jsummary, _) = runs["torch"], \
        runs["jax"]
    assert len(ours) == len(theirs) == 6  # 4 updates, evals at 0 and 2
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
    updates = [r for r in ours if "loss" in r]
    assert [r["iter"] for r in updates] == [1, 2, 3, 4]
    for key in ("time/ilql_update", "throughput/tokens_per_sec",
                "fault/stalls", "compile/ilql_update_first_s"):
        assert key in updates[-1], key
    assert sum("reward" in r for r in ours) == 2
    assert summary["metric"] == "ilql_learn_samples_per_sec"
    assert summary["timings"]["time/ilql_update"]["count"] == 4
    assert {"eval", "reward_fn", "ilql_update"} <= names
    assert set(summary["counters"]) == set(jsummary["counters"])
    assert set(summary["timings"]) == set(jsummary["timings"])


def test_ilql_drills_match_reference(ilql, capfd):
    """The eval's hung reward attempt is timed out, retried and the run
    completes; an update SIGTERM is a preemption checkpoint; the
    walltime stops after one update; every reward attempt hanging raises
    StallError with a checkpoint at the stall step. Both packages, equal
    counters but the timing ones."""
    from trlx_tpu import supervisor as jsupervisor
    from trlx_tpu_torch import supervisor

    runs = {}
    for pkg, stack in ilql.items():
        start = stack.trainer.iter_count
        logs, runs[pkg] = stack.drill("hung", "reward_fn:hang=30@1")
        assert stack.trainer.iter_count == start + 4
        assert sum("reward" in s for s in logs) == 2
    counters = _same_counters(runs)
    assert counters["fault/seam_timeouts"] == 1
    assert counters["fault/host_retries"] == 1 and counters["fault/stalls"]
    err = capfd.readouterr().err
    assert "'reward_fn'" in err and "MainThread" in err

    for pkg, stack in ilql.items():
        logs, runs[pkg] = stack.drill("sigterm", "ilql_update:sigterm@1",
                                      stall_timeout=0.0)
        assert any(s.get("preempted") for s in logs)
        assert stack.latest_step() == stack.trainer.iter_count
    assert _same_counters(runs)["fault/preempt_sigterm"] == 1

    for pkg, stack in ilql.items():
        before = stack.trainer.iter_count
        logs, runs[pkg] = stack.drill("walltime", stall_timeout=0.0,
                                      max_walltime=0.001)
        assert stack.trainer.iter_count == before + 1
        assert any(s.get("walltime_exceeded") for s in logs)
    assert _same_counters(runs)["fault/walltime_exits"] == 1

    for pkg, stack in ilql.items():
        error = (supervisor if pkg == "torch" else jsupervisor).StallError
        with pytest.raises(error):
            stack.drill("stall", "reward_fn:hang=30@*", host_retries=0,
                        eval_interval=1)
        with open(os.path.join(stack.config.train.checkpoint_dir,
                               "telemetry.json")) as f:
            runs[pkg] = json.load(f)["counters"]
        assert stack.latest_step() == stack.trainer.iter_count
    assert _same_counters(runs)["fault/host_giveups"] == 1
