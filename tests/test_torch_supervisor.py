"""The port's run supervisor (trlx_tpu_torch.supervisor, utils.faults
``retry_call``) against trlx_tpu's, on the CPU:

- bounded seams, ``retry_call``'s counters for the same failure
  sequence, and the seam-timeout knob, each equal to the reference's;
- chaos: ``parse_schedule`` and the fire sequences agree on the
  reference test's specs, the environment overrides ``train.chaos``,
  ``reset`` releases in-flight hangs;
- the watchdog (tests/test_supervisor.py's units): a stall dumps every
  thread's stack and counts, the first call has its own budget,
  ``beat`` defers, other threads do not reach the stack, escalation
  through an injected ``exit_fn`` (75 with the rescue, 70 without),
  inert when disabled, the walltime deadline;
- end to end on a tiny PPO in BOTH packages, one warm stack each, a
  fresh telemetry session per drill: a hung ``reward_fn`` that completes,
  a permanent stall (checkpoint at the stall step, StallError, resume),
  the walltime stop, a chaos SIGTERM, a bounded ``checkpoint_save``
  seam: the counter key sets of the two ``telemetry.json`` files are
  equal, and so are the counters that do not depend on timing. (The
  same drills on a tiny ILQL are in tests/test_torch_trackers.py, with
  that loop's tracker run.)"""

import contextlib
import io
import json
import os
import threading
import time
import types

import pytest
import torch

from trlx_tpu import supervisor as jsupervisor
from trlx_tpu import telemetry as jtel
from trlx_tpu.supervisor import chaos as jchaos
from trlx_tpu.utils import faults as jfaults
from trlx_tpu_torch import supervisor, telemetry
from trlx_tpu_torch.supervisor import (
    RunSupervisor,
    SeamTimeout,
    StallError,
    bounded_call,
    chaos,
    seam_timeout,
)
from trlx_tpu_torch.utils.faults import retry_call


@pytest.fixture(autouse=True)
def _clean():
    for tel, ch in ((telemetry, chaos), (jtel, jchaos)):
        tel.stop()
        ch.reset()
    yield
    for tel, ch in ((telemetry, chaos), (jtel, jchaos)):
        tel.stop()
        ch.reset()


# --------------------------------------------------------------------- #
# bounded seams and retry_call
# --------------------------------------------------------------------- #


def test_bounded_call_passthrough_exceptions_and_timeout():
    assert bounded_call(lambda: 42, timeout=1.0) == 42
    assert bounded_call(lambda: 42, timeout=0.0) == 42  # 0 = unbounded

    def boom():
        raise ValueError("from worker")

    with pytest.raises(ValueError, match="from worker"):
        bounded_call(boom, timeout=1.0)
    tel = telemetry.start()
    with pytest.raises(SeamTimeout) as exc:
        bounded_call(lambda: time.sleep(10), timeout=0.1, label="reward_fn")
    assert "reward_fn" in str(exc.value) and "hung" in str(exc.value)
    assert isinstance(exc.value, StallError)
    assert isinstance(exc.value, TimeoutError)
    assert tel.registry.counters["fault/seam_timeouts"] == 1


def _scripted(seq):
    """A seam that follows ``seq``: "fail" raises, "hang" sleeps past the
    timeout, "ok" answers."""
    calls = {"n": 0}

    def seam(x):
        step = seq[min(calls["n"], len(seq) - 1)]
        calls["n"] += 1
        if step == "fail":
            raise RuntimeError("transient")
        if step == "hang":
            time.sleep(2)
        return x

    return seam, calls


@pytest.mark.parametrize("seq,retries", [
    (("ok",), 2), (("fail", "ok"), 2), (("fail", "fail", "ok"), 2),
    (("fail", "fail", "fail"), 2), (("hang", "ok"), 1),
    (("hang", "hang"), 1), (("fail",), 0),
])
def test_retry_call_counters_match_reference(seq, retries):
    """The same failure sequence through both packages' ``retry_call``
    (timeout 0.1 s, no backoff): the same outcome, the same number of
    calls, equal counters."""
    outcomes = []
    for tel, fn in ((telemetry, retry_call), (jtel, jfaults.retry_call)):
        session = tel.start()
        seam, calls = _scripted(seq)
        try:
            result = fn(seam, 7, retries=retries, backoff=0.0,
                        timeout=0.1, log=lambda m: None)
        except (RuntimeError, TimeoutError) as e:
            result = type(e).__name__
        outcomes.append((result, calls["n"], session.registry.counters))
    (ours, n_ours, c_ours), (theirs, n_theirs, c_theirs) = outcomes
    assert ours == theirs and n_ours == n_theirs
    assert c_ours == c_theirs


@pytest.mark.parametrize("hint", [0.0, "callable"])
def test_retry_after_hint_paces_like_reference(hint):
    """A server-provided ``retry_after_s`` (a float, or a callable of the
    attempt's exception) replaces the jitter: with a 10 s backoff and a
    0 s hint, both packages retry at once, with equal counters."""
    runs = []
    for tel, fn in ((telemetry, retry_call), (jtel, jfaults.retry_call)):
        session = tel.start()
        seam, calls = _scripted(("fail", "fail", "ok"))
        pace = (lambda e: 0.0 if "transient" in str(e) else None) \
            if hint == "callable" else hint
        t0 = time.monotonic()
        assert fn(seam, 7, retries=2, backoff=10.0, retry_after_s=pace,
                  log=lambda m: None) == 7
        assert time.monotonic() - t0 < 5
        runs.append((calls["n"], session.registry.counters))
    assert runs[0] == runs[1] and runs[0][0] == 3


def test_seam_timeout_knob_resolution():
    t = types.SimpleNamespace(host_call_timeout=0.0, stall_timeout=0.0)
    for fn in (seam_timeout, jsupervisor.seam_timeout):
        t.host_call_timeout, t.stall_timeout = 0.0, 0.0
        assert fn(t) == 0.0
        t.stall_timeout = 30.0
        assert fn(t) == 30.0
        t.host_call_timeout = 5.0
        assert fn(t) == 5.0


# --------------------------------------------------------------------- #
# chaos
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("spec", [
    "reward_fn:hang=30@3;ppo_update:exc@1,2;rollout:slow=0.5@2-4;"
    "eval:sigterm",
    "reward_fn:exc@1,2", "rollout:slow=0.1@1", "eval:exc@1",
    "ilql_update:sigterm@2;checkpoint_save:hang=0.5@*",
])
def test_parse_schedule_matches_reference(spec):
    ours, theirs = chaos.parse_schedule(spec), jchaos.parse_schedule(spec)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert (a.seam, a.action, a.param, a.spans) == \
            (b.seam, b.action, b.param, b.spans)
        assert [a.matches(n) for n in range(1, 8)] == \
            [b.matches(n) for n in range(1, 8)]


@pytest.mark.parametrize("bad,match", [("reward_fn", "does not parse"),
                                       ("reward_fn:explode@1",
                                        "unknown action")])
def test_parse_schedule_rejects_like_reference(bad, match):
    for mod in (chaos, jchaos):
        with pytest.raises(ValueError, match=match):
            mod.parse_schedule(bad)


def test_known_seams_and_fire_sequences_match_reference():
    assert chaos.KNOWN_SEAMS == jchaos.KNOWN_SEAMS
    runs = []
    for ch, tel, fn in ((chaos, telemetry, retry_call),
                        (jchaos, jtel, jfaults.retry_call)):
        session = tel.start()
        ch.configure("reward_fn:exc@1,2;rollout:slow=0.05@2")
        calls = {"n": 0}

        def scorer():
            calls["n"] += 1
            return "ok"

        assert fn(scorer, retries=2, backoff=0.0, seam="reward_fn",
                  log=lambda m: None) == "ok"
        for _ in range(3):
            ch.maybe_inject("rollout")
        ch.configure("reward_fn:exc@1,2")  # re-armed: injects again
        with pytest.raises(ch.ChaosError):
            fn(scorer, retries=1, backoff=0.0, seam="reward_fn",
               log=lambda m: None)
        runs.append((calls["n"], dict(ch.active().counts),
                     session.registry.counters))
    assert runs[0] == runs[1]
    assert runs[0][0] == 1 and runs[0][2]["chaos/injections"] == 5


def test_env_overrides_config_and_reset_releases_hangs(monkeypatch):
    monkeypatch.setenv(chaos.ENV_VAR, "eval:exc@1")
    sched = chaos.configure_from(types.SimpleNamespace(chaos="eval:slow@1"))
    assert sched.rules[0].action == "exc"
    monkeypatch.delenv(chaos.ENV_VAR)
    sched = chaos.configure_from(types.SimpleNamespace(chaos="eval:slow@1"))
    assert sched.rules[0].action == "slow"
    installed = chaos.configure("rollout:exc@1")
    assert chaos.configure_from(types.SimpleNamespace(chaos="")) is installed

    chaos.configure("reward_fn:hang@*")
    outcome = {}

    def worker():
        try:
            chaos.maybe_inject("reward_fn")
        except chaos.ChaosHang:
            outcome["released"] = True

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    time.sleep(0.1)
    chaos.reset()
    t.join(timeout=2)
    assert outcome.get("released") is True


# --------------------------------------------------------------------- #
# the watchdog
# --------------------------------------------------------------------- #


def _stalled_run(sup, phase_name="ppo_update", hold=0.4):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        with sup:
            with supervisor.phase(phase_name):
                time.sleep(hold)
    return err.getvalue()


def test_watchdog_detects_stall_dumps_stacks_and_counts():
    tel = telemetry.start()
    sup = RunSupervisor(stall_timeout=0.08, stall_first_timeout=0.08,
                        stall_grace=100.0)
    out = _stalled_run(sup)
    assert sup.stalls == 1 and sup.stalled_phase == "ppo_update"
    assert tel.registry.counters["fault/stalls"] == 1.0
    assert "STALL" in out and "ppo_update" in out
    assert "train.stall_first_timeout" in out
    assert "MainThread" in out and "trlx-watchdog" in out
    assert sup.first_call_s["ppo_update"] >= 0.4


def test_watchdog_first_call_allowance():
    telemetry.start()
    sup = RunSupervisor(stall_timeout=0.08, stall_first_timeout=10.0,
                        stall_grace=100.0)
    with contextlib.redirect_stderr(io.StringIO()):
        with sup:
            with supervisor.phase("ppo_update"):
                time.sleep(0.3)  # over stall_timeout, under the first
            assert sup.stalls == 0
            with supervisor.phase("ppo_update"):
                time.sleep(0.3)  # steady state: a stall
    assert sup.stalls == 1
    assert list(sup.first_call_s) == ["ppo_update"]
    assert RunSupervisor(stall_timeout=2.0).stall_first_timeout == 10.0


def test_watchdog_beat_defers_stall_and_other_threads_ignored():
    telemetry.start()
    sup = RunSupervisor(stall_timeout=0.3, stall_first_timeout=0.3,
                        stall_grace=100.0)
    with sup:
        with supervisor.phase("rollout"):
            for _ in range(5):
                time.sleep(0.1)
                supervisor.beat()
        assert sup.stalls == 0

        def other():
            with supervisor.phase("rollout"):
                pass

        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert sup._phases == []


@pytest.mark.parametrize("action,code,rescued", [
    ("checkpoint_exit", 75, [1]), ("abort", 70, []),
])
def test_watchdog_escalates(action, code, rescued):
    tel = telemetry.start()
    exits, calls = [], []
    sup = RunSupervisor(stall_timeout=0.05, stall_first_timeout=0.05,
                        stall_grace=0.05, stall_action=action,
                        rescue_fn=lambda: calls.append(1),
                        exit_fn=exits.append)
    out = _stalled_run(sup, hold=0.6)
    assert sup.escalated and exits == [code] and calls == rescued
    assert tel.registry.counters["fault/stall_escalations"] == 1.0
    assert "ESCALATION" in out
    if rescued:
        assert "rescue checkpoint committed" in out
    with pytest.raises(ValueError, match="stall_action"):
        RunSupervisor(stall_action="exit_quietly")


def test_supervisor_inert_when_disabled_and_walltime():
    sup = RunSupervisor()
    with sup:
        assert supervisor.current() is sup
        assert sup.phase("ppo_update") is supervisor.NULL_CM
        assert not sup.stop_requested() and sup._thread is None
    assert supervisor.current() is None
    assert supervisor.phase("x") is supervisor.NULL_CM
    supervisor.beat()

    tel = telemetry.start()
    sup = RunSupervisor(max_walltime=0.05)
    with sup:
        assert not sup.stop_requested()
        time.sleep(0.08)
        assert sup.deadline_reached() and sup.stop_requested()
        assert sup.stop_reason() == "walltime_exceeded"
    assert tel.registry.counters["fault/walltime_exits"] == 1.0

    from trlx_tpu_torch.utils.preemption import PreemptionGuard

    guard = PreemptionGuard(enabled=False)
    assert guard.poll() is False and guard.poll(extra=True) is True


# --------------------------------------------------------------------- #
# end to end: the same drills on a tiny PPO in both packages
# --------------------------------------------------------------------- #

#: counters a drill moves the same way in both packages (fault/stalls
#: also counts first calls that run past the budget, which on JAX's side
#: include its compiles)
TIMING_COUNTERS = ("fault/stalls",)

#: the port's own counters, which the reference has not: rollout decode
#: steps by the path their attention took
PORT_COUNTERS = ("rollout/decode_kernel_steps", "rollout/decode_plain_steps")


class _Stack:
    """One warm supervised PPO stack of one package: trainer,
    orchestrator, and that package's telemetry, chaos and checkpoint
    modules."""

    def __init__(self, pkg, base):
        from tests.test_ppo_e2e import PROMPTS, make_config, reward_fn

        if pkg == "jax":
            from trlx_tpu.utils import checkpoint
            from trlx_tpu.utils import loading
            self.tel, self.chaos = jtel, jchaos
        else:
            from trlx_tpu_torch.utils import checkpoint
            from trlx_tpu_torch.utils import loading
            self.tel, self.chaos = telemetry, chaos
        self.pkg, self.base, self.checkpoint = pkg, base, checkpoint
        config = make_config(total_steps=4, epochs=2, ppo_epochs=1,
                             num_rollouts=32, chunk_size=16, batch_size=16)
        train = config.train
        train.host_retries, train.host_retry_backoff = 2, 0.0
        train.stall_timeout = train.stall_first_timeout = 0.25
        train.stall_grace = 600.0  # detection only: never escalate here
        train.host_call_timeout = 0.5
        kwargs = {}
        if pkg == "torch":
            from trlx_tpu_torch.data.configs import TRLConfig

            config = TRLConfig.from_dict(config.to_nested_dict())
            kwargs = {"device": "cpu"}
        self.config = config
        self.trainer = loading.get_model(config.model.model_type)(config,
                                                                  **kwargs)
        pipeline = loading.get_pipeline("PPOPipeline")(
            PROMPTS, self.trainer.tokenizer, config)
        self.orch = loading.get_orchestrator("PPOOrchestrator")(
            self.trainer, pipeline, reward_fn=reward_fn, chunk_size=16)
        self.drills = 0

    def drill(self, schedule, telemetry_on=True, passes=4, **train):
        """Fresh experience, then ``schedule`` installed and ``passes``
        more update passes through learn(), with a fresh telemetry
        session and checkpoint dir; returns (logs, run dir)."""
        self.drills += 1
        run = os.path.join(self.base, f"{self.pkg}{self.drills}")
        t = self.config.train
        defaults = dict(stall_timeout=0.25, stall_first_timeout=0.25,
                        max_walltime=0.0, host_retries=2,
                        checkpoint_timeout=0.0, resume_from="",
                        telemetry=telemetry_on)
        for k, v in {**defaults, **train}.items():
            setattr(t, k, v)
        t.checkpoint_dir = os.path.join(run, "ckpt")
        t.telemetry_dir = os.path.join(run, "tel") if telemetry_on else ""
        tr = self.trainer
        self.tel.stop()
        self.chaos.reset()
        tr.store.clear_history()
        self.orch.make_experience(32)
        if telemetry_on:
            self.tel.start_from_config(self.config)
        self.chaos.configure(schedule)
        t.total_steps = tr.iter_count + passes
        t.epochs = tr.epoch + 2
        logs = []
        try:
            tr.learn(log_fn=logs.append)
        finally:
            self.chaos.reset()
        return logs, run

    def counters(self, run):
        with open(os.path.join(run, "tel", "telemetry.json")) as f:
            return json.load(f)["counters"]


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    base = str(tmp_path_factory.mktemp("supervised"))
    out = {pkg: _Stack(pkg, base) for pkg in ("jax", "torch")}
    yield out
    torch.set_num_threads(threads)


def _same_counters(stacks, runs):
    ours = stacks["torch"].counters(runs["torch"])
    theirs = stacks["jax"].counters(runs["jax"])
    ours = {k: v for k, v in ours.items() if k not in PORT_COUNTERS}
    assert set(ours) == set(theirs)
    for key in ours:
        if key not in TIMING_COUNTERS:
            assert ours[key] == theirs[key], (key, ours[key], theirs[key])
    return ours


def test_e2e_hung_reward_fn_is_timed_out_retried_and_completes(stacks,
                                                               capfd):
    """One reward attempt hangs mid-learn (the refresh): the watchdog
    dumps the stacks, the bounded seam times the attempt out, it is
    retried, and the run completes, in both packages."""
    runs = {}
    for pkg, stack in stacks.items():
        before = stack.trainer.iter_count
        _, runs[pkg] = stack.drill("reward_fn:hang=30@1")
        assert stack.trainer.iter_count == before + 4
        err = capfd.readouterr().err
        if pkg == "torch":
            assert "STALL" in err and "'reward_fn'" in err
            assert "MainThread" in err and "trlx-watchdog" in err
    counters = _same_counters(stacks, runs)
    assert counters["fault/stalls"] >= 1
    assert counters["fault/seam_timeouts"] == 1
    assert counters["fault/host_retries"] == 1
    assert counters["chaos/injections"] == 1


def test_e2e_hung_reward_fn_with_telemetry_off(stacks, capfd):
    stack = stacks["torch"]
    before = stack.trainer.iter_count
    _, run = stack.drill("reward_fn:hang=30@1", telemetry_on=False)
    assert stack.trainer.iter_count == before + 4
    assert telemetry.current() is None
    assert not os.path.exists(os.path.join(run, "tel"))
    assert "STALL" in capfd.readouterr().err


def test_e2e_permanent_stall_checkpoints_raises_and_resumes(stacks, capfd):
    runs = {}
    for pkg, stack in stacks.items():
        with pytest.raises(StallError if pkg == "torch"
                           else jsupervisor.StallError):
            logs, _ = stack.drill("reward_fn:hang=30@*", host_retries=1)
        tr, t = stack.trainer, stack.config.train
        runs[pkg] = os.path.dirname(t.checkpoint_dir)
        latest = stack.checkpoint.find_latest_checkpoint(t.checkpoint_dir)
        assert latest is not None
        assert latest.endswith(f"step_{tr.iter_count}")
        err = capfd.readouterr().err
        assert "STALL" in err and "MainThread" in err
    # the stall checkpoint restores (resume_from: auto)
    tr, t = stacks["torch"].trainer, stacks["torch"].config.train
    before = tr.iter_count
    tr._resumed = False
    t.resume_from = "auto"
    try:
        assert tr.maybe_resume() is True and tr.iter_count == before
    finally:
        t.resume_from = ""
    counters = _same_counters(stacks, runs)
    assert counters["fault/seam_timeouts"] == 2
    assert counters["fault/host_giveups"] == 1
    assert counters["checkpoint/saves"] == 1


def test_e2e_walltime_saves_and_returns(stacks):
    runs = {}
    for pkg, stack in stacks.items():
        before = stack.trainer.iter_count
        logs, runs[pkg] = stack.drill("", stall_timeout=0.0,
                                      max_walltime=0.001)
        tr, t = stack.trainer, stack.config.train
        assert before < tr.iter_count < t.total_steps
        latest = stack.checkpoint.find_latest_checkpoint(t.checkpoint_dir)
        assert latest.endswith(f"step_{tr.iter_count}")
        assert any(s.get("walltime_exceeded") for s in logs)
    counters = _same_counters(stacks, runs)
    assert counters["fault/walltime_exits"] == 1


def test_e2e_chaos_sigterm_is_a_preemption_checkpoint(stacks):
    runs = {}
    for pkg, stack in stacks.items():
        logs, runs[pkg] = stack.drill("ppo_update:sigterm@1",
                                      stall_timeout=0.0)
        tr, t = stack.trainer, stack.config.train
        assert any(s.get("preempted") for s in logs)
        latest = stack.checkpoint.find_latest_checkpoint(t.checkpoint_dir)
        assert latest.endswith(f"step_{tr.iter_count}")
        assert tr.iter_count < t.total_steps
    counters = _same_counters(stacks, runs)
    assert counters["fault/preempt_sigterm"] == 1
    assert counters["chaos/injections"] == 1


def test_e2e_exc_at_the_update_propagates(stacks):
    stack = stacks["torch"]
    with pytest.raises(chaos.ChaosError):
        stack.drill("ppo_update:exc@1", stall_timeout=0.0)
    assert stack.counters(
        os.path.dirname(stack.config.train.checkpoint_dir))[
            "chaos/injections"] == 1


def test_e2e_checkpoint_save_seam_is_bounded(stacks, monkeypatch):
    """``train.checkpoint_timeout``: a save wedged on a dead filesystem
    raises SeamTimeout instead of hanging the run, in both packages."""
    release = threading.Event()

    def wedged_save(components, run_dir, step=0, keep=0):
        release.wait(10)

    monkeypatch.setattr("trlx_tpu.utils.checkpoint.save_step_checkpoint",
                        wedged_save)
    monkeypatch.setattr("trlx_tpu_torch.trainers.save_step_checkpoint",
                        wedged_save)
    try:
        for pkg, stack in stacks.items():
            stack.config.train.checkpoint_timeout = 0.2
            t0 = time.monotonic()
            with pytest.raises(SeamTimeout if pkg == "torch"
                               else jsupervisor.SeamTimeout,
                               match="checkpoint_save"):
                stack.trainer.save()
            assert time.monotonic() - t0 < 5
    finally:
        release.set()
        for stack in stacks.values():
            stack.config.train.checkpoint_timeout = 0.0
