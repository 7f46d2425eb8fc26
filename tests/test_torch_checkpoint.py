"""The port's checkpoints and preemption guard
(trlx_tpu_torch.utils.checkpoint, trlx_tpu_torch.utils.preemption), case
by case after tests/test_checkpoint.py and tests/test_faults.py:

- a save killed mid-write leaves the previous checkpoint intact; a plain
  save replaces an existing one atomically; half-written directories are
  skipped; retention keeps the newest N, also through ``trainer.save``;
  ``LATEST``;
- a restore of a missing path or component gives one actionable error;
  zero-size leaves round-trip (the stated intent of
  tests/test_faults.py::test_save_restore_zero_size_leaves);
- a flipped byte, a truncated tensor file and a torn meta.json are
  detected and quarantined; a run-directory restore falls back past a
  corrupt step; a checkpoint named directly fails fast;
- ``resume_from: auto`` starts fresh, then restores the latest; SIGTERM
  during ``learn()`` saves and the run resumes; the PreemptionGuard
  cases;
- the layout is the reference's: trlx_tpu's own resolver and verifier
  accept the port's run directory and manifest.
"""

import json
import os
import signal
import threading
import types

import pytest
import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.trainers import BaseRLTrainer, _leaves
from trlx_tpu_torch.utils.checkpoint import (
    LATEST_NAME,
    MANIFEST_KEY,
    META_NAME,
    CheckpointCorrupt,
    find_latest_checkpoint,
    gc_checkpoints,
    is_valid_checkpoint,
    restore_components,
    save_components,
    save_step_checkpoint,
    verify_checkpoint,
)
from trlx_tpu_torch.utils.preemption import PreemptionGuard


def _components(value: float):
    return {
        "params": {"w": torch.full((4, 2), value),
                   "b": [torch.arange(3, dtype=torch.int32),
                         torch.full((2,), value, dtype=torch.bfloat16)]},
        "state": {"iter_count": int(value)},
    }


def _steps(run):
    return sorted(e for e in os.listdir(run) if e.startswith("step_"))


# --------------------------------------------------------------------- #
# atomic saves, LATEST, retention
# --------------------------------------------------------------------- #


def test_save_killed_mid_write_previous_checkpoint_survives(tmp_path,
                                                            monkeypatch):
    run = str(tmp_path / "run")
    save_step_checkpoint(_components(1.0), run, step=1)
    assert find_latest_checkpoint(run).endswith("step_1")

    def die_mid_write(obj, f, *args, **kw):
        f.write(b"torn")
        raise RuntimeError("killed mid-write")

    monkeypatch.setattr(torch, "save", die_mid_write)
    with pytest.raises(RuntimeError, match="killed mid-write"):
        save_step_checkpoint(_components(2.0), run, step=2)
    monkeypatch.undo()

    assert not os.path.isdir(os.path.join(run, "step_2"))
    assert any(".tmp-" in e for e in os.listdir(run))
    latest = find_latest_checkpoint(run)
    assert latest.endswith("step_1")
    restored = restore_components(_components(0.0), latest)
    assert torch.equal(restored["params"]["w"], torch.full((4, 2), 1.0))
    assert restored["state"]["iter_count"] == 1

    save_step_checkpoint(_components(2.0), run, step=2, keep=4)
    assert find_latest_checkpoint(run).endswith("step_2")
    assert not any(".tmp-" in e for e in os.listdir(run))


def test_save_components_atomically_replaces_existing(tmp_path):
    d = str(tmp_path / "ck")
    save_components(_components(1.0), d)
    save_components(_components(2.0), d)
    restored = restore_components(_components(0.0), d)
    assert restored["state"]["iter_count"] == 2
    assert torch.equal(restored["params"]["b"][1],
                       torch.full((2,), 2.0, dtype=torch.bfloat16))
    assert not any(".old-" in e or ".tmp-" in e
                   for e in os.listdir(str(tmp_path)))


def test_find_latest_skips_half_written_dirs(tmp_path):
    run = str(tmp_path / "run")
    save_step_checkpoint(_components(3.0), run, step=3)
    os.makedirs(os.path.join(run, "step_9"))
    os.makedirs(os.path.join(run, "step_12.tmp-123"))
    assert not is_valid_checkpoint(os.path.join(run, "step_9"))
    assert find_latest_checkpoint(run).endswith("step_3")
    restored = restore_components(_components(0.0), run)
    assert restored["state"]["iter_count"] == 3


def test_retention_keeps_newest_n_and_latest(tmp_path):
    run = str(tmp_path / "run")
    for step in (1, 2, 3, 4, 5):
        save_step_checkpoint(_components(float(step)), run, step=step,
                             keep=2)
    assert _steps(run) == ["step_4", "step_5"]
    with open(os.path.join(run, LATEST_NAME)) as f:
        assert f.read() == "step_5"
    assert find_latest_checkpoint(run).endswith("step_5")
    # LATEST naming a directory that is gone: the scan finds the newest
    with open(os.path.join(run, LATEST_NAME), "w") as f:
        f.write("step_7")
    assert find_latest_checkpoint(run).endswith("step_5")
    gc_checkpoints(run, keep=1)
    assert _steps(run) == ["step_5"]


# --------------------------------------------------------------------- #
# restore errors and zero-size leaves
# --------------------------------------------------------------------- #


def test_restore_missing_path_raises_one_actionable_error(tmp_path):
    with pytest.raises(FileNotFoundError) as exc:
        restore_components(_components(0.0), str(tmp_path / "nope"))
    msg = str(exc.value)
    assert "params" in msg and "state" in msg and "does not exist" in msg
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "random_junk.txt").write_text("x")
    with pytest.raises(FileNotFoundError) as exc:
        restore_components(_components(0.0), str(empty))
    assert "random_junk.txt" in str(exc.value)


def test_restore_missing_component_lists_expectation(tmp_path):
    d = str(tmp_path / "ck")
    save_components({"params": _components(1.0)["params"]}, d)
    with pytest.raises(FileNotFoundError) as exc:
        restore_components(_components(0.0), d)
    msg = str(exc.value)
    assert "missing components ['state']" in msg and "params" in msg
    # a tree of another shape is refused by name, not restored into
    wrong = _components(0.0)
    wrong["params"]["w"] = torch.zeros(4, 3)
    wrong["state"] = {"iter_count": 0}
    save_components(_components(1.0), d)
    with pytest.raises(ValueError, match="params.w"):
        restore_components(wrong, d)


def test_save_restore_zero_size_leaves(tmp_path):
    comps = {
        "params": {"w": torch.full((4, 2), 3.0),
                   "frozen_base": {"blocks": torch.zeros((0, 2, 2)),
                                   "embed": {}}},
        "state": {"iter_count": 7},
    }
    d = str(tmp_path / "ck")
    save_components(comps, d)
    out = restore_components(
        {"params": {"w": torch.zeros((4, 2)),
                    "frozen_base": {"blocks": torch.zeros((0, 2, 2)),
                                    "embed": {}}},
         "state": {"iter_count": 0}}, d)
    assert out["params"]["w"][0, 0] == 3.0
    assert out["params"]["frozen_base"]["blocks"].shape == (0, 2, 2)
    assert out["params"]["frozen_base"]["embed"] == {}
    assert out["state"]["iter_count"] == 7


# --------------------------------------------------------------------- #
# integrity: manifest, quarantine, fallback
# --------------------------------------------------------------------- #


def _corrupt(path, how):
    if how == "flipped byte":
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
    elif how == "truncated file":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 7)
    else:  # torn meta.json
        with open(path, "w") as f:
            f.write('{"state": {"iter_')


@pytest.mark.parametrize("how", ["flipped byte", "truncated file",
                                 "torn meta.json"])
def test_corruption_is_detected_and_quarantined(tmp_path, how):
    telemetry.start()
    d = str(tmp_path / "ck")
    save_components(_components(1.0), d)
    assert verify_checkpoint(d)
    name = META_NAME if how == "torn meta.json" else "params.pt"
    _corrupt(os.path.join(d, name), how)
    with pytest.raises(CheckpointCorrupt, match="quarantined"):
        restore_components(_components(0.0), d)  # named directly: fails
    assert not os.path.exists(d)
    assert any(".corrupt-" in e for e in os.listdir(str(tmp_path)))
    assert telemetry.current().registry.counters[
        "checkpoint/quarantined"] == 1.0


def test_run_dir_restore_falls_back_past_corrupt_step(tmp_path):
    run = str(tmp_path / "run")
    save_step_checkpoint(_components(1.0), run, step=1)
    save_step_checkpoint(_components(2.0), run, step=2)
    _corrupt(os.path.join(run, "step_2", "params.pt"), "flipped byte")
    restored = restore_components(_components(0.0), run)
    assert restored["state"]["iter_count"] == 1
    assert torch.equal(restored["params"]["w"], torch.full((4, 2), 1.0))
    assert any(e.startswith("step_2.corrupt-") for e in os.listdir(run))
    assert find_latest_checkpoint(run).endswith("step_1")


def test_reference_resolver_and_verifier_accept_the_port_layout(tmp_path):
    """trlx_tpu's own checkpoint module resolves the port's run directory
    and verifies its manifest: the layout (step_<N>, LATEST, meta.json
    written last with the per-file SHA-256 manifest) is the same."""
    from trlx_tpu.utils import checkpoint as ref

    run = str(tmp_path / "run")
    for step in (2, 4):
        save_step_checkpoint(_components(float(step)), run, step=step)
    assert ref.find_latest_checkpoint(run) == find_latest_checkpoint(run)
    latest = find_latest_checkpoint(run)
    assert ref.verify_checkpoint(latest) is True
    with open(os.path.join(latest, META_NAME)) as f:
        meta = json.load(f)
    assert sorted(meta[MANIFEST_KEY]["files"]) == ["params.pt"]
    assert meta["state"] == {"iter_count": 4}


# --------------------------------------------------------------------- #
# the trainer surface on a stub, as tests/test_faults.py drives it
# --------------------------------------------------------------------- #


class _StubTrainer:
    save = BaseRLTrainer.save
    load = BaseRLTrainer.load
    maybe_resume = BaseRLTrainer.maybe_resume
    _rollback_to_latest = BaseRLTrainer._rollback_to_latest

    def __init__(self, config):
        self.config = config
        self.iter_count = 0
        self.w = torch.zeros(3)

    def get_components(self):
        return {"params": {"w": self.w},
                "state": {"iter_count": self.iter_count}}

    def set_components(self, components):
        self.w.copy_(components["params"]["w"])
        self.iter_count = int(components["state"]["iter_count"])


def _stub(tmp_path, **over):
    train = types.SimpleNamespace(checkpoint_dir=str(tmp_path / "run"),
                                  resume_from="", keep_checkpoints=0,
                                  max_bad_steps=0)
    for k, v in over.items():
        setattr(train, k, v)
    return _StubTrainer(types.SimpleNamespace(train=train))


def test_resume_from_auto_fresh_start_then_restores_latest(tmp_path):
    t1 = _stub(tmp_path, resume_from="auto")
    assert t1.maybe_resume() is False  # nothing saved yet: fresh start
    t1.w.fill_(7.0)
    t1.iter_count = 40
    t1.save()
    t1.w.fill_(9.0)
    t1.iter_count = 80
    t1.save()
    t2 = _stub(tmp_path, resume_from="auto")
    held = t2.w
    assert t2.maybe_resume() is True
    assert t2.iter_count == 80 and torch.equal(t2.w, torch.full((3,), 9.0))
    assert t2.w is held  # restored into the trainer's own tensor
    t2.iter_count = 99
    assert t2.maybe_resume() is False  # once per process
    assert t2.iter_count == 99


def test_retention_applies_through_trainer_save(tmp_path):
    t = _stub(tmp_path, keep_checkpoints=2)
    for step in (10, 20, 30):
        t.iter_count = step
        t.save()
    assert _steps(t.config.train.checkpoint_dir) == ["step_20", "step_30"]


def test_rollback_to_latest_restores_and_reports_path(tmp_path):
    t = _stub(tmp_path)
    assert t._rollback_to_latest() is None
    t.w.fill_(3.0)
    t.iter_count = 12
    t.save()
    t.w.fill_(8.0)
    t.iter_count = 55
    assert t._rollback_to_latest().endswith("step_12")
    assert t.iter_count == 12 and torch.equal(t.w, torch.full((3,), 3.0))


# --------------------------------------------------------------------- #
# SIGTERM on the real PPO trainer
# --------------------------------------------------------------------- #


def _ppo(tmp_path, seed=0, **train):
    from tests.test_ppo_e2e import PROMPTS, make_config, reward_fn
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import (
        get_model,
        get_orchestrator,
        get_pipeline,
    )

    jcfg = make_config(total_steps=8, epochs=100, num_rollouts=16,
                       chunk_size=16, batch_size=16, ppo_epochs=1)
    cfg = TRLConfig.from_dict(jcfg.to_nested_dict())
    cfg.train.seed = seed
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    for k, v in train.items():
        setattr(cfg.train, k, v)
    trainer = get_model("JaxPPOTrainer")(cfg, device="cpu")
    pipeline = get_pipeline("PPOPipeline")(PROMPTS, trainer.tokenizer, cfg)
    orch = get_orchestrator("PPOOrchestrator")(trainer, pipeline,
                                               reward_fn=reward_fn,
                                               chunk_size=16)
    return cfg, trainer, orch


def _trainable(trainer):
    return [p.detach().clone() for p in _leaves(trainer.params["trainable"])]


def test_sigterm_preemption_saves_and_resumes(tmp_path):
    prev_handler = signal.getsignal(signal.SIGTERM)
    cfg, trainer, orch = _ppo(tmp_path, log_interval=1,
                              checkpoint_interval=10**9)
    orch.make_experience(16)
    logs, sent = [], []

    def log_fn(stats):
        logs.append(stats)
        if stats.get("iter") == 2 and "loss" in stats and not sent:
            sent.append(1)
            os.kill(os.getpid(), signal.SIGTERM)

    trainer.learn(log_fn=log_fn)  # returns instead of dying
    assert sent and trainer.iter_count == 2
    assert any(s.get("preempted") for s in logs)
    assert signal.getsignal(signal.SIGTERM) is prev_handler
    assert _steps(cfg.train.checkpoint_dir) == ["step_2"]
    saved = _trainable(trainer)

    cfg2, resumed, orch2 = _ppo(tmp_path, seed=9, resume_from="auto",
                                checkpoint_interval=10**9)
    assert resumed.iter_count == 2  # restored at construction
    for a, b in zip(saved, _trainable(resumed)):
        assert torch.equal(a, b)
    orch2.make_experience(16)
    resumed.learn(log_fn=lambda s: None)
    assert resumed.iter_count == 8


# --------------------------------------------------------------------- #
# PreemptionGuard
# --------------------------------------------------------------------- #


def test_preemption_guard_disabled_by_config():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard(enabled=False) as guard:
        assert signal.getsignal(signal.SIGTERM) is prev
        assert not guard.requested and not guard.poll()


def test_preemption_guard_off_main_thread_stays_inert():
    prev = signal.getsignal(signal.SIGTERM)
    results = {}

    def run():
        with PreemptionGuard() as guard:
            results["installed"] = guard._installed
            results["poll"] = guard.poll()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert results == {"installed": False, "poll": False}
    assert signal.getsignal(signal.SIGTERM) is prev


def test_preemption_guard_restores_sig_dfl_for_c_handlers(monkeypatch):
    real_getsignal = signal.getsignal
    monkeypatch.setattr(signal, "getsignal", lambda sig: None)
    try:
        with PreemptionGuard():
            pass
        monkeypatch.setattr(signal, "getsignal", real_getsignal)
        assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


@pytest.mark.parametrize("interval,flagged,want_calls,want", [
    (4, True, 2, [True, False, False, False, True]),
    (3, False, 3, [False] * 7),
    (1, True, 5, [True] * 5),
])
def test_preemption_poll_interval_boundaries(monkeypatch, interval, flagged,
                                             want_calls, want):
    """With more than one process the ranks agree by a collective only on
    calls 1, N+1, 2N+1, ...; between them poll() says False even with the
    local flag set. With one process: the local flag, every call."""
    from trlx_tpu_torch.utils import preemption

    calls = {"n": 0}

    def fake_any_rank(flag):
        calls["n"] += 1
        return flag

    monkeypatch.setattr(preemption, "_world_size", lambda: 2)
    monkeypatch.setattr(preemption, "_any_rank", fake_any_rank)
    guard = PreemptionGuard(poll_interval=interval)
    guard.requested = flagged
    assert [guard.poll() for _ in range(len(want))] == want
    assert calls["n"] == want_calls
    monkeypatch.setattr(preemption, "_world_size", lambda: 1)
    assert guard.poll() is flagged
    assert PreemptionGuard(poll_interval=0)._poll_interval == 1


def test_sigterm_inside_guard_sets_the_flag():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested and guard.poll()
    assert signal.getsignal(signal.SIGTERM) is prev
