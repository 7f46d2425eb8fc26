"""The port's PPO trainer (trlx_tpu_torch.trainers.ppo_trainer) against
trlx_tpu's, on the CPU at float32 from the same params carried across:

- one ``train_step`` and a 2-pass ``train_multi`` on one fixed batch
  (left-padded prompts, eos-masked responses), with dense attention and
  with the flash seam (``_MIN_FUSED_T`` set to 0 on both sides): loss,
  grad norm and every stat at rtol 1e-5; the updated trainable params by
  tests/test_golden_step.py's relative-L2 rule at rtol 2e-3;
- ``build_optimizer`` against optax over 3 steps (clipped and unclipped,
  float32 and bfloat16 first moments);
- ``make_experience`` fills the store with the expected shapes;
- the port's offline example runs a few steps on the CPU and stays
  finite;
- ``evaluate`` returns trlx_tpu's keys, the generations table included;
- the knobs the port does not run yet raise, and the run supervisor's
  knobs (and ``$TRLX_TPU_CHAOS``) reach the trainer's RunSupervisor, its
  chaos schedule, its seam timeout and its bounded save."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_ppo_e2e import PROMPTS, make_config, reward_fn
from trlx_tpu.data.ppo_types import PPORLBatch as JaxBatch
from trlx_tpu.ops import pallas_attention as jpa
from trlx_tpu.trainers.ppo_trainer import build_optimizer as jax_optimizer
from trlx_tpu.utils.loading import get_model as jax_get_model
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.ppo_types import PPORLBatch
from trlx_tpu_torch.models.params import hydra_to_numpy
from trlx_tpu_torch.ops import flash_attention as tfa
from trlx_tpu_torch.trainers import build_optimizer
from trlx_tpu_torch.utils.loading import (
    get_model,
    get_orchestrator,
    get_pipeline,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's small CPU models: tiny ops
    spread over every core spend their time synchronising threads (the
    offline example takes 16 s on one thread and 90 s on eight on an
    8-core host), and worse while several test processes share it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(ppo_epochs=1, fused=False):
    jcfg = make_config(total_steps=8, batch_size=16, num_layers_unfrozen=1,
                       learning_rate=3e-3, ppo_epochs=ppo_epochs)
    jcfg.model.fused_attention = fused or None
    return jcfg, TRLConfig.from_dict(jcfg.to_nested_dict())


def _batch(seed=0, B=16, P=4, G=8):
    rng = np.random.default_rng(seed)
    qmask = np.ones((B, P), np.int32)
    rmask = np.ones((B, G), np.int32)
    for i in range(B):
        qmask[i, :i % P] = 0
        rmask[i, G - (i % 3):] = 0
    return dict(
        query_tensors=rng.integers(0, 256, (B, P)).astype(np.int32),
        response_tensors=rng.integers(0, 256, (B, G)).astype(np.int32),
        logprobs=(-rng.uniform(0.5, 6.0, (B, G))).astype(np.float32),
        values=(0.1 * rng.standard_normal((B, G))).astype(np.float32),
        rewards=(0.1 * rng.standard_normal((B, G))).astype(np.float32),
        response_masks=rmask, query_masks=qmask,
    )


def _assert_updates_close(ours, theirs, start, rtol=2e-3, max_step=None):
    """tests/test_golden_step.py's rule: per-leaf relative L2 of the
    UPDATE (new - start); leaves whose two updates agree absolutely to
    1e-5 pass. The key bias has an analytically zero gradient (softmax
    is shift-invariant), so Adam turns rounding noise into +-lr steps
    whose signs no two implementations share: that leaf is held only to
    the step bound ``max_step`` per element."""
    flat_o = jax.tree_util.tree_leaves_with_path(ours)
    flat_t = jax.tree_util.tree_leaves(theirs)
    flat_s = jax.tree_util.tree_leaves(start)
    assert len(flat_o) == len(flat_t) == len(flat_s)
    for (path, o), t, s in zip(flat_o, flat_t, flat_s):
        do = np.asarray(o, np.float64) - np.asarray(s, np.float64)
        dt = np.asarray(t, np.float64) - np.asarray(s, np.float64)
        if np.linalg.norm(do - dt) < 1e-5:
            continue
        if jax.tree_util.keystr(path).endswith("['bk']"):
            assert np.abs(do).max() <= max_step
            continue
        rel = np.linalg.norm(do - dt) / max(np.linalg.norm(dt), 1e-12)
        assert rel < rtol, (jax.tree_util.keystr(path), rel)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("ppo_epochs", [1, 2])
def test_train_step_and_multi_match_jax(ppo_epochs, fused, monkeypatch):
    if fused:
        monkeypatch.setattr(jpa, "_MIN_FUSED_T", 0)
        monkeypatch.setattr(tfa, "_MIN_FUSED_T", 0)
    jcfg, tcfg = _configs(ppo_epochs, fused)
    jtrainer = jax_get_model("JaxPPOTrainer")(jcfg)
    params0 = jax.device_get(jtrainer.params)
    ttrainer = get_model("JaxPPOTrainer")(tcfg, device="cpu", params=params0)
    assert (ttrainer.policy.attention_fn is not None) == fused
    data = _batch()
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})
    tbatch = PPORLBatch(**{k: torch.from_numpy(v) for k, v in data.items()})

    if ppo_epochs == 1:
        jparams, _, jstats = jtrainer._train_step(
            jtrainer.params, jtrainer.opt_state, jbatch)
        tstats = ttrainer.train_step(tbatch)
    else:
        jparams, _, jstats = jtrainer._train_multi(
            jtrainer.params, jtrainer.opt_state, jbatch)
        tstats = ttrainer.train_multi(tbatch)
    jstats = jax.device_get(jstats)
    assert sorted(tstats) == sorted(jstats)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-5, err_msg=k)
    for k in tstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_updates_close(hydra_to_numpy(ttrainer.params["trainable"]),
                          jax.device_get(jparams["trainable"]),
                          params0["trainable"],
                          max_step=1.01 * 3e-3 * ppo_epochs)
    # the frozen trunk and the reference branch did not move
    np.testing.assert_array_equal(
        hydra_to_numpy(ttrainer.params["ref"])["ln_f"]["scale"],
        params0["ref"]["ln_f"]["scale"])


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_build_optimizer_matches_optax(mu_dtype):
    jcfg, tcfg = _configs()
    for cfg in (jcfg, tcfg):
        cfg.train.total_steps = 5
        cfg.train.learning_rate_target = 1e-4
        cfg.train.adam_moment_dtype = mu_dtype
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = [{k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for scale in (3.0, 0.05, 1.0)]
    jopt = jax_optimizer(jcfg.train)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    topt = build_optimizer(tcfg.train)
    tp = [torch.from_numpy(params[k].copy()) for k in ("b", "w")]
    tstate = topt.init(tp)
    for g in grads:
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                      jstate, jp)
        jp = optax.apply_updates(jp, updates)
        norm = topt.step(tp, [torch.from_numpy(g[k]) for k in ("b", "w")],
                         tstate)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(g)), rtol=1e-6)
        for t, k in zip(tp, ("b", "w")):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-6)


def _port_trainer(**overrides):
    _, tcfg = _configs()
    tcfg.method.num_rollouts, tcfg.method.chunk_size = 16, 8
    for k, v in overrides.items():
        setattr(tcfg.train, k, v)
    trainer = get_model("AcceleratePPOModel")(tcfg, device="cpu")
    pipeline = get_pipeline("PPOPipeline")(PROMPTS, trainer.tokenizer, tcfg)
    orch = get_orchestrator("PPOOrchestrator")(trainer, pipeline,
                                               reward_fn=reward_fn,
                                               chunk_size=8)
    return tcfg, trainer, orch


def test_make_experience_fills_the_store():
    cfg, trainer, orch = _port_trainer()
    info = orch.make_experience(16)
    assert info["rollouts"] == 16 and np.isfinite(info["mean_kl"])
    assert len(trainer.store) == 16 and len(trainer.store.history) == 2
    data = trainer.store._stacked()
    P, G = cfg.train.input_size, cfg.train.gen_size
    for name, shape in (("query_tensors", (16, P)),
                        ("query_masks", (16, P)),
                        ("response_tensors", (16, G)),
                        ("response_masks", (16, G)), ("logprobs", (16, G)),
                        ("values", (16, G)), ("rewards", (16, G))):
        t = getattr(data, name)
        assert tuple(t.shape) == shape, name
        assert torch.isfinite(t.float()).all(), name
    assert (data.logprobs <= 0).all()
    batches = list(trainer.store.create_loader(8, shuffle=True, seed=0))
    assert len(batches) == 2 and len(batches[0]) == 8


def test_offline_example_runs_on_cpu_and_stays_finite():
    from trlx_tpu_torch.examples import ppo_sentiments

    trainer, logs = ppo_sentiments.main(["--device", "cpu",
                                         "--total-steps", "8"])
    train_logs = [entry for entry in logs if "loss" in entry]
    assert trainer.iter_count == 8 and len(train_logs) == 2
    for entry in train_logs:
        for k in ("loss", "grad_norm", "approx_kl", "samples_per_sec"):
            assert np.isfinite(entry[k]), k
        assert entry["time/ppo_update"] > 0


@pytest.mark.parametrize("knob,value", [
    ("mesh", {"dp": 2, "fsdp": 1, "tp": 1, "sp": 2, "pp": 2}),
    ("mesh", {"dp": 1, "sp": 2, "pp": 2}), ("mesh", {"sp": 4, "pp": 2}),
])
def test_refused_knobs_raise(knob, value):
    """sp and pp each train; combined they are refused, with
    trlx_tpu's message."""
    with pytest.raises(ValueError, match="cannot combine with sp > 1"):
        _port_trainer(**{knob: value})


def assert_supervisor_knob(trainer, knob, value, tmp_path, monkeypatch):
    """The run supervisor's knob ``knob`` = ``value`` reaches what it
    configures: the RunSupervisor that learn() builds, the chaos schedule
    it installs, the host seams' timeout, or the bounded save. ``knob``
    "$TRLX_TPU_CHAOS" is the environment's schedule (set by the caller
    before the trainer was built)."""
    from trlx_tpu_torch import trainers
    from trlx_tpu_torch.supervisor import chaos, seam_timeout

    sup = trainer._make_supervisor()
    assert trainer.supervisor is sup
    if knob in ("stall_timeout", "stall_first_timeout", "max_walltime"):
        assert getattr(sup, knob) == value
        if knob == "stall_timeout":
            assert sup.stall_first_timeout == 5 * value
            assert seam_timeout(trainer.config.train) == value
    elif knob == "host_call_timeout":
        assert seam_timeout(trainer.config.train) == value
        assert sup.stall_timeout == 0 and sup._thread is None
    elif knob == "checkpoint_timeout":
        calls = []

        def record(fn, timeout, label=""):
            calls.append((timeout, label))
            return fn()

        monkeypatch.setattr(trainers, "bounded_call", record)
        trainer.save(str(tmp_path / "ckpt"))
        assert calls == [(value, "checkpoint_save")]
        assert os.path.isfile(tmp_path / "ckpt" / "meta.json")
    else:  # train.chaos or $TRLX_TPU_CHAOS
        sched = chaos.active()
        assert sched is not None and len(sched.rules) == 1
        rule = sched.rules[0]
        seam, action = value.split("@")[0].split(":")
        assert (rule.seam, rule.action) == (seam, action)
        assert rule.matches(2) and not rule.matches(1)


@pytest.mark.parametrize("knob,value", [
    ("stall_timeout", 30.0), ("stall_first_timeout", 60.0),
    ("max_walltime", 3600.0), ("host_call_timeout", 5.0),
    ("checkpoint_timeout", 60.0), ("chaos", "ppo_update:exc@2"),
    ("$TRLX_TPU_CHAOS", "ppo_update:exc@2"),
])
def test_supervisor_knobs_reach_the_run_floor(knob, value, tmp_path,
                                              monkeypatch):
    """The knobs the port refused until the run supervisor was ported:
    each constructs a trainer, and its value is carried where trlx_tpu
    carries it."""
    from trlx_tpu_torch.supervisor import chaos

    if knob.startswith("$"):
        monkeypatch.setenv(knob[1:], value)
        _, trainer, _ = _port_trainer()
    else:
        _, trainer, _ = _port_trainer(**{knob: value})
    try:
        assert_supervisor_knob(trainer, knob, value, tmp_path, monkeypatch)
    finally:
        chaos.reset()


def test_evaluate_returns_the_reference_keys():
    """PPO ``evaluate`` returns what trlx_tpu's does: ``mean_score``,
    ``samples`` and the ``generations_table`` of decoded query, response
    and score rows."""
    jcfg, tcfg = _configs()
    jtrainer = jax_get_model("JaxPPOTrainer")(jcfg)
    ttrainer = get_model("JaxPPOTrainer")(tcfg, device="cpu")
    data = _batch()
    prompts = (data["query_tensors"], data["query_masks"])
    evals = []
    for trainer in (jtrainer, ttrainer):
        trainer.set_orchestrator(None, reward_fn)
        evals.append(trainer.evaluate(eval_prompts=prompts))
    theirs, ours = evals
    assert sorted(ours) == sorted(theirs)
    table, their_table = ours["generations_table"], \
        theirs["generations_table"]
    assert table["columns"] == their_table["columns"] \
        == ["query", "response", "score"]
    assert len(table["rows"]) == len(their_table["rows"]) == 16
    for (q, _, score), (tq, _, _) in zip(table["rows"], their_table["rows"]):
        assert q == tq and np.isfinite(score)


def test_refused_entry_points_raise():
    """No model_spec: the pretrained import of model_path ("from-config",
    no such checkpoint) fails, and the trainer raises rather than start
    from random weights; no card: the default device raises."""
    _, tcfg = _configs()
    tcfg.model.model_spec = None
    with pytest.raises(RuntimeError, match="could not load pretrained"):
        get_model("JaxPPOTrainer")(tcfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model("JaxPPOTrainer")(_configs()[1])
