"""The port's divergence containment (trlx_tpu_torch.utils.faults and
the trainers' commit gate), after tests/test_faults.py:

- the StepGuard cases: a streak resets on a good step, ``max_bad_steps``
  bad steps roll back, a second strike aborts, no checkpoint aborts
  with a hint, ``max_bad_steps: 0`` is free;
- a NaN step leaves params, both moments and the optimizer's count
  bit-identical (PPO and ILQL), and the next clean step commits;
- ``learn()`` on a poisoned store rolls back to the checkpoint, then
  aborts on the second strike;
- the device-tensor schedules (the count is a 0-d int32 tensor) equal
  the Python ones and optax's at every step, at fp32, atol 0, their
  cosine the C library's ``cosf`` bit for bit;
- parity with trlx_tpu: from the same weights at fp32 both guarded
  trainers take a NaN step, then a clean step; loss and grad norm agree
  at rtol 1e-5 and the params by tests/test_torch_ppo.py's relative-L2
  rule at 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ppo_e2e import PROMPTS, make_config, reward_fn
from tests.test_torch_ppo import _assert_updates_close, _batch
from trlx_tpu.data.ppo_types import PPORLBatch as JaxBatch
from trlx_tpu.utils import cosine_schedule as jax_cosine
from trlx_tpu.utils import rampup_decay_schedule as jax_rampup
from trlx_tpu.utils.loading import get_model as jax_get_model
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.ilql_types import ILQLBatch
from trlx_tpu_torch.data.ppo_types import PPORLBatch
from trlx_tpu_torch.models.params import hydra_to_numpy
from trlx_tpu_torch.trainers import _leaves
from trlx_tpu_torch.utils import cosine_schedule, rampup_decay_schedule
from trlx_tpu_torch.utils.faults import DivergenceError, StepGuard
from trlx_tpu_torch.utils.loading import (
    get_model,
    get_orchestrator,
    get_pipeline,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------- #
# StepGuard
# --------------------------------------------------------------------- #


def test_step_guard_streak_resets_on_good_step():
    guard = StepGuard(max_bad_steps=3, rollback_fn=lambda: "ck",
                      log=lambda s: None)
    assert guard.observe(bad=True, step=1) == "skipped"
    assert guard.observe(bad=True, step=2) == "skipped"
    assert guard.observe(bad=False, step=3) == "ok"
    assert guard.bad_streak == 0 and guard.total_bad == 2


def test_step_guard_rolls_back_then_second_strike_aborts():
    events = []
    guard = StepGuard(max_bad_steps=2, rollback_fn=lambda: "/ck/step_4",
                      log=events.append)
    guard.observe(bad=True, step=5)
    assert guard.observe(bad=True, step=6) == "rollback"
    assert guard.rollbacks == 1 and guard.bad_streak == 0
    assert any("rollback" in e for e in events)
    guard.observe(bad=True, step=5, detail={"loss": float("nan")})
    with pytest.raises(DivergenceError) as exc:
        guard.observe(bad=True, step=6)
    msg = str(exc.value)
    assert "rollback" in msg and "learning_rate" in msg and "nan" in msg


def test_step_guard_without_checkpoint_aborts_with_hint():
    guard = StepGuard(max_bad_steps=1, rollback_fn=lambda: None,
                      log=lambda s: None)
    with pytest.raises(DivergenceError, match="no checkpoint"):
        guard.observe(bad=True, step=1)


def test_step_guard_disabled_is_free():
    guard = StepGuard(max_bad_steps=0)
    assert not guard.enabled
    assert guard.observe(bad=True, step=1) == "ok"
    assert guard.total_bad == 0


# --------------------------------------------------------------------- #
# the schedules on the device count
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("lr,total,lr_min", [
    (1.412e-4, 8, 1.412e-4), (1e-3, 1000, 1e-5), (3e-3, 1237, 1e-9),
    (1.412e-4, 80000, 1e-6),
])
def test_cosine_schedule_matches_optax_bitwise(lr, total, lr_min):
    counts = np.arange(total + 3, dtype=np.int32)
    theirs = np.asarray(jax.jit(jax.vmap(jax_cosine(lr, total, lr_min)))(
        jnp.asarray(counts)))
    schedule = cosine_schedule(lr, total, lr_min)
    ours = schedule(torch.from_numpy(counts))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    for step in range(0, total + 3, max(total // 7, 1)):
        one = schedule(torch.tensor(step, dtype=torch.int32))
        assert one.shape == () and float(one) == schedule(step) \
            == float(theirs[step])


def test_cosf_equals_the_c_library():
    """The float64 torch emulation of the C library's float32 cosine (the
    one XLA's CPU backend calls for the reference's schedule) on 200,000
    arguments in [0, pi], the schedule's whole domain, and its edges."""
    import ctypes
    import ctypes.util

    from trlx_tpu_torch.utils import cosf

    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.restype = ctypes.c_float
    libm.cosf.argtypes = [ctypes.c_float]
    rng = np.random.default_rng(0)
    args = np.concatenate([
        rng.uniform(0, np.pi, 200_000).astype(np.float32),
        np.float32([0.0, 2.0 ** -13, 0.75, np.pi / 4, np.pi / 2, np.pi]),
    ])
    theirs = np.array([libm.cosf(float(x)) for x in args], np.float32)
    np.testing.assert_array_equal(cosf(torch.from_numpy(args)).numpy(),
                                  theirs)


@pytest.mark.parametrize("ramp,decay,lr0,lr1", [
    (100, 3366, 1.412e-4, 1.412e-4 * 0.9), (2, 100, 3e-3, 1e-3),
    (100, 79000, 1.412e-4, 1.412e-4), (0, 0, 1e-3, 5e-4),
])
def test_rampup_decay_schedule_matches_optax_bitwise(ramp, decay, lr0, lr1):
    counts = np.arange(max(ramp, 1) + max(decay, 1) + 3, dtype=np.int32)
    theirs = np.asarray(jax.jit(jax.vmap(jax_rampup(ramp, decay, lr0, lr1)))(
        jnp.asarray(counts)))
    schedule = rampup_decay_schedule(ramp, decay, lr0, lr1)
    np.testing.assert_array_equal(
        schedule(torch.from_numpy(counts)).numpy(), theirs)
    for step in (0, 1, len(counts) - 1):
        assert schedule(step) == float(theirs[step])


# --------------------------------------------------------------------- #
# the commit gate
# --------------------------------------------------------------------- #


def _snapshot(trainer):
    return ([p.detach().clone() for p in _leaves(trainer.params)],
            [t.clone() for t in _leaves(trainer.opt_state)])


def _assert_unchanged(before, trainer):
    params, opt = before
    for a, b in zip(params, _leaves(trainer.params)):
        assert torch.equal(a, b)
    for a, b in zip(opt, _leaves(trainer.opt_state)):
        assert torch.equal(a, b)


def _configs(max_bad_steps=2, **train):
    jcfg = make_config(total_steps=20, batch_size=16, num_layers_unfrozen=1,
                       learning_rate=3e-3, ppo_epochs=1, epochs=100,
                       num_rollouts=64, chunk_size=16)
    jcfg.train.max_bad_steps = max_bad_steps
    for k, v in train.items():
        setattr(jcfg.train, k, v)
    return jcfg, TRLConfig.from_dict(jcfg.to_nested_dict())


def _nan(data):
    return {**data, "rewards": np.full_like(data["rewards"], np.nan)}


def test_ppo_nan_step_commits_nothing_then_a_clean_step_commits():
    _, cfg = _configs()
    trainer = get_model("JaxPPOTrainer")(cfg, device="cpu")
    data = _batch()
    clean = PPORLBatch(**{k: torch.from_numpy(v) for k, v in data.items()})
    poisoned = PPORLBatch(**{k: torch.from_numpy(v)
                             for k, v in _nan(data).items()})
    before = _snapshot(trainer)
    stats = trainer.train_multi(poisoned)
    assert float(stats["bad_step"]) == 1.0
    _assert_unchanged(before, trainer)
    assert int(trainer.opt_state["count"]) == 0
    stats = trainer.train_step(clean)
    assert float(stats["bad_step"]) == 0.0
    assert int(trainer.opt_state["count"]) == 1
    assert any(not torch.equal(a, b) for a, b in
               zip(before[0], _leaves(trainer.params)))


def test_ppo_kl_limit_skips_the_step():
    _, cfg = _configs(max_step_kl=1e-12)
    trainer = get_model("JaxPPOTrainer")(cfg, device="cpu")
    batch = PPORLBatch(**{k: torch.from_numpy(v)
                          for k, v in _batch().items()})
    before = _snapshot(trainer)
    stats = trainer.train_step(batch)
    assert float(stats["approx_kl"]) > 1e-12 and float(stats["bad_step"]) == 1
    _assert_unchanged(before, trainer)


def test_unguarded_step_has_no_verdict():
    _, cfg = _configs(max_bad_steps=0)
    trainer = get_model("JaxPPOTrainer")(cfg, device="cpu")
    stats = trainer.train_step(PPORLBatch(**{
        k: torch.from_numpy(v) for k, v in _batch().items()}))
    assert "bad_step" not in stats
    assert trainer.opt_state["count"].dtype == torch.int32
    assert int(trainer.opt_state["count"]) == 1


def _ilql_config(max_bad_steps=1):
    return TRLConfig.from_dict({
        "model": {
            "model_path": "from-config", "tokenizer_path": "byte",
            "model_type": "JaxILQLTrainer", "num_layers_unfrozen": -1,
            "model_spec": {"vocab_size": 16, "n_layer": 2, "n_head": 2,
                           "d_model": 16, "n_positions": 32},
            "compute_dtype": "float32",
        },
        "train": {
            "n_ctx": 32, "epochs": 1, "total_steps": 100, "batch_size": 8,
            "grad_clip": 1.0, "lr_ramp_steps": 1, "lr_decay_steps": 100,
            "weight_decay": 1e-6, "learning_rate_init": 3e-3,
            "learning_rate_target": 1e-3, "log_interval": 10**9,
            "checkpoint_interval": 10**9, "eval_interval": 10**9,
            "pipeline": "OfflinePipeline",
            "orchestrator": "OfflineOrchestrator", "input_size": 4,
            "gen_size": 6, "seed": 0, "max_bad_steps": max_bad_steps,
        },
        "method": {"name": "ilqlconfig", "tau": 0.7, "gamma": 0.99,
                   "cql_scale": 0.1, "awac_scale": 1.0, "alpha": 1.0,
                   "steps_for_target_q_sync": 2, "beta": 4.0,
                   "two_qs": True, "top_k": 20},
    })


def test_ilql_nan_step_commits_nothing_then_a_clean_step_commits():
    trainer = get_model("JaxILQLTrainer")(_ilql_config(), device="cpu")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 10, (8, 12)).astype(np.int32))
    mask = torch.ones((8, 12), dtype=torch.int32)
    poisoned = ILQLBatch(input_ids=ids, attention_mask=mask,
                         rewards=torch.full((8, 11), float("nan")))
    # a ramp of 1: the first step's lr is 0, so step once cleanly first
    clean = dataclasses.replace(poisoned, rewards=torch.zeros((8, 11)))
    assert float(trainer.train_step(clean)["bad_step"]) == 0.0
    before = _snapshot(trainer)
    stats = trainer.train_step(poisoned)
    assert float(stats["bad_step"]) == 1.0
    _assert_unchanged(before, trainer)
    assert int(trainer.opt_state["count"]) == 1
    assert float(trainer.train_step(clean)["bad_step"]) == 0.0
    assert int(trainer.opt_state["count"]) == 2
    assert any(not torch.equal(a, b) for a, b in
               zip(before[0], _leaves(trainer.params)))


def test_k_bad_steps_roll_back_then_second_strike_aborts(tmp_path):
    _, cfg = _configs(checkpoint_dir=str(tmp_path / "ckpt"))
    trainer = get_model("JaxPPOTrainer")(cfg, device="cpu")
    pipeline = get_pipeline("PPOPipeline")(PROMPTS, trainer.tokenizer, cfg)
    orch = get_orchestrator("PPOOrchestrator")(trainer, pipeline,
                                               reward_fn=reward_fn,
                                               chunk_size=16)
    orch.make_experience(64)  # four batches: the streak stays in one epoch
    trainer.save()
    saved = _snapshot(trainer)
    trainer.store.history = [
        b.map(lambda x: x) for b in trainer.store.history]
    for b in trainer.store.history:
        b.rewards = torch.full_like(b.rewards, float("nan"))
    logs = []
    with pytest.raises(DivergenceError) as exc:
        trainer.learn(log_fn=logs.append)
    assert len([s for s in logs if s.get("skipped_step")]) == 4
    rollbacks = [s for s in logs if s.get("rollback")]
    assert len(rollbacks) == 1
    assert rollbacks[0]["restored_from"].endswith("step_0")
    assert "diverged" in str(exc.value)
    _assert_unchanged(saved, trainer)
    assert trainer.iter_count == 2


# --------------------------------------------------------------------- #
# parity with trlx_tpu's guarded step
# --------------------------------------------------------------------- #


def test_guarded_steps_match_jax():
    jcfg, tcfg = _configs()
    jtrainer = jax_get_model("JaxPPOTrainer")(jcfg)
    params0 = jax.device_get(jtrainer.params)
    ttrainer = get_model("JaxPPOTrainer")(tcfg, device="cpu", params=params0)
    data = _batch()
    jparams, jopt = jtrainer.params, jtrainer.opt_state
    for step, batch in enumerate((_nan(data), data)):
        jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
        jparams, jopt, jstats = jtrainer._train_step(jparams, jopt, jbatch)
        tstats = ttrainer.train_step(PPORLBatch(**{
            k: torch.from_numpy(v) for k, v in batch.items()}))
        jstats = jax.device_get(jstats)
        assert sorted(tstats) == sorted(jstats)
        assert float(tstats["bad_step"]) == float(jstats["bad_step"]) \
            == float(step == 0)
        if step == 1:
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(tstats[k]),
                                           float(jstats[k]), rtol=1e-5,
                                           err_msg=k)
    assert int(ttrainer.opt_state["count"]) == 1
    _assert_updates_close(hydra_to_numpy(ttrainer.params["trainable"]),
                          jax.device_get(jparams["trainable"]),
                          params0["trainable"], max_step=1.01 * 3e-3)
