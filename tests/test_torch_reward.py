"""The port's device reward model (trlx_tpu_torch.models.reward), the
PPO orchestrator's device-reward branch and the ``ppo_tldr`` offline
fallback, against trlx_tpu where it has a counterpart
(tests/test_reward_model.py):

- ``RewardModel.score`` equals trlx_tpu's on the same weights at fp32
  (atol 1e-5), from the reference's own init carried across;
- left- and right-padded rows score the same; post-eos pads are ignored
  through the spliced mask; the host ``reward_fn`` protocol;
- the reward model's deep copy survives the trainer's in-place updates;
- the orchestrator's device branch scores what trlx_tpu's
  ``score_tokens`` scores, fed the same sequences (the two samplers'
  RNGs cannot agree, so the sequences come from one rollout);
- PPO ``evaluate`` with a device reward model returns trlx_tpu's keys;
- the ``ppo_tldr`` offline fallback runs a few steps end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelSpec as JaxSpec
from trlx_tpu.models.reward import DeviceRewardModel as JaxDeviceRM
from trlx_tpu.models.reward import RewardModel as JaxRewardModel
from trlx_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from trlx_tpu_torch.data.configs import ModelSpec
from trlx_tpu_torch.models.reward import DeviceRewardModel, RewardModel
from trlx_tpu_torch.trainers import _leaves
from trlx_tpu_torch.utils.tokenizer import ByteTokenizer

SPEC = dict(arch="gpt2", vocab_size=257, n_layer=2, n_head=4, d_model=64,
            n_positions=64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """The reference's reward model and init, and the port's on the same
    weights (carried across as numpy), both at fp32."""
    jmodel = JaxRewardModel(spec=JaxSpec(**SPEC), compute_dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = RewardModel(spec=ModelSpec(**SPEC), compute_dtype=torch.float32)
    rm = DeviceRewardModel(tmodel, jax.device_get(jparams), ByteTokenizer(),
                           max_length=16, device="cpu")
    return jmodel, jparams, tmodel, rm


def _rows(seed=0, B=6, T=12):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 257, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    for i in range(B):
        mask[i, :i] = 0  # left padding
        mask[i, T - (i % 3):] = 0  # and trailing pads
    return tokens, mask


def test_score_matches_jax(models):
    jmodel, jparams, tmodel, rm = models
    tokens, mask = _rows()
    theirs = np.asarray(jmodel.score(jparams, jnp.asarray(tokens),
                                     jnp.asarray(mask)))
    ours = tmodel.score(rm.params, torch.from_numpy(tokens),
                        torch.from_numpy(mask))
    assert ours.dtype == torch.float32 and ours.shape == (6,)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5, rtol=0)


def test_port_init_has_the_reference_structure(models):
    _, jparams, tmodel, _ = models
    ours = tmodel.init(seed=3)
    theirs = jax.device_get(jparams)
    flat = jax.tree_util.tree_flatten_with_path
    assert [(jax.tree_util.keystr(p), np.shape(x))
            for p, x in flat(ours)[0]] == \
        [(jax.tree_util.keystr(p), np.shape(x)) for p, x in flat(theirs)[0]]


def test_score_left_padded_matches_right_padded(models):
    _, _, tmodel, rm = models
    real = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    right = torch.full((1, 8), 99, dtype=torch.int32)
    right[0, :4] = real
    left = torch.full((1, 8), 99, dtype=torch.int32)
    left[0, 4:] = real
    right_mask = torch.tensor([[1, 1, 1, 1, 0, 0, 0, 0]], dtype=torch.int32)
    s_right = tmodel.score(rm.params, right, right_mask)
    s_left = tmodel.score(rm.params, left, right_mask.flip(-1))
    np.testing.assert_allclose(s_left.numpy(), s_right.numpy(), rtol=1e-5)


def test_device_rm_scores_ignore_post_eos_pads(models):
    """The orchestrator's spliced mask (prompt mask ++ gen_mask) scores a
    row that ended early at its last real token."""
    from trlx_tpu_torch.models.generation import GenerationOutput
    from trlx_tpu_torch.orchestrator.ppo_orchestrator import PPOOrchestrator

    _, _, tmodel, rm = models
    P = 2
    seq = torch.full((1, 8), 99, dtype=torch.int32)
    seq[0, :5] = torch.tensor([1, 2, 3, 4, 5])
    gen_mask = torch.tensor([[1, 1, 1, 0, 0, 0]], dtype=torch.int32)
    ones = torch.ones((1, 8), dtype=torch.int32)
    out = GenerationOutput(sequences=seq, gen_tokens=seq[:, P:],
                           gen_logprobs=torch.zeros(1, 6), gen_mask=gen_mask,
                           attention_mask=ones)
    orch = PPOOrchestrator.__new__(PPOOrchestrator)
    orch.reward_fn = rm
    full = orch.device_scores(out, P)
    truncated = tmodel.score(rm.params, seq[:, :5],
                             torch.ones((1, 5), dtype=torch.int32))
    np.testing.assert_allclose(full.numpy(), truncated.numpy(), rtol=1e-5)


def test_device_reward_model_reward_fn_protocol(models):
    jmodel, jparams, _, rm = models
    texts = ["good text", "bad", "hello world"]
    out = rm(texts)
    assert isinstance(out, list) and len(out) == 3
    assert all(isinstance(x, float) for x in out)
    assert out == rm(texts)
    theirs = JaxDeviceRM(jmodel, jparams, JaxByteTokenizer(),
                         max_length=16)(texts)
    np.testing.assert_allclose(out, theirs, atol=1e-5, rtol=0)


def _ppo(**train):
    from tests.test_ppo_e2e import PROMPTS, make_config, reward_fn
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import (
        get_model,
        get_orchestrator,
        get_pipeline,
    )

    jcfg = make_config(total_steps=4, epochs=2, num_rollouts=16,
                       chunk_size=16, batch_size=16, ppo_epochs=1)
    for k, v in train.items():
        setattr(jcfg.train, k, v)
    cfg = TRLConfig.from_dict(jcfg.to_nested_dict())
    trainer = get_model("JaxPPOTrainer")(cfg, device="cpu")
    return jcfg, cfg, trainer, get_orchestrator, get_pipeline, PROMPTS, \
        reward_fn


def test_rm_survives_trainer_in_place_updates():
    from trlx_tpu_torch.examples.ppo_tldr import build_reward_model

    _, cfg, trainer, get_orchestrator, get_pipeline, prompts, _ = _ppo()
    rm = build_reward_model(cfg, trainer, head_seed=3)
    trainer_leaves = {p.data_ptr() for p in _leaves(trainer.params)}
    assert not trainer_leaves & {p.data_ptr() for p in _leaves(rm.params)}
    before = [p.clone() for p in _leaves(rm.params)]
    top_before = trainer.params["trainable"]["blocks"]["attn"]["wq"].clone()
    pipeline = get_pipeline("PPOPipeline")(prompts, trainer.tokenizer, cfg)
    orch = get_orchestrator("PPOOrchestrator")(trainer, pipeline,
                                               reward_fn=rm, chunk_size=16)
    info = orch.make_experience(16)
    assert np.isfinite(info["mean_score"])
    trainer.learn(log_fn=lambda s: None)
    assert not torch.equal(trainer.params["trainable"]["blocks"]["attn"]
                           ["wq"], top_before)
    for a, b in zip(before, _leaves(rm.params)):
        assert torch.equal(a, b)


def test_orchestrator_device_branch_scores_as_jax_score_tokens(models):
    """One port rollout; its sequences and spliced mask go through the
    port's orchestrator branch and through trlx_tpu's ``score_tokens``
    on the same weights."""
    jmodel, jparams, tmodel, rm = models
    _, cfg, trainer, get_orchestrator, get_pipeline, prompts, _ = _ppo()
    pipeline = get_pipeline("PPOPipeline")(prompts, trainer.tokenizer, cfg)
    orch = get_orchestrator("PPOOrchestrator")(trainer, pipeline,
                                               reward_fn=rm, chunk_size=16)
    handle = orch.start_experience(16)
    out, query = handle["pendings"][0][:2]
    ours = orch.device_scores(out, query.shape[1])
    P = query.shape[1]
    jmask = np.concatenate([out.attention_mask[:, :P].numpy(),
                            out.gen_mask.numpy()], axis=1)
    theirs = JaxDeviceRM(jmodel, jparams, JaxByteTokenizer()).score_tokens(
        jnp.asarray(out.sequences.numpy()), jnp.asarray(jmask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5,
                               rtol=0)
    info = orch.finish_experience(handle)
    np.testing.assert_allclose(info["mean_score"],
                               float(np.asarray(theirs).mean()), rtol=1e-5)
    rewards = trainer.store.history[0].rewards
    last = (out.gen_mask.sum(-1) - 1).clamp(min=0)
    assert torch.isfinite(rewards).all()
    assert rewards[torch.arange(16), last].abs().sum() > 0


def test_evaluate_with_device_rm_returns_the_reference_keys(models):
    from trlx_tpu.utils.loading import get_model as jax_get_model

    jmodel, jparams, _, rm = models
    jcfg, cfg, trainer, _, _, _, _ = _ppo()
    jtrainer = jax_get_model("JaxPPOTrainer")(jcfg)
    rng = np.random.default_rng(0)
    prompts = (rng.integers(0, 256, (4, 4)).astype(np.int32),
               np.ones((4, 4), np.int32))
    jtrainer.set_orchestrator(None, JaxDeviceRM(jmodel, jparams,
                                                JaxByteTokenizer(),
                                                max_length=16))
    trainer.set_orchestrator(None, rm)
    theirs = jtrainer.evaluate(eval_prompts=prompts)
    ours = trainer.evaluate(eval_prompts=prompts)
    assert sorted(ours) == sorted(theirs) \
        == ["generations_table", "mean_score", "samples"]
    assert len(ours["generations_table"]["rows"]) == 4
    assert np.isfinite(ours["mean_score"])


def test_ppo_tldr_offline_fallback_runs_end_to_end():
    from trlx_tpu_torch.examples import ppo_tldr

    trainer, logs = ppo_tldr.main(["--device", "cpu", "--total-steps", "8"])
    assert trainer.iter_count == 8
    first = logs[0]["first_rollout"]
    assert first["rollouts"] == 32 and np.isfinite(first["mean_score"])
    train_logs = [entry for entry in logs if "loss" in entry]
    assert len(train_logs) == 2
    for entry in train_logs:
        for k in ("loss", "grad_norm", "approx_kl"):
            assert np.isfinite(entry[k]), k
    final = logs[-1]["final_eval"]
    assert sorted(final) == ["generations_table", "mean_score", "samples"]
