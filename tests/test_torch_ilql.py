"""The port's ILQL slice (trlx_tpu_torch: losses, ILQLModel, the weights
bridge, the extras hook of ``generate``, the offline pipeline,
orchestrator and trainer) against trlx_tpu's, on the CPU at float32 from
the same numpy inputs and weights:

- ``ilql_losses`` and ``ilql_losses_chunked`` against trlx_tpu's and
  against tests/test_ilql.py's numpy replica of the reference formulas,
  with an out-of-vocab pad id on masked positions: loss and stats at
  atol 1e-5, the chunked loss's gradients at atol 1e-5;
- ``ILQLModel.forward`` (logits, Q, target Q, V) at full and partial
  unfreeze, dense and through the flash seam (JAX's Pallas kernel in
  interpret mode, the port's plain kernel versions; ``_MIN_FUSED_T`` 0 on
  both sides) on a right-padded, terminal-holed mask, after a bridge
  round trip: atol 2e-4;
- two and three train steps from the same weights and batch: loss and
  pre-clip grad norm at rtol 1e-5, the updated parameters by
  tests/test_torch_ppo.py's relative-L2 rule, no gradient to the target
  heads;
- the advantage-shifted step logits (a [V] and a [V, V] mask) equal to
  JAX's at atol 1e-5, and top_k = 1 generation token-identical;
- the orchestrator's rows, masks and whitened rewards from text (the
  byte tokenizer's left-padding quirk included) and from token rows;
- the randomwalks example learns; the device-resident and per-batch
  dataset paths give identical parameters; the refused knobs raise and
  the run supervisor's knobs reach the trainer's run floor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ilql import np_ilql_loss
from tests.test_torch_ppo import (  # noqa: F401 (an autouse fixture)
    _assert_updates_close,
    one_torch_thread,
)
from trlx_tpu.data.configs import ModelSpec as JaxSpec
from trlx_tpu.data.configs import TRLConfig as JaxConfig
from trlx_tpu.data.ilql_types import ILQLBatch as JaxBatch
from trlx_tpu.models.ilql import ILQLModel as JaxNet
from trlx_tpu.models.ilql import sync_targets as jax_sync_targets
from trlx_tpu.ops import losses as jl
from trlx_tpu.ops import pallas_attention as jpa
from trlx_tpu.trainers import ilql_trainer as jax_ilql_trainer
from trlx_tpu.utils import rampup_decay_schedule as jax_schedule
from trlx_tpu.utils.loading import get_model as jax_get_model
from trlx_tpu.utils.loading import get_orchestrator as jax_get_orchestrator
from trlx_tpu_torch.data.configs import ModelSpec, TRLConfig
from trlx_tpu_torch.data.ilql_types import ILQLBatch
from trlx_tpu_torch.models.ilql import ILQLModel, sync_targets
from trlx_tpu_torch.models.params import (
    ilql_to_numpy,
    ilql_to_torch,
    init_ilql_numpy,
)
from trlx_tpu_torch.models.transformer import tree_map
from trlx_tpu_torch.ops import flash_attention as tfa
from trlx_tpu_torch.ops import losses as tl
from trlx_tpu_torch.trainers.ilql_trainer import JaxILQLTrainer
from trlx_tpu_torch.utils import rampup_decay_schedule
from trlx_tpu_torch.utils.loading import get_model, get_orchestrator

ATOL = 2e-4
SPEC = dict(arch="gpt2", vocab_size=29, n_layer=2, n_head=4, d_model=32,
            n_positions=32)
LOSS_ARGS = (0.99, 0.7, 0.1, 1.0)  # gamma, tau, cql_scale, awac_scale


def _holed_mask(B, T, lengths):
    """Right-padded rows of ``lengths`` with the terminal slot zeroed."""
    mask = np.zeros((B, T), np.int32)
    for i, n in enumerate(lengths):
        mask[i, :n - 1] = 1
    return mask


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


# --------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("two_qs", [True, False])
def test_ilql_losses_match_jax_and_golden(two_qs):
    """Whole and chunked losses against JAX's and the numpy replica; an
    out-of-vocab pad id sits on the masked positions; the chunked loss's
    gradients (w.r.t. the hidden state and every head weight) against
    JAX's chunked loss's."""
    rng = np.random.default_rng(0)
    B, T, D, V = 3, 11, 8, 13
    n_q = 2 if two_qs else 1
    mask = _holed_mask(B, T, [11, 7, 4])
    tokens = rng.integers(0, V, (B, T)).astype(np.int32)
    tokens[mask == 0] = V + 5  # a pad id past the vocabulary
    tokens[:, 0] = rng.integers(0, V, B)
    rewards = np.zeros((B, T - 1), np.float32)
    for i, n in enumerate([11, 7, 4]):
        rewards[i, n - 2] = rng.normal()
    h = rng.normal(size=(B, T, D)).astype(np.float32)
    q_names, t_names = ("q1", "q2")[:n_q], ("t1", "t2")[:n_q]
    w = {name: (0.5 * rng.normal(size=(D, V))).astype(np.float32)
         for name in ("lm",) + q_names + t_names}
    w_v = rng.normal(size=(D,)).astype(np.float32)

    def jax_loss(h, w, chunked):
        fns = {k: (lambda x, m=w[k]: x @ m) for k in w}
        tq = tuple((lambda x, m=w[k]: jax.lax.stop_gradient(x @ m))
                   for k in t_names)
        vs = h @ w["v"]
        if chunked:
            return jl.ilql_losses_chunked(
                fns["lm"], tuple(fns[k] for k in q_names), tq, vs, h,
                jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(rewards),
                *LOSS_ARGS, chunk=4)
        return jl.ilql_losses(
            h @ w["lm"], tuple(h @ w[k] for k in q_names),
            tuple(f(h) for f in tq), vs, jnp.asarray(tokens),
            jnp.asarray(mask), jnp.asarray(rewards), *LOSS_ARGS)

    def torch_loss(h, w, chunked):
        tq = tuple((lambda x, m=w[k]: (x @ m).detach()) for k in t_names)
        vs = h @ w["v"]
        args = (torch.from_numpy(tokens), torch.from_numpy(mask),
                torch.from_numpy(rewards), *LOSS_ARGS)
        if chunked:
            return tl.ilql_losses_chunked(
                lambda x: x @ w["lm"],
                tuple((lambda x, m=w[k]: x @ m) for k in q_names), tq, vs,
                h, *args, chunk=4)
        return tl.ilql_losses(h @ w["lm"], tuple(h @ w[k] for k in q_names),
                              tuple(f(h) for f in tq), vs, *args)

    jw = {**{k: jnp.asarray(v) for k, v in w.items()}, "v": jnp.asarray(w_v)}
    golden = np_ilql_loss(
        h @ w["lm"], [h @ w[k] for k in q_names], [h @ w[k] for k in t_names],
        h @ w_v, np.clip(tokens, 0, V - 1), mask, rewards, *LOSS_ARGS)
    for chunked in (False, True):
        tw = {k: torch.tensor(v, requires_grad=True)
              for k, v in {**w, "v": w_v}.items()}
        th = torch.tensor(h, requires_grad=True)
        (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
            lambda h, w: jax_loss(h, w, chunked), argnums=(0, 1),
            has_aux=True))(jnp.asarray(h), jw)
        tloss, tstats = torch_loss(th, tw, chunked)
        assert sorted(tstats) == sorted(jstats)
        for k in tstats:
            np.testing.assert_allclose(tstats[k].item(), float(jstats[k]),
                                       atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(tloss.item(), golden, atol=1e-5, rtol=0)
        tloss.backward()
        np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgrads[0]),
                                   atol=1e-5, rtol=0)
        for k, g in jgrads[1].items():
            if k in t_names:  # target heads: no gradient on either side
                assert tw[k].grad is None and not np.asarray(g).any()
                continue
            np.testing.assert_allclose(tw[k].grad.numpy(), np.asarray(g),
                                       atol=1e-5, rtol=0, err_msg=k)


def test_rampup_decay_schedule_matches_optax():
    for ramp, decay, lr0, lr1 in ((100, 3366, 1e-3, 1e-3),
                                  (3, 5, 2e-3, 1e-4), (0, 0, 1e-3, 5e-4)):
        ours = rampup_decay_schedule(ramp, decay, lr0, lr1)
        theirs = jax_schedule(ramp, decay, lr0, lr1)
        assert ours(0) == 0.0
        for step in list(range(0, 12)) + [99, 100, 101, 3466, 3500]:
            np.testing.assert_allclose(ours(step), float(theirs(step)),
                                       rtol=1e-6, atol=1e-12)


# --------------------------------------------------------------------- #
# the network and the bridge
# --------------------------------------------------------------------- #


def _params(k, two_qs=True, seed=1):
    """A seeded numpy ILQL tree in JAX's layout (the port's init, whose
    structure, shapes and dtypes test_bridge_round_trip_and_init_structure
    holds to JAX's init), fresh on every call."""
    return init_ilql_numpy(ModelSpec(**SPEC), k, two_qs, seed=seed)


def _nets(k, flash, monkeypatch, two_qs=True):
    jattn = tattn = None
    if flash:
        monkeypatch.setattr(jpa, "_MIN_FUSED_T", 0)
        monkeypatch.setattr(tfa, "_MIN_FUSED_T", 0)
        jattn = jpa.make_pallas_attention_fn(block=16)
        tattn = tfa.make_flash_attention_fn()
    jnet = JaxNet(spec=JaxSpec(**SPEC), num_layers_unfrozen=k,
                  two_qs=two_qs, compute_dtype=jnp.float32,
                  attention_fn=jattn)
    tnet = ILQLModel(spec=ModelSpec(**SPEC), num_layers_unfrozen=k,
                     two_qs=two_qs, compute_dtype=torch.float32,
                     attention_fn=tattn)
    return jnet, tnet


@pytest.mark.parametrize("k,two_qs", [(-1, True), (1, True), (-1, False)])
def test_bridge_round_trip_and_init_structure(k, two_qs):
    """The port's seeded init has the tree structure, shapes and dtypes
    of JAX's init (traced with ``jax.eval_shape``), zero-size bottom
    leaves and the empty frozen embed at full unfreeze included, and
    targets equal to the Q heads; numpy -> torch -> numpy is exact."""
    jnet = JaxNet(spec=JaxSpec(**SPEC), num_layers_unfrozen=k, two_qs=two_qs,
                  compute_dtype=jnp.float32)
    want = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    params = _params(k, two_qs)
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(_leaves_np(params), jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = ilql_to_numpy(ilql_to_torch(params))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(_leaves_np(back), _leaves_np(params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if k == -1:
        assert params["frozen_base"]["embed"] == {} == back["frozen_base"][
            "embed"]
        assert back["frozen_base"]["blocks"]["attn"]["wq"].shape[0] == 0
        assert set(back["trainable"]["embed"]) == {"wte", "wpe"}
    for name in params["target"]:
        for key in params["target"][name]:
            np.testing.assert_array_equal(params["target"][name][key],
                                          params["trainable"][name][key])


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("k", [-1, 1])
def test_forward_matches_jax(k, flash, monkeypatch):
    """logits, Q, target Q and V at every position (pad query rows attend
    to their row's real prefix) of right-padded, terminal-holed rows."""
    jnet, tnet = _nets(k, flash, monkeypatch)
    params = _params(k)
    rng = np.random.default_rng(3)
    params["trainable"] = jax.tree_util.tree_map(
        lambda x: (x + 0.02 * rng.standard_normal(x.shape)).astype(x.dtype),
        params["trainable"])
    B, T = 3, 21
    tokens = rng.integers(0, SPEC["vocab_size"], (B, T)).astype(np.int32)
    mask = _holed_mask(B, T, [21, 13, 6])
    tparams = ilql_to_torch(ilql_to_numpy(ilql_to_torch(params)))
    jout = jax.jit(jnet.forward)(params, jnp.asarray(tokens),
                                jnp.asarray(mask))
    tout = tnet.forward(tparams, torch.from_numpy(tokens),
                        torch.from_numpy(mask))
    flat_j = jax.tree_util.tree_leaves(jout)
    flat_t = jax.tree_util.tree_leaves(tout)
    assert len(flat_j) == len(flat_t) == 6
    for t, j in zip(flat_t, flat_j):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=ATOL, rtol=0)
    assert not tout[2][0].requires_grad  # the target heads


def test_targets_take_no_gradient_and_sync():
    """The loss reaches every trainable leaf (the tied wte through both
    the lookup and the logits) and no target leaf; a sync with alpha 1
    makes target Q equal Q, and alpha 0.25 matches JAX's lerp."""
    _, tnet = _nets(-1, False, None)
    params = _params(-1)
    tparams = ilql_to_torch(params)
    rng = np.random.default_rng(5)
    B, T = 2, 9
    tokens = torch.from_numpy(rng.integers(0, 29, (B, T)).astype(np.int32))
    mask = torch.from_numpy(_holed_mask(B, T, [9, 6]))
    rewards = torch.zeros((B, T - 1))
    rewards[:, -1] = 1.0
    logits, qs, tqs, vs = tnet.forward(tparams, tokens, mask)
    loss, _ = tl.ilql_losses(logits, qs, tqs, vs, tokens, mask, rewards,
                             *LOSS_ARGS)
    loss.backward()
    for name, branch in tparams.items():
        leaves = []
        tree_map(leaves.append, branch)
        assert all((x.grad is not None) == (name == "trainable")
                   for x in leaves), name
    # the tied head: wte's gradient is the lookup's plus the logits'
    assert tparams["trainable"]["embed"]["wte"].grad[
        tokens.unique().long()].abs().sum() > 0
    unseen = sorted(set(range(29)) - set(tokens.flatten().tolist()))
    assert tparams["trainable"]["embed"]["wte"].grad[unseen].abs().sum() > 0

    perturbed = jax.tree_util.tree_map(np.copy, params)
    perturbed["trainable"]["q1_head"] = jax.tree_util.tree_map(
        lambda x: x + 1.0, perturbed["trainable"]["q1_head"])
    want = jax.device_get(jax_sync_targets(perturbed, 0.25))
    ours = ilql_to_torch(perturbed)
    sync_targets(ours, 0.25)
    for a, b in zip(_leaves_np(ilql_to_numpy(ours["target"])),
                    _leaves_np(want["target"])):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    sync_targets(ours, 1.0)
    _, qs, tqs, _ = tnet.forward(ours, tokens, mask)
    for q, tq in zip(qs, tqs):
        np.testing.assert_array_equal(q.detach().numpy(), tq.numpy())


# --------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------- #


def _config_dict(epochs=1, fused=False, top_k=20, two_qs=True, gen_size=6):
    return {
        "model": {
            "model_path": "from-config", "tokenizer_path": "byte",
            "model_type": "JaxILQLTrainer", "num_layers_unfrozen": -1,
            "model_spec": {k: v for k, v in SPEC.items() if k != "arch"},
            "compute_dtype": "float32", "fused_attention": fused or None,
        },
        "train": {
            "n_ctx": 32, "epochs": epochs, "total_steps": 10**9,
            "batch_size": 8, "grad_clip": 1.0, "lr_ramp_steps": 2,
            "lr_decay_steps": 100, "weight_decay": 1e-6,
            "learning_rate_init": 3e-3, "learning_rate_target": 1e-3,
            "log_interval": 10**9, "checkpoint_interval": 10**9,
            "eval_interval": 10**9, "pipeline": "OfflinePipeline",
            "orchestrator": "OfflineOrchestrator", "input_size": 4,
            "gen_size": gen_size, "seed": 0,
        },
        "method": {
            "name": "ilqlconfig", "tau": 0.7, "gamma": 0.99,
            "cql_scale": 0.1, "awac_scale": 1.0, "alpha": 1.0,
            "steps_for_target_q_sync": 2, "beta": 4.0, "two_qs": two_qs,
            "top_k": top_k,
        },
    }


def _trainers(logit_mask=None, **kw):
    """A JAX trainer and the port's from the same weights."""
    cfg = _config_dict(**kw)
    jtrainer = jax_get_model("JaxILQLTrainer")(JaxConfig.from_dict(cfg),
                                               logit_mask=logit_mask)
    params = jax.device_get(jtrainer.params)
    ttrainer = get_model("JaxILQLTrainer")(
        TRLConfig.from_dict(cfg), logit_mask=logit_mask, device="cpu",
        params=params)
    return jtrainer, ttrainer


def _batch(seed=0, B=8, T=19):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, T + 1, B)
    lengths[0] = T
    ids = np.full((B, T), SPEC["vocab_size"] - 1, np.int32)
    rewards = np.zeros((B, T - 1), np.float32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(0, SPEC["vocab_size"], n)
        rewards[i, n - 2] = rng.normal()
    return dict(input_ids=ids, attention_mask=_holed_mask(B, T, lengths),
                rewards=rewards)


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's three train steps on :func:`_batch`, dense and through the
    flash seam, computed once: {fused: (trainer config, start params,
    [(stats, params) per step])}."""
    runs = {}
    data = _batch()
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})
    for fused in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if fused:
                mp.setattr(jpa, "_MIN_FUSED_T", 0)
            cfg = _config_dict(fused=fused)
            jtrainer = jax_get_model("JaxILQLTrainer")(
                JaxConfig.from_dict(cfg))
        params0 = jax.device_get(jtrainer.params)
        jp, jo, steps = jtrainer.params, jtrainer.opt_state, []
        for _ in range(3):
            jp, jo, stats = jtrainer._train_step(jp, jo, jbatch)
            steps.append((jax.device_get(stats), jax.device_get(jp)))
        runs[fused] = (cfg, params0, steps)
    return runs


@pytest.mark.parametrize("steps,fused", [(2, False), (3, False), (2, True),
                                         (3, True)])
def test_train_steps_match_jax(steps, fused, jax_steps, monkeypatch):
    """From the same weights and batch (the ramp makes the first step's
    lr 0, so one step would move nothing): every step's loss and
    pre-clip grad norm at rtol 1e-5, the stats at rtol 1e-5 + atol 1e-6,
    the updated parameters by the relative-L2 rule; the target heads do
    not move, and a sync makes them the updated Q heads."""
    cfg, params0, jsteps = jax_steps[fused]
    if fused:
        monkeypatch.setattr(tfa, "_MIN_FUSED_T", 0)
    ttrainer = get_model("JaxILQLTrainer")(TRLConfig.from_dict(cfg),
                                           device="cpu", params=params0)
    assert (ttrainer.net.attention_fn is not None) == fused
    tbatch = ILQLBatch(**{k: torch.from_numpy(v)
                          for k, v in _batch().items()})
    for step, (jstats, _) in enumerate(jsteps[:steps]):
        tstats = ttrainer.train_step(tbatch)
        assert sorted(tstats) == sorted(jstats)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=1e-5, err_msg=f"{k} {step}")
        for k in tstats:
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    jp = jsteps[steps - 1][1]
    _assert_updates_close(ilql_to_numpy(ttrainer.params["trainable"]),
                          jp["trainable"], params0["trainable"],
                          max_step=1.01 * 3e-3 * steps)
    for a, b in zip(_leaves_np(ilql_to_numpy(ttrainer.params["target"])),
                    _leaves_np(params0["target"])):
        np.testing.assert_array_equal(a, b)
    ttrainer.sync_targets()
    for name in ttrainer.params["target"]:
        for key, t in ttrainer.params["target"][name].items():
            np.testing.assert_array_equal(
                t.numpy(), ttrainer.params["trainable"][name][key]
                .detach().numpy())


def _jax_extras(jtrainer, monkeypatch):
    """The extras_fn JAX's trainer hands to ``generate``."""
    captured = {}

    def fake_generate(*args, extras_fn=None, **kw):
        captured["fn"] = extras_fn
        raise StopIteration

    monkeypatch.setattr(jax_ilql_trainer, "generate", fake_generate)
    with pytest.raises(StopIteration):
        jtrainer._generate_fn(jtrainer.params, None, None, None, None)
    monkeypatch.undo()
    return captured["fn"]


@pytest.mark.parametrize("mask_kind", ["vocab", "edges"])
def test_extras_and_greedy_generation_match_jax(mask_kind, monkeypatch):
    """The advantage-shifted step logits of the port's extras hook equal
    JAX's (a [V] mask, or a [V, V] edge mask read at the previous token,
    True = disallowed; a previous token past the vocabulary is clamped);
    with top_k = 1 the draw is deterministic and the generated tokens are
    identical."""
    V = SPEC["vocab_size"]
    rng = np.random.default_rng(6)
    if mask_kind == "vocab":
        logit_mask = rng.random(V) < 0.3
    else:
        logit_mask = rng.random((V, V)) < 0.5
        np.fill_diagonal(logit_mask, False)
    for top_k in (5, 1):
        jtrainer, ttrainer = _trainers(logit_mask=logit_mask, top_k=top_k)
        extras = _jax_extras(jtrainer, monkeypatch)
        h = rng.normal(size=(4, SPEC["d_model"])).astype(np.float32)
        logits = rng.normal(size=(4, V)).astype(np.float32)
        prev = np.array([0, 3, V - 1, 256], np.int32)
        want = np.asarray(extras(jnp.asarray(h), jnp.asarray(logits),
                                 jnp.asarray(prev)))
        got = ttrainer._extras(torch.from_numpy(h), torch.from_numpy(logits),
                               torch.from_numpy(prev)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        assert ((got > -1e8).sum(-1) <= top_k).all()
    # top_k = 1: token-identical decode from pre-tokenized prompts
    prompts = [[1, 2, 3], [4], [5, 6], [7, 8, 9]]
    jout = jtrainer.sample(prompts)
    tout = ttrainer.sample(prompts)
    np.testing.assert_array_equal(tout, np.asarray(jout))


# --------------------------------------------------------------------- #
# orchestrator, pipeline, loop
# --------------------------------------------------------------------- #


def _reward(samples):
    return [float(sum(int(t) % 7 for t in s)) for s in samples]


@pytest.mark.parametrize("kind", ["text", "tokens"])
def test_orchestrator_matches_jax(kind):
    """Same store rows, masks (terminal slot zeroed) and whitened returns
    as JAX's orchestrator, and the same collated batches. Text goes
    through ``tokenize``: the byte tokenizer left-pads every row to
    gen_size with its pad id (256), which the rows then keep as tokens —
    the JAX package does the same."""
    jtrainer, ttrainer = _trainers(gen_size=20)
    rng = np.random.default_rng(7)
    if kind == "text":
        samples = ["abc", "hello there", "x", "a much longer sample"]
    else:
        samples = [list(rng.integers(0, 29, n)) for n in (5, 9, 3, 12, 7)]
    for trainer, orch in ((jtrainer, jax_get_orchestrator),
                          (ttrainer, get_orchestrator)):
        orch("OfflineOrchestrator")(trainer, samples, [[1], [2]],
                                    reward_fn=_reward)
    js, ts = jtrainer.train_store, ttrainer.train_store
    assert len(js) == len(ts) == len(samples)
    for field in ("input_ids", "attention_mask", "rewards"):
        for a, b in zip(getattr(ts, field), getattr(js, field)):
            np.testing.assert_array_equal(a, b, err_msg=field)
    if kind == "text":
        gen = ttrainer.config.train.gen_size
        assert all(len(r) == gen for r in ts.input_ids)
        assert ts.input_ids[0][0] == 256  # "abc" + eos, left-padded
    returns = np.array([r[-1] for r in ts.rewards])
    np.testing.assert_allclose(returns.mean(), 0.0, atol=1e-6)
    for eos in (0, 28):
        jb = next(iter(js.create_loader(3, eos_token_id=eos)))
        tb = next(iter(ts.create_loader(3, eos_token_id=eos)))
        for field in ("input_ids", "attention_mask", "rewards"):
            np.testing.assert_array_equal(getattr(tb, field),
                                          np.asarray(getattr(jb, field)))
        assert tb.rewards.shape[1] == tb.input_ids.shape[1] - 1
    assert ttrainer.eval_pipeline.texts == [[1], [2]]


def test_randomwalks_example_learns_on_cpu():
    """The port's randomwalks example beats its own `before` by more than
    5 points on the percent-of-optimal-path metric (1 epoch)."""
    from trlx_tpu_torch.examples import ilql_randomwalks

    trainer, before, after = ilql_randomwalks.main(
        ["--device", "cpu", "--epochs", "1"])
    assert trainer.iter_count == 16
    assert after["percentage"] > before["percentage"] + 5, (before, after)


def test_device_resident_and_per_batch_paths_agree(monkeypatch):
    """Identical parameters whether the collated dataset stays on the
    device (index gathers) or each batch is sliced and uploaded."""
    from trlx_tpu_torch.examples.randomwalks_data import (
        generate_random_walks,
    )

    def run(limit):
        monkeypatch.setenv("TRLX_TPU_DATASET_HBM_BYTES", str(limit))
        walks, logit_mask, stats_fn, reward_fn = generate_random_walks(
            seed=11, n_walks=96)
        cfg = _config_dict(epochs=2)
        cfg["model"]["model_spec"]["vocab_size"] = logit_mask.shape[0]
        trainer = get_model("ILQLModel")(TRLConfig.from_dict(cfg),
                                         logit_mask=logit_mask, device="cpu")
        get_orchestrator("OfflineOrchestrator")(
            trainer, walks, [[1]], reward_fn=reward_fn, stats_fn=stats_fn)
        logs = []
        trainer.learn(log_fn=logs.append)
        assert trainer.iter_count == 24
        return _leaves_np(ilql_to_numpy(trainer.params))

    for a, b in zip(run(2**40), run(0)):
        np.testing.assert_array_equal(a, b)


def test_learn_logs_evaluates_and_syncs(monkeypatch):
    """learn(): evals at eval_interval (reward, stats_fn keys), logs at
    log_interval with samples_per_sec and the time/* spans, a target sync
    every steps_for_target_q_sync steps, stop at total_steps."""
    from trlx_tpu_torch.examples.randomwalks_data import (
        generate_random_walks,
    )

    walks, logit_mask, stats_fn, reward_fn = generate_random_walks(
        seed=3, n_walks=64)
    cfg = _config_dict(epochs=5)
    cfg["model"]["model_spec"]["vocab_size"] = logit_mask.shape[0]
    cfg["train"].update(total_steps=5, log_interval=2, eval_interval=4)
    trainer = get_model("JaxILQLTrainer")(TRLConfig.from_dict(cfg),
                                          logit_mask=logit_mask,
                                          device="cpu")
    assert isinstance(trainer, JaxILQLTrainer)
    get_orchestrator("OfflineOrchestrator")(
        trainer, walks, np.arange(1, 5).reshape(-1, 1), reward_fn=reward_fn,
        stats_fn=stats_fn)
    syncs = []
    real_sync = trainer.sync_targets
    monkeypatch.setattr(trainer, "sync_targets",
                        lambda: (syncs.append(trainer.iter_count),
                                 real_sync()))
    logs = []
    trainer.learn(log_fn=logs.append)
    assert trainer.iter_count == 5 and syncs == [2, 4]
    evals = [e for e in logs if "percentage" in e]
    train = [e for e in logs if "loss" in e]
    assert [e["iter"] for e in evals] == [0, 4]
    assert [e["iter"] for e in train] == [2, 4]
    for e in train:
        for k in ("loss", "loss_q", "loss_v", "loss_cql", "loss_awac",
                  "grad_norm", "samples_per_sec", "time/ilql_update"):
            assert np.isfinite(e[k]), k


def test_registry_and_config_resolve_to_the_port():
    for name in ("JaxILQLTrainer", "ILQLModel", "ilqlmodel"):
        assert get_model(name) is JaxILQLTrainer
    assert get_orchestrator("OfflineOrchestrator").__module__.startswith(
        "trlx_tpu_torch.")
    cfg = TRLConfig.load_yaml("configs/ilql_config.yml")
    jcfg = JaxConfig.load_yaml("configs/ilql_config.yml")
    assert cfg.method.__dict__ == jcfg.method.__dict__
    assert cfg.train.batch_size == 80 and cfg.model.num_layers_unfrozen == -1


@pytest.mark.parametrize("knob,value", [
    ("mesh", {"dp": 2, "fsdp": 1, "tp": 1, "sp": 2, "pp": 2}),
    ("mesh", {"dp": 1, "sp": 2, "pp": 2}),
    ("mesh", {"sp": 4, "pp": 2}),
])
def test_refused_knobs_raise(knob, value):
    """sp and pp each train; combined they are refused, with
    trlx_tpu's message."""
    cfg = _config_dict()
    cfg["train"][knob] = value
    with pytest.raises(ValueError, match="cannot combine with sp > 1"):
        get_model("JaxILQLTrainer")(TRLConfig.from_dict(cfg), device="cpu")


@pytest.mark.parametrize("knob,value", [
    ("stall_timeout", 30.0), ("max_walltime", 3600.0),
    ("chaos", "ilql_update:exc@2"),
])
def test_supervisor_knobs_reach_the_run_floor(knob, value, tmp_path,
                                              monkeypatch):
    """The knobs the port refused until the run supervisor was ported
    construct an ILQL trainer whose RunSupervisor or chaos schedule
    carries them."""
    from tests.test_torch_ppo import assert_supervisor_knob
    from trlx_tpu_torch.supervisor import chaos

    cfg = _config_dict()
    cfg["train"][knob] = value
    trainer = get_model("JaxILQLTrainer")(TRLConfig.from_dict(cfg),
                                          device="cpu")
    try:
        assert_supervisor_knob(trainer, knob, value, tmp_path, monkeypatch)
    finally:
        chaos.reset()


def test_refused_entry_points_raise():
    """No model_spec: the pretrained import of model_path fails and the
    trainer raises rather than start from random weights; no card: the
    default device raises."""
    cfg = _config_dict()
    cfg["model"]["model_spec"] = None
    with pytest.raises(RuntimeError, match="could not load pretrained"):
        get_model("JaxILQLTrainer")(TRLConfig.from_dict(cfg), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model("JaxILQLTrainer")(TRLConfig.from_dict(_config_dict()))
