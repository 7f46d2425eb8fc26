"""The port's Adafactor (trlx_tpu_torch.trainers.Adafactor, built by
``build_optimizer`` for ``train.optimizer: adafactor``) against trlx_tpu's
``optax.chain(clip_by_global_norm, optax.adafactor(...))`` on the CPU:

- six steps on a tree with factored leaves (two axes of >= 128, one of
  them stacked [L, d, f] as the trainers' blocks are), unfactored 2-D
  leaves and 1-D leaves, under the cosine schedule with weight decay
  1e-6, clipped and unclipped steps: the parameters at rtol 1e-5 / atol
  1e-7 after every step;
- a gated step (a NaN gradient) leaves every parameter and every piece
  of state bit-identical;
- a trainer's save and ``resume_from`` round-trip the factored state: the
  next update is bit-identical;
- ``_check_memory_fit`` counts adafactor's optimizer state as 0: the
  gpt-j-6B hydra it refuses under AdamW on a 16 GB card it accepts under
  adafactor, as trlx_tpu's does, and the shipped single-card recipe
  passes;
- the recipe as chip_smoke.py builds it (no pyyaml on the card's
  machine) is configs/ppo_gptj_single_chip.yml, and its spec is
  gpt-j-6B's published geometry."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_ppo_e2e import make_config
from trlx_tpu.data.configs import ModelSpec as JaxSpec
from trlx_tpu.trainers import BaseRLTrainer as JaxBase
from trlx_tpu.trainers.ppo_trainer import build_optimizer as jax_optimizer
from trlx_tpu_torch.data.configs import ModelSpec, TRLConfig
from trlx_tpu_torch.trainers import (
    Adafactor,
    BaseRLTrainer,
    _leaves,
    build_optimizer,
    factored_dims,
    global_norm,
)
from trlx_tpu_torch.utils.loading import get_model

SHAPES = {
    "blocks": {"w": (2, 128, 160), "b": (2, 160)},  # factored on (1, 2)
    "wide": (130, 140),  # factored
    "narrow": (64, 200),  # second axis < 128: unfactored
    "bias": (150,),  # 1-D
}


def _configs(total_steps=6):
    jcfg = make_config(total_steps=total_steps, learning_rate=3e-2)
    jcfg.train.optimizer = "adafactor"
    jcfg.train.learning_rate_target = 3e-3
    return jcfg, TRLConfig.from_dict(jcfg.to_nested_dict())


def _tree(fn, shapes=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(k, v)
            for k, v in shapes.items()}


def _paths(shapes=SHAPES, prefix=""):
    out = []
    for k, v in shapes.items():
        out += _paths(v, prefix + k + ".") if isinstance(v, dict) \
            else [prefix + k]
    return out


def _get(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


def test_factored_dims_match_optax():
    from optax._src.factorized import _factored_dims

    for shape in [(4,), (128, 128), (127, 512), (2, 128, 160), (160, 130),
                  (1, 4096, 16384), (16384, 4096), (3, 7, 200)]:
        assert factored_dims(shape) == _factored_dims(shape, True, 128)


def test_six_steps_match_optax_adafactor():
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(0)
    params = _tree(lambda k, s: rng.standard_normal(s).astype(np.float32)
                   * 0.05)
    # step 0 tiny (the 1-D leaf's rms below scale_by_param_block_rms'
    # 1e-3 floor would not show here: the bias starts at zero instead)
    params["bias"][:] = 0.0
    scales = [0.01, 5.0, 0.2, 3.0, 0.05, 1.0]  # global norms above and
    grads = [_tree(lambda k, s: rng.standard_normal(s).astype(np.float32)
                   * scale / 300.0) for scale in scales]  # below 1.0

    jopt = jax_optimizer(jcfg.train)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    opt = build_optimizer(tcfg.train)
    assert isinstance(opt, Adafactor)
    tparams = _tree(lambda k, s: None)
    for path in _paths():
        parent = tparams
        for k in path.split(".")[:-1]:
            parent = parent[k]
        parent[path.split(".")[-1]] = torch.from_numpy(
            _get(params, path).copy())
    leaves = [_get(tparams, p) for p in _paths()]
    state = opt.init(tparams)
    for step, g in enumerate(grads):
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = [torch.from_numpy(_get(g, p)) for p in _paths()]
        norm = opt.step(leaves, tg, state)
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for path, leaf in zip(_paths(), leaves):
            np.testing.assert_allclose(
                leaf.numpy(), np.asarray(_get(jparams, path)), rtol=1e-5,
                atol=1e-7, err_msg=f"{path} step {step}")
    assert int(state["count"]) == len(grads)
    # optax's FactoredState layout: v_row / v_col for factored leaves, v
    # for the others, [1] placeholders elsewhere
    w = _paths().index("blocks.w")
    assert state["v_row"][w].shape == (2, 128)
    assert state["v_col"][w].shape == (2, 160)
    assert state["v"][w].shape == (1,)
    b = _paths().index("bias")
    assert state["v"][b].shape == (150,) and state["v_row"][b].shape == (1,)


def test_gated_step_changes_nothing():
    _, tcfg = _configs()
    opt = build_optimizer(tcfg.train)
    rng = np.random.default_rng(1)
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((2, 128, 160), (64, 200), (150,))]
    state = opt.init(leaves)
    good = [torch.full_like(p, 1e-3) for p in leaves]
    opt.step(leaves, good, state)  # nonzero moments to hold
    before = ([p.clone() for p in leaves],
              [t.clone() for t in _leaves(state)])
    bad = [g.clone() for g in good]
    bad[1][3, 4] = float("nan")
    g_norm = global_norm(bad)
    ok = torch.isfinite(g_norm)
    assert not bool(ok)
    opt.step(leaves, bad, state, ok=ok, g_norm=g_norm)
    for a, b in zip(leaves, before[0]):
        assert torch.equal(a, b)
    after = _leaves(state)
    assert len(after) == len(before[1])
    for a, b in zip(after, before[1]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(state["count"]) == 1


def test_save_resume_round_trip_is_bit_identical(tmp_path):
    from tests.test_torch_ppo import _batch
    from trlx_tpu_torch.data.ppo_types import PPORLBatch

    _, tcfg = _configs(total_steps=8)
    tcfg.train.checkpoint_dir = str(tmp_path / "run")
    trainer = get_model("JaxPPOTrainer")(tcfg, device="cpu")
    assert isinstance(trainer.opt, Adafactor)
    batch = PPORLBatch(**{k: torch.from_numpy(v)
                          for k, v in _batch().items()})
    trainer.train_step(batch)
    trainer.iter_count = 1
    trainer.save()
    _, cfg2 = _configs(total_steps=8)
    cfg2.train.checkpoint_dir = tcfg.train.checkpoint_dir
    cfg2.train.seed = 5
    cfg2.train.resume_from = "auto"
    resumed = get_model("JaxPPOTrainer")(cfg2, device="cpu")
    assert resumed.iter_count == 1 and int(resumed.opt_state["count"]) == 1
    for a, b in zip(_leaves(trainer.opt_state), _leaves(resumed.opt_state)):
        assert a.shape == b.shape and torch.equal(a, b)
    stats = trainer.train_step(batch)
    stats2 = resumed.train_step(batch)
    assert torch.equal(stats["loss"], stats2["loss"])
    for a, b in zip(_leaves(trainer.params), _leaves(resumed.params)):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(trainer.opt_state), _leaves(resumed.opt_state)):
        assert torch.equal(a, b)


def _fit_stub(config, port: bool):
    if port:
        return types.SimpleNamespace(config=config,
                                     device=torch.device("cuda"))
    return types.SimpleNamespace(config=config, mesh=None)


@pytest.mark.parametrize("k", [2, 1])
def test_memory_fit_counts_adafactor_as_zero(k, monkeypatch):
    """On a 16 GiB card the bf16-frozen gpt-j-6B hydra with 2 unfrozen
    layers needs ~19 GB under fp32 AdamW and is refused (the message
    offers adafactor), and ~15 GB under adafactor, which passes: the same
    verdicts as trlx_tpu's check on the same config. The shipped
    single-card recipe (1 unfrozen layer, adafactor) passes."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (0, 16 * 2**30))

    class FakeDev:
        def memory_stats(self):
            return {"bytes_limit": 16 * 2**30}

    monkeypatch.setattr(jax, "local_devices", lambda: [FakeDev()])
    jcfg, tcfg = _configs()
    for cfg in (jcfg, tcfg):
        cfg.model.num_layers_unfrozen = k
    spec, jspec = ModelSpec.preset("gpt-j-6b"), JaxSpec.preset("gpt-j-6b")

    def verdicts(optimizer):
        out = []
        for cfg, port in ((tcfg, True), (jcfg, False)):
            cfg.train.optimizer = optimizer
            check = BaseRLTrainer._check_memory_fit if port \
                else JaxBase._check_memory_fit
            try:
                check(_fit_stub(cfg, port), spec if port else jspec,
                      torch.bfloat16 if port else jnp.bfloat16)
                out.append("fits")
            except ValueError as e:
                assert "adafactor" in str(e) and "param_dtype" in str(e)
                out.append("refused")
        assert out[0] == out[1], out
        return out[0]

    assert verdicts("adafactor") == "fits"
    assert verdicts("adamw") == ("refused" if k == 2 else "fits")


def test_chip_smoke_recipe_is_the_shipped_yaml():
    import pathlib

    import chip_smoke

    path = pathlib.Path(__file__).resolve().parent.parent / "configs" / \
        "ppo_gptj_single_chip.yml"
    shipped = TRLConfig.load_yaml(str(path)).to_nested_dict()
    assert TRLConfig.from_dict(
        chip_smoke.gptj_recipe_config()).to_nested_dict() == shipped
    spec = ModelSpec(**chip_smoke.GPTJ_SPEC)
    assert spec == ModelSpec.preset("gpt-j-6b")
    assert (spec.vocab_size, spec.n_layer, spec.n_head, spec.d_model,
            spec.d_ff, spec.rotary_dim, spec.head_dim) == \
        (50400, 28, 16, 4096, 16384, 64, 256)
