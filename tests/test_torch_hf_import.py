"""The port's pretrained import (trlx_tpu_torch.models.hf_import) against
trlx_tpu's, on tiny from-config HF models built with ``transformers`` (no
network), as tests/test_hf_parity.py builds them:

- every converter (gpt2, gptj, gptneox, llama, llama with grouped-query
  attention) turns the same torch ``state_dict`` into the same trunk as
  trlx_tpu's, leaf for leaf and exactly at float32; ``dtype=None`` keeps
  a bf16 state dict's dtype;
- ``load_trunk_from_hf`` on a tiny model saved to a directory gives the
  JAX function's (spec, embed, blocks, ln_f);
- a PPO trainer (gpt2 and gptj) and an ILQL trainer built from that
  directory with no ``model_spec``, their fresh heads carried across
  from the JAX trainer's tree, match trlx_tpu's logits (atol 1e-4) and
  first update (loss and pre-clip grad norm at rtol 1e-5), float32;
- a ``model_path`` that does not load raises, for both trainers and the
  inference engine, and never falls back to a random init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ppo_e2e import make_config
from trlx_tpu.data.configs import TRLConfig as JaxConfig
from trlx_tpu.data.ilql_types import ILQLBatch as JaxILQLBatch
from trlx_tpu.data.ppo_types import PPORLBatch as JaxBatch
from trlx_tpu.models import hf_import as jhf
from trlx_tpu.utils.loading import get_model as jax_get_model
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.ilql_types import ILQLBatch
from trlx_tpu_torch.data.ppo_types import PPORLBatch
from trlx_tpu_torch.models import hf_import as thf
from trlx_tpu_torch.serve import InferenceEngine, ServeConfig
from trlx_tpu_torch.trainers import copy_into
from trlx_tpu_torch.utils.loading import get_model

transformers = pytest.importorskip("transformers")

V = 257  # the byte tokenizer's vocabulary


def _make(arch):
    t = transformers
    cfgs = {
        "gpt2": lambda: t.GPT2Config(vocab_size=V, n_positions=32, n_embd=64,
                                     n_layer=2, n_head=4),
        "gptj": lambda: t.GPTJConfig(vocab_size=V, n_positions=32, n_embd=64,
                                     n_layer=2, n_head=4, rotary_dim=8),
        "gptneox": lambda: t.GPTNeoXConfig(
            vocab_size=V, max_position_embeddings=32, hidden_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, rotary_pct=0.5),
        "llama": lambda: t.LlamaConfig(
            vocab_size=V, max_position_embeddings=32, hidden_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, intermediate_size=128,
            tie_word_embeddings=False),
        "llama_gqa": lambda: t.LlamaConfig(
            vocab_size=V, max_position_embeddings=32, hidden_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=128,
            rope_theta=500000.0, tie_word_embeddings=False),
    }
    torch.manual_seed(0)
    return t.AutoModelForCausalLM.from_config(cfgs[arch]())


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _assert_trees_equal(ours, theirs):
    fo, ft = _flat(ours), _flat(theirs)
    assert sorted(fo) == sorted(ft)
    for k in fo:
        assert isinstance(fo[k], torch.Tensor), k
        np.testing.assert_array_equal(fo[k].numpy(), np.asarray(ft[k]),
                                      err_msg=k)


@pytest.mark.parametrize("arch", ["gpt2", "gptj", "gptneox", "llama",
                                  "llama_gqa"])
def test_converters_match_jax_exactly(arch):
    model = _make(arch)
    sd = model.state_dict()
    spec = thf.spec_from_hf_config(model.config)
    jspec = jhf.spec_from_hf_config(model.config)
    assert spec.__dict__ == jspec.__dict__
    ours = thf.convert_state_dict(sd, spec)
    theirs = jhf.convert_state_dict(sd, jspec)
    for a, b in zip(ours, theirs):
        _assert_trees_equal(a, b)
        assert all(x.dtype == torch.float32 and x.is_contiguous()
                   for x in _flat(a).values())
    # a bf16 state dict converts in its own dtype on request, to the same
    # values the float32 default gives
    sd16 = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    kept = thf.convert_state_dict(sd16, spec, dtype=None)
    wide = thf.convert_state_dict(sd16, spec)
    for a, b in zip(kept, wide):
        fa, fb = _flat(a), _flat(b)
        for k in fa:
            assert fa[k].dtype == torch.bfloat16, k
            assert torch.equal(fa[k].float(), fb[k]), k


def test_fail_fast_checks_match_jax():
    cfg = transformers.LlamaConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        rope_scaling={"rope_type": "linear", "factor": 2.0})
    for mod in (thf, jhf):
        with pytest.raises(ValueError, match="rope_scaling"):
            mod.spec_from_hf_config(cfg)
    cfg = transformers.LlamaConfig(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128, attention_bias=True)
    for mod in (thf, jhf):
        with pytest.raises(ValueError, match="attention_bias"):
            mod.spec_from_hf_config(cfg)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Tiny gpt2 and gptj checkpoints saved as a local directory each."""
    out = {}
    for arch in ("gpt2", "gptj"):
        path = tmp_path_factory.mktemp(arch)
        _make(arch).save_pretrained(str(path))
        out[arch] = str(path)
    return out


def test_load_trunk_from_hf_matches_jax(saved):
    spec, *trunk = thf.load_trunk_from_hf(saved["gptj"])
    jspec, *jtrunk = jhf.load_trunk_from_hf(saved["gptj"])
    assert spec.__dict__ == jspec.__dict__
    assert spec.arch == "gptj" and not spec.tie_lm_head
    for a, b in zip(trunk, jtrunk):
        _assert_trees_equal(a, b)


def _ppo_configs(path):
    jcfg = make_config(total_steps=8, batch_size=16, num_layers_unfrozen=1,
                       ppo_epochs=1)
    jcfg.model.model_spec = None
    jcfg.model.model_path = path
    return jcfg, TRLConfig.from_dict(jcfg.to_nested_dict())


def _ppo_batch(seed=0, B=16, P=4, G=8):
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


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)),
                                  tree)


@pytest.mark.parametrize("arch", ["gpt2", "gptj"])
def test_ppo_trainer_from_pretrained_matches_jax(arch, saved):
    jcfg, tcfg = _ppo_configs(saved[arch])
    jtrainer = jax_get_model("JaxPPOTrainer")(jcfg)
    ttrainer = get_model("JaxPPOTrainer")(tcfg, device="cpu")
    assert ttrainer.policy.spec.arch == arch
    jparams = jax.device_get(jtrainer.params)
    # the imported weights agree; the fresh value heads come from two
    # generators, so the JAX tree's is carried across
    for part in ("frozen_base", "ref"):
        _assert_trees_equal(ttrainer.params[part], jparams[part])
    trainable = {k: v for k, v in ttrainer.params["trainable"].items()
                 if k != "v_head"}
    _assert_trees_equal(
        jax.tree_util.tree_map(lambda x: x.detach(), trainable),
        {k: v for k, v in jparams["trainable"].items() if k != "v_head"})
    copy_into(ttrainer.params["trainable"]["v_head"],
              _to_torch(jparams["trainable"]["v_head"]))

    data = _ppo_batch()
    tokens = np.concatenate([data["query_tensors"],
                             data["response_tensors"]], 1)
    mask = np.concatenate([data["query_masks"],
                           np.ones_like(data["response_tensors"])], 1)
    jlogits, _, jvalues = jtrainer.policy.forward(
        jtrainer.params, jnp.asarray(tokens), jnp.asarray(mask))
    with torch.no_grad():
        tlogits, _, tvalues = ttrainer.policy.forward(
            ttrainer.params, torch.from_numpy(tokens),
            torch.from_numpy(mask))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tvalues.numpy(), np.asarray(jvalues),
                               atol=1e-4, rtol=0)

    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})
    _, _, jstats = jtrainer._train_step(jtrainer.params, jtrainer.opt_state,
                                        jbatch)
    tstats = ttrainer.train_step(
        PPORLBatch(**{k: torch.from_numpy(v) for k, v in data.items()}))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-5, err_msg=k)


def _ilql_cfg(path):
    from tests.test_torch_ilql import _config_dict

    cfg = _config_dict()
    cfg["model"].update(model_spec=None, model_path=path)
    return cfg


def test_ilql_trainer_from_pretrained_matches_jax(saved):
    from tests.test_torch_ilql import _batch as ilql_batch

    cfg = _ilql_cfg(saved["gpt2"])
    jtrainer = jax_get_model("JaxILQLTrainer")(JaxConfig.from_dict(cfg))
    ttrainer = get_model("JaxILQLTrainer")(TRLConfig.from_dict(cfg),
                                           device="cpu")
    jparams = jax.device_get(jtrainer.params)
    heads = ("v_head", "q1_head", "q2_head")
    for name in heads:
        copy_into(ttrainer.params["trainable"][name],
                  _to_torch(jparams["trainable"][name]))
    copy_into(ttrainer.params["target"], _to_torch(jparams["target"]))
    _assert_trees_equal(
        jax.tree_util.tree_map(lambda x: x.detach(),
                               ttrainer.params["trainable"]),
        jparams["trainable"])
    _assert_trees_equal(ttrainer.params["frozen_base"],
                        jparams["frozen_base"])

    data = ilql_batch()
    jlogits = jtrainer.net.forward(jtrainer.params,
                                   jnp.asarray(data["input_ids"]),
                                   jnp.asarray(data["attention_mask"]))[0]
    with torch.no_grad():
        tlogits = ttrainer.net.forward(
            ttrainer.params, torch.from_numpy(data["input_ids"]),
            torch.from_numpy(data["attention_mask"]))[0]
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    jbatch = JaxILQLBatch(**{k: jnp.asarray(v) for k, v in data.items()})
    _, _, jstats = jtrainer._train_step(jtrainer.params, jtrainer.opt_state,
                                        jbatch)
    tstats = ttrainer.train_step(
        ILQLBatch(**{k: torch.from_numpy(v) for k, v in data.items()}))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-5, err_msg=k)


def test_engine_serves_the_pretrained_trunk(saved):
    """With no model_spec the engine takes its spec and weights from the
    checkpoint: greedy decode equals the trainer's policy built from the
    same directory (same trunk, same top)."""
    _, tcfg = _ppo_configs(saved["gptj"])
    engine = InferenceEngine(tcfg, ServeConfig(buckets=[[2, 4, 4]]),
                             device="cpu")
    trainer = get_model("JaxPPOTrainer")(tcfg, device="cpu")
    assert engine.spec == trainer.policy.spec
    views = InferenceEngine(tcfg, ServeConfig(buckets=[[2, 4, 4]]),
                            device="cpu", params=trainer.params)
    for a, b in zip(jax.tree_util.tree_leaves(
            (engine.blocks, engine.embed, engine.ln_f)),
            jax.tree_util.tree_leaves((views.blocks, views.embed,
                                       views.ln_f))):
        assert torch.equal(a, b)


def test_bad_model_path_raises_and_never_inits_randomly(tmp_path):
    missing = str(tmp_path / "no-such-model")
    jcfg, tcfg = _ppo_configs(missing)
    with pytest.raises(RuntimeError, match="could not load pretrained"):
        get_model("JaxPPOTrainer")(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="could not load pretrained"):
        get_model("JaxILQLTrainer")(TRLConfig.from_dict(_ilql_cfg(missing)),
                                    device="cpu")
    with pytest.raises(RuntimeError, match="could not resolve"):
        InferenceEngine(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="could not load pretrained"):
        jax_get_model("JaxPPOTrainer")(jcfg)
