"""The port's GPipe schedule (trlx_tpu_torch.ops.pipeline_parallel) run
in-process (every pp stage in this process, the loopback exchange) on
the CPU against trlx_tpu.ops.pipeline_parallel.pp_apply_blocks on the 8
virtual CPU devices, from the same numpy blocks and activations at
float32 (atol 2e-5 + rtol 2e-5, as tests/test_parallel.py holds
trlx_tpu's schedule to the dense trunk): pp 2 and 4, with left padding,
dense attention and the flash seam (its plain versions on the CPU)
inside the stages, every microbatch count that divides the batch; the
pp 1 passthrough; and the refusals with trlx_tpu's messages: an uneven
stage split, a batch that microbatches do not divide, a trunk of zero
frozen layers under pp, sp combined with pp."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ppo import _configs as ppo_configs
from trlx_tpu.data.configs import ModelSpec as JaxSpec
from trlx_tpu.models.transformer import causal_mask_bias as jax_bias
from trlx_tpu.models.transformer import init_block_params
from trlx_tpu.models.transformer import positions_from_mask as jax_positions
from trlx_tpu.ops.pipeline_parallel import pp_apply_blocks as jax_pp
from trlx_tpu.ops.pipeline_parallel import shard_blocks_pp as jax_shard
from trlx_tpu.parallel import build_mesh
from trlx_tpu.utils.loading import get_model as jax_get_model
from trlx_tpu_torch.data.configs import ModelSpec
from trlx_tpu_torch.models.transformer import (
    apply_blocks,
    causal_mask_bias,
    positions_from_mask,
    tree_map,
)
from trlx_tpu_torch.ops import flash_attention as fa
from trlx_tpu_torch.ops.pipeline_parallel import pp_apply_blocks_loopback
from trlx_tpu_torch.parallel import AXES
from trlx_tpu_torch.trainers import BaseRLTrainer, check_ported
from trlx_tpu_torch.utils.loading import get_model

SPEC = dict(vocab_size=31, n_layer=8, n_head=4, d_model=32, n_positions=16)


def _case(n_layer=8, B=8, T=10):
    blocks = jax.device_get(init_block_params(
        jax.random.PRNGKey(0), JaxSpec(**{**SPEC, "n_layer": n_layer}),
        n_layer, jnp.float32))
    r = np.random.default_rng(0)
    h = r.normal(size=(B, T, 32)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[:2, :3] = 0  # left padding, as rollouts have it
    return blocks, h, mask


def _jax_out(blocks, h, mask, pp, n_micro, shard=True):
    mesh = build_mesh({"pp": pp, "dp": 8 // pp})
    jm = jnp.asarray(mask)
    jb = jax.tree_util.tree_map(jnp.asarray, blocks)
    return np.asarray(jax_pp(
        mesh, jax_shard(mesh, jb) if shard else jb,
        JaxSpec(**{**SPEC, "n_layer": len(blocks["ln_1"]["scale"])}),
        jnp.asarray(h), jax_bias(jm), jax_positions(jm), n_micro=n_micro))


def _port(blocks, h, mask, pp, n_micro, attention_fn=None):
    tm = torch.from_numpy(mask)
    tb = tree_map(lambda x: torch.from_numpy(np.array(x)), blocks)
    spec = ModelSpec(**{**SPEC, "n_layer": len(blocks["ln_1"]["scale"])})
    bias = tm if getattr(attention_fn, "takes_raw_mask", False) \
        else causal_mask_bias(tm)
    return pp_apply_blocks_loopback(
        tb, pp, spec, torch.from_numpy(h), bias, positions_from_mask(tm),
        n_micro=n_micro, attention_fn=attention_fn).numpy()


@pytest.mark.parametrize("pp,n_micro", [(2, 4), (4, 4), (2, 2), (4, 8),
                                        (2, 1)])
def test_gpipe_matches_trlx_tpu(devices, pp, n_micro):
    blocks, h, mask = _case()
    ours = _port(blocks, h, mask, pp, n_micro)
    np.testing.assert_allclose(ours, _jax_out(blocks, h, mask, pp, n_micro),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("pp", [2, 4])
def test_gpipe_runs_the_flash_seam_inside_the_stages(devices, pp):
    """The stages' attention is the flash seam (plain versions on the
    CPU): real rows equal trlx_tpu's dense schedule."""
    blocks, h, mask = _case(T=12)
    fn = fa.make_flash_attention_fn(min_fused_t=0)
    ours = _port(blocks, h, mask, pp, 4, attention_fn=fn)
    real = mask.astype(bool)
    np.testing.assert_allclose(ours[real],
                               _jax_out(blocks, h, mask, pp, 4)[real],
                               rtol=2e-5, atol=2e-5)


def test_gpipe_keeps_no_gradient(devices):
    blocks, h, mask = _case()
    tb = tree_map(lambda x: torch.from_numpy(np.array(x)).requires_grad_(),
                  blocks)
    tm = torch.from_numpy(mask)
    out = pp_apply_blocks_loopback(
        tb, 2, ModelSpec(**SPEC), torch.from_numpy(h), causal_mask_bias(tm),
        positions_from_mask(tm))
    assert not out.requires_grad and out.grad_fn is None


def test_pp_single_stage_passthrough(devices):
    """pp 1 is the plain trunk, with no microbatching constraint (3 does
    not divide the batch of 4)."""
    blocks, h, mask = _case(n_layer=2, B=4, T=6)
    tm = torch.from_numpy(mask)
    tb = tree_map(lambda x: torch.from_numpy(np.array(x)), blocks)
    spec = ModelSpec(**{**SPEC, "n_layer": 2})
    out = _port(blocks, h, mask, 1, 3)
    want = apply_blocks(tb, spec, torch.from_numpy(h), causal_mask_bias(tm),
                        positions_from_mask(tm)).numpy()
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("n_layer,B,n_micro", [(6, 8, 4), (8, 6, 4)])
def test_refusals_match_trlx_tpu(devices, n_layer, B, n_micro):
    """An uneven stage split and a batch that microbatches do not divide:
    the same ValueError as trlx_tpu's."""
    blocks, h, mask = _case(n_layer=n_layer, B=B)
    with pytest.raises(ValueError) as ours:
        _port(blocks, h, mask, 4, n_micro)
    with pytest.raises(ValueError) as theirs:
        # unplaced: placing 6 layers over pp 4 would fail first
        _jax_out(blocks, h, mask, 4, n_micro, shard=False)
    assert str(ours.value) == str(theirs.value)


class _Mesh:
    """A stand-in DeviceMesh of the given axis sizes (``size`` is all that
    ``_pp_kwargs`` reads), for the construction-time checks in one
    process."""

    def __init__(self, **sizes):
        self.sizes = [sizes.get(ax, 1) for ax in AXES]

    def size(self, i):
        return self.sizes[i]


def _jax_refusal(mesh_config, n_layer=3, num_layers_unfrozen=1,
                 batch_size=16):
    jcfg = ppo_configs()[0]
    jcfg.model.model_spec["n_layer"] = n_layer
    jcfg.model.num_layers_unfrozen = num_layers_unfrozen
    jcfg.train.batch_size = batch_size
    jcfg.train.mesh = mesh_config
    with pytest.raises(ValueError) as theirs:
        jax_get_model("JaxPPOTrainer")(jcfg)
    return str(theirs.value)


@pytest.mark.parametrize("case", ["zero_frozen", "uneven", "micro"])
def test_trainer_pp_checks_match_trlx_tpu(devices, case):
    """``_pp_kwargs`` on a pp 2 mesh: a trunk of zero frozen layers, one
    of 1 frozen layer over 2 stages, a batch of 6 over 4 microbatches —
    each refused with trlx_tpu's message (trlx_tpu's trainer on the
    virtual devices); a good trunk gets the pipelining kwargs."""
    n_layer, unfrozen, batch = {"zero_frozen": (3, -1, 16),
                                "uneven": (2, 1, 16),
                                "micro": (3, 1, 6)}[case]
    theirs = _jax_refusal({"pp": 2, "dp": 4}, n_layer, unfrozen, batch)
    cfg = ppo_configs()[1]
    stub = SimpleNamespace(mesh=_Mesh(pp=2, dp=4), config=cfg)
    with pytest.raises(ValueError) as ours:
        BaseRLTrainer._pp_kwargs(stub, n_layer - (n_layer if unfrozen < 0
                                                  else unfrozen), batch)
    assert str(ours.value) == theirs
    good = BaseRLTrainer._pp_kwargs(stub, 2, 32)
    assert good == {"pp_mesh": stub.mesh, "pp_n_micro": 4}


@pytest.mark.parametrize("trainer", ["JaxPPOTrainer", "JaxILQLTrainer"])
def test_sp_with_pp_refused_as_trlx_tpu(devices, trainer):
    """sp and pp together: refused before any mesh is built, with
    trlx_tpu's message."""
    from tests.test_torch_ilql import _config_dict
    from trlx_tpu_torch.data.configs import TRLConfig

    theirs = _jax_refusal({"pp": 2, "sp": 2, "dp": 2})
    cfg = ppo_configs()[1] if trainer == "JaxPPOTrainer" \
        else TRLConfig.from_dict(_config_dict())
    cfg.train.mesh = {"pp": 2, "sp": 2, "dp": 2}
    with pytest.raises(ValueError) as ours:
        get_model(trainer)(cfg, device="cpu")
    assert str(ours.value) == theirs
    with pytest.raises(ValueError) as again:
        check_ported(cfg, _Mesh(pp=2, sp=2))
    assert str(again.value) == theirs
