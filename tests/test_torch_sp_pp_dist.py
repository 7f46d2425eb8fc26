"""Sequence and pipeline parallelism across processes: a world of 4 gloo
ranks on the CPU (tests/torch_parallel_worker.py's ``sp_pp`` scenarios),
started once for the module, held against trlx_tpu on the same mesh
sizes (4 of the 8 virtual CPU devices) from the same numpy weights and
batches, at float32:

- a PPO step and two ILQL steps on {dp: 2, sp: 2}, {sp: 2, tp: 2} and
  {pp: 2, fsdp: 2}: loss and pre-clip grad norm at rtol 1e-5, every
  stat at rtol 1e-5 + atol 1e-6, the updated parameters by
  tests/test_golden_step.py's relative-L2 rule; under sp the ring is
  the attention and each rank runs its chunk of positions, under pp the
  frozen trunk is pipelined and each rank holds its slab of layers; the
  parameters bit-identical on every rank (digests);
- make_experience on {dp: 2, sp: 2} and {pp: 2, fsdp: 2}: the rollout
  store bit-identical on every rank, its tokens those of one process and
  its logprobs, values and rewards within atol 1e-5 of one process's;
- PPO on {dp: 2, sp: 2} with prompts longer than a chunk (input 8,
  gen 4, so rank 0's chunk ends before the response window starts): a
  step against trlx_tpu and make_experience against one process, as
  above;
- ``shard_blocks_pp`` + ``pp_apply_blocks`` on the pp mesh, and on
  {pp: 4} (a layer a stage, so the first ticks leave stages idle),
  against the whole trunk at atol 1e-5;
- the pp-sharded trunk's checkpoint: saved on the mesh, restored into a
  fresh mesh trainer (every rank's digest unchanged) and into one plain
  process, every tensor bit-identical;
- trlx_tpu's refusals at construction on the world's meshes: a trunk of
  zero frozen layers under pp, T not divisible by sp.

Each child logs to a file and has its own timeout (the module fixture
of tests/test_torch_parallel_dist.py, which this one shares)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ppo_e2e import PROMPTS
from tests.test_torch_ilql import _batch as ilql_data
from tests.test_torch_ilql import _config_dict as ilql_config_dict
from tests.test_torch_parallel_dist import (
    WORLD,
    _assert_stats,
    _assert_trees_equal,
    _bk_step,
    _jax_ppo_step,
    _np,
    _spawn,
)
from tests.test_torch_ppo import _assert_updates_close
from tests.test_torch_ppo import _batch as ppo_data
from tests.test_torch_ppo import _configs as ppo_configs
from trlx_tpu.data.configs import TRLConfig as JaxConfig
from trlx_tpu.data.ilql_types import ILQLBatch as JaxILQLBatch
from trlx_tpu.parallel import build_mesh as jax_build_mesh
from trlx_tpu.parallel import shard_batch as jax_shard_batch
from trlx_tpu.parallel import shard_params as jax_shard_params
from trlx_tpu.utils.loading import get_model as jax_get_model
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.params import hydra_to_numpy
from trlx_tpu_torch.utils.loading import get_model, get_orchestrator
from trlx_tpu_torch.utils.loading import get_pipeline

MESHES = {"dp_sp": {"dp": 2, "sp": 2}, "sp_tp": {"sp": 2, "tp": 2},
          "pp_fsdp": {"pp": 2, "fsdp": 2}}


def _long_prompt_ppo_config():
    """The PPO test config with prompts of 8 and responses of 4: T 12
    over sp 2 gives chunks of 6, and the window starts at position 7."""
    jcfg = ppo_configs()[0]
    jcfg.train.input_size, jcfg.train.gen_size = 8, 4
    jcfg.method.gen_kwargs = dict(jcfg.method.gen_kwargs, max_length=4,
                                  min_length=4)
    return jcfg


def _pp_ppo_config():
    """The PPO test config with a 3-layer trunk, 1 unfrozen: 2 frozen
    layers split into pp 2 stages."""
    jcfg = ppo_configs()[0]
    jcfg.model.model_spec["n_layer"] = 3
    return jcfg


def _ilql_config(pp: bool):
    cfg = ilql_config_dict()
    if pp:  # full unfreeze leaves no frozen trunk to pipeline
        cfg["model"]["model_spec"] = dict(cfg["model"]["model_spec"],
                                          n_layer=3)
        cfg["model"]["num_layers_unfrozen"] = 1
    return cfg


def _jax_ilql_steps(cfg, params0, data, mesh_config):
    mesh = jax_build_mesh(mesh_config, devices=jax.devices()[:WORLD])
    jtrainer = jax_get_model("JaxILQLTrainer")(JaxConfig.from_dict(cfg),
                                               mesh=mesh)
    jp = jax_shard_params(mesh, jax.tree_util.tree_map(jnp.asarray, params0))
    jo = jtrainer.opt_state
    batch = jax_shard_batch(mesh, JaxILQLBatch(**{
        k: jnp.asarray(v) for k, v in data.items()}))
    steps = []
    for _ in range(2):
        jp, jo, stats = jtrainer._train_step(jp, jo, batch)
        steps.append(jax.device_get(stats))
    return steps, jax.device_get(jp["trainable"])


def _jax_refusal(cfg, mesh_config):
    mesh = jax_build_mesh(mesh_config, devices=jax.devices()[:WORLD])
    with pytest.raises(ValueError) as e:
        jax_get_model(cfg.model.model_type)(cfg, mesh=mesh)
    return str(e.value)


def _host_reward(samples):
    return [sum(c.islower() for c in s) / max(len(s), 1) for s in samples]


def _plain_store(cfg_dict, params):
    """make_experience in one plain process: the store the mesh's ranks
    must reproduce."""
    cfg = TRLConfig.from_dict(cfg_dict)
    tr = get_model("JaxPPOTrainer")(cfg, device="cpu", params=params)
    pipeline = get_pipeline(cfg.train.pipeline)(PROMPTS, tr.tokenizer, cfg)
    orch = get_orchestrator(cfg.train.orchestrator)(
        tr, pipeline, reward_fn=_host_reward,
        chunk_size=cfg.method.chunk_size)
    orch.make_experience(cfg.method.num_rollouts)
    store = tr.store._stacked()
    return {k: getattr(store, k).numpy().copy() for k in
            ("response_tensors", "logprobs", "values", "rewards")}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("torch_sp_pp_dist")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _run(workdir)
    finally:
        torch.set_num_threads(threads)


def _run(workdir: Path):
    ref, inputs = {}, {}
    data = ppo_data(0)
    idata = ilql_data(T=20)  # T divisible by sp
    for key, jcfg in (("sp", ppo_configs()[0]), ("pp", _pp_ppo_config())):
        params = jax.device_get(jax_get_model("JaxPPOTrainer")(jcfg).params)
        icfg = _ilql_config(key == "pp")
        iparams = jax.device_get(jax_get_model("JaxILQLTrainer")(
            JaxConfig.from_dict(icfg)).params)
        inputs.update({f"{key}_ppo_config": jcfg.to_nested_dict(),
                       f"{key}_ppo_params": params,
                       f"{key}_ilql_config": icfg,
                       f"{key}_ilql_params": iparams})
        for name, mesh_config in MESHES.items():
            if ("pp" in mesh_config) != (key == "pp"):
                continue
            ref[name] = {
                "ppo": _jax_ppo_step(jcfg, params, data, mesh_config),
                "ilql": _jax_ilql_steps(icfg, iparams, idata, mesh_config)}
        ref[f"store_{key}"] = _plain_store(jcfg.to_nested_dict(), params)

    long_cfg, long_data = _long_prompt_ppo_config(), ppo_data(0, P=8, G=4)
    ref["long_prompt"] = _jax_ppo_step(long_cfg, inputs["sp_ppo_params"],
                                       long_data, MESHES["dp_sp"])
    ref["store_long"] = _plain_store(long_cfg.to_nested_dict(),
                                     inputs["sp_ppo_params"])
    inputs.update({"long_ppo_config": long_cfg.to_nested_dict(),
                   "long_ppo_batch": long_data})

    zero = ppo_configs()[0]
    zero.model.num_layers_unfrozen = -1
    zero.train.mesh = MESHES["pp_fsdp"]
    t_sp = ppo_configs()[0]
    t_sp.train.gen_size = 7
    t_sp.method.gen_kwargs = dict(t_sp.method.gen_kwargs, max_length=7,
                                  min_length=7)
    t_sp.train.mesh = MESHES["dp_sp"]
    ref["refusals"] = {"zero_frozen": _jax_refusal(zero, MESHES["pp_fsdp"]),
                       "t_sp": _jax_refusal(t_sp, MESHES["dp_sp"])}
    rng = np.random.default_rng(3)
    pp_mask = np.ones((8, 12), np.int32)
    pp_mask[1, :5] = 0
    inputs.update({"ppo_batch": data, "sp_ilql_batch": idata,
                   "prompts": PROMPTS,
                   "pp_blocks": inputs["pp_ppo_params"]["frozen_base"][
                       "blocks"],
                   "pp_h": rng.standard_normal((8, 12, 64)).astype(
                       np.float32),
                   "pp_mask": pp_mask,
                   "refusal_zero_frozen": zero.to_nested_dict(),
                   "refusal_t_sp": t_sp.to_nested_dict()})
    torch.save(inputs, workdir / "inputs.pt")
    ranks = _spawn(workdir, "sp_pp")

    # the pp mesh's checkpoint in one plain process
    back = get_model("JaxPPOTrainer")(
        TRLConfig.from_dict(inputs["pp_ppo_config"]), device="cpu",
        params=inputs["pp_ppo_params"])
    back.load(str(workdir / "ckpt_pp"))
    ref["pp_restored"] = _np(hydra_to_numpy(back.params))
    return {"ranks": ranks, "ref": ref, "inputs": inputs}


@pytest.mark.parametrize("name", list(MESHES))
def test_ppo_step_matches_trlx_tpu(run, name):
    ranks = [r[name] for r in run["ranks"]]
    key = "pp" if "pp" in MESHES[name] else "sp"
    assert all(r[key] for r in ranks)
    # under sp the ring is the attention; Megatron tp compute on sp_tp
    assert all(r["ring"] == (key == "sp") for r in ranks)
    assert all(r["tp"] == (name == "sp_tp") for r in ranks)
    jstats, jtrainable = run["ref"][name]["ppo"]
    _assert_stats(ranks[0]["ppo_stats"], jstats)
    _assert_updates_close(ranks[0]["ppo_trainable"], jtrainable,
                          run["inputs"][key + "_ppo_params"]["trainable"],
                          max_step=_bk_step())
    assert len({r["ppo_digest"] for r in ranks}) == 1


@pytest.mark.parametrize("name", list(MESHES))
def test_ilql_steps_match_trlx_tpu(run, name):
    ranks = [r[name] for r in run["ranks"]]
    key = "pp" if "pp" in MESHES[name] else "sp"
    jsteps, jtrainable = run["ref"][name]["ilql"]
    for ours, theirs in zip(ranks[0]["ilql_steps"], jsteps):
        _assert_stats(ours, theirs)
    _assert_updates_close(ranks[0]["ilql_trainable"], jtrainable,
                          run["inputs"][key + "_ilql_params"]["trainable"],
                          max_step=_bk_step(steps=2))
    assert len({r["ilql_digest"] for r in ranks}) == 1


def test_pp_stage_holds_its_slab_and_checkpoints_whole(run):
    """Each pp stage holds 1 of the 2 frozen layers (wq [1, 32, 64] a
    process: pp 2 over the layers, fsdp 2 over d_model's rows); the
    checkpoint gathers the trunk and restores it into the mesh and into
    one plain process bit for bit."""
    ranks = [r["pp_fsdp"] for r in run["ranks"]]
    assert all(r["pp_slab"] == (1, 32, 64) for r in ranks)
    # shard_blocks_pp + pp_apply_blocks straight on the mesh (the 2
    # frozen layers over 2 stages, 2 microbatches of each process's 4
    # rows) equal the whole trunk
    assert all(r["pp_direct_err"] < 1e-5 for r in ranks)
    for r in ranks:
        assert r["restored_digest"] == r["ppo_digest"]
    _assert_trees_equal(run["ref"]["pp_restored"], ranks[0]["saved"])


def test_ppo_step_with_prompts_longer_than_a_chunk(run):
    ranks = [r["long_prompt"] for r in run["ranks"]]
    jstats, jtrainable = run["ref"]["long_prompt"]
    _assert_stats(ranks[0]["ppo_stats"], jstats)
    _assert_updates_close(ranks[0]["ppo_trainable"], jtrainable,
                          run["inputs"]["sp_ppo_params"]["trainable"],
                          max_step=_bk_step())
    assert len({r["ppo_digest"] for r in ranks}) == 1


def test_pp_four_stages_match_the_whole_trunk(run):
    assert all(r["pp4"]["err"] < 1e-5 for r in run["ranks"])


@pytest.mark.parametrize("name", ["rollout_sp", "rollout_pp",
                                  "rollout_long"])
def test_rollouts_match_one_process(run, name):
    if name == "rollout_long":
        ranks = [r["long_prompt"]["rollout"] for r in run["ranks"]]
    else:
        ranks = [r[name] for r in run["ranks"]]
    assert len({r["digest"] for r in ranks}) == 1
    ours = ranks[0]["store"]
    theirs = run["ref"]["store_" + name.split("_")[1]]
    np.testing.assert_array_equal(ours["response_tensors"],
                                  theirs["response_tensors"])
    for k in ("logprobs", "values", "rewards"):
        np.testing.assert_allclose(ours[k], theirs[k], atol=1e-5, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("case", ["zero_frozen", "t_sp"])
def test_refusals_match_trlx_tpu(run, case):
    want = run["ref"]["refusals"][case]
    assert all(r["refusals"][case] == want for r in run["ranks"])
