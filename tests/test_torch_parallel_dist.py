"""trlx_tpu_torch.parallel across processes: a world of 4 gloo ranks on
the CPU (tests/torch_parallel_worker.py), started once for the module,
held against trlx_tpu on the same mesh sizes (4 of the 8 virtual CPU
devices) and against the port's single-process path, from the same
numpy weights and batches, at float32:

- the PPO step on {fsdp: 2, tp: 2} and on {dp: 4}, and the ILQL steps on
  {fsdp: 2, tp: 2}: loss and pre-clip grad norm at rtol 1e-5, every
  stat at rtol 1e-5 + atol 1e-6, the updated parameters by
  tests/test_golden_step.py's relative-L2 rule (Adam turns a
  near-zero gradient into a +-lr step of either sign); every trainable
  leaf a DTensor, and the trainable parameters bit-identical on every
  rank;
- configs/ppo_gptj.yml at toy widths on {dp: -1, fsdp: 2, tp: 2}:
  make_experience and learn run with finite losses, the parameters stay
  bit-identical across ranks, and rank 1's deliberately different
  rewards are overridden by rank 0's (broadcast_host_floats);
- greedy decode on {dp: 2, tp: 2} gives the single-process tokens (an
  odd batch padded and sliced back), sampled decode gives every rank the
  same tokens (the tp peers draw alike) and the single-process ones;
- the reward model's scores on the mesh equal its single-process ones;
  ppo_tldr's wiring (the reward model from the trainer's trunk, on the
  mesh) trains, saves a step checkpoint and resumes from it on every
  rank; ILQL's learn() through the offline orchestrator, rank 1's
  returns overridden, a partial batch dropped, the eval padded;
- a checkpoint saved on the mesh restores in one plain process with
  every tensor bit-identical, and a plain one into the mesh; the next
  update after either matches the other side's by the same rules;
- the flash seam at T 128 on the mesh (the plain versions on the CPU)
  equals dense attention, gradients included, given the whole heads or
  a process's heads; a PPO step through it on {fsdp: 2, tp: 2} (the
  blocks' Megatron tp compute) equals the single-process one;
- Adafactor's sharded statistics give the single-process update.

Each child writes its log to a file (a verbose failing rank must not
fill a pipe and wedge its peers in a collective) and has its own
timeout."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ppo_e2e import PROMPTS
from tests.test_torch_ilql import _batch as ilql_data
from tests.test_torch_ilql import _config_dict as ilql_config_dict
from tests.test_torch_ppo import _assert_updates_close
from tests.test_torch_ppo import _batch as ppo_data
from tests.test_torch_ppo import _configs as ppo_configs
from trlx_tpu.data.configs import TRLConfig as JaxConfig
from trlx_tpu.data.ilql_types import ILQLBatch as JaxILQLBatch
from trlx_tpu.data.ppo_types import PPORLBatch as JaxPPOBatch
from trlx_tpu.parallel import build_mesh as jax_build_mesh
from trlx_tpu.parallel import shard_batch as jax_shard_batch
from trlx_tpu.parallel import shard_params as jax_shard_params
from trlx_tpu.utils.loading import get_model as jax_get_model
from trlx_tpu_torch.data.configs import ModelSpec, TRLConfig
from trlx_tpu_torch.data.ppo_types import PPORLBatch
from trlx_tpu_torch.models.params import hydra_to_numpy
from trlx_tpu_torch.models.reward import DeviceRewardModel, RewardModel
from trlx_tpu_torch.utils.loading import get_model
from trlx_tpu_torch.utils.tokenizer import load_tokenizer

WORLD = 4
#: each child's own limit, seconds (the module takes about a minute)
CHILD_TIMEOUT = 240
ROOT = Path(__file__).resolve().parent.parent


def _np(tree):
    """numpy copies of a tree's tensors (hydra_to_numpy shares a CPU
    tensor's memory, which later in-place updates would change)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _assert_stats(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(ours[k], float(theirs[k]), rtol=1e-5,
                                   err_msg=k)
    for k in ours:
        np.testing.assert_allclose(ours[k], float(theirs[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def _jax_ppo_step(jcfg, params0, data, mesh_config):
    mesh = jax_build_mesh(mesh_config, devices=jax.devices()[:WORLD])
    jtrainer = jax_get_model("JaxPPOTrainer")(jcfg, mesh=mesh)
    jparams = jax_shard_params(mesh, jax.tree_util.tree_map(jnp.asarray,
                                                            params0))
    batch = jax_shard_batch(mesh, JaxPPOBatch(**{
        k: jnp.asarray(v) for k, v in data.items()}))
    jp, _, stats = jtrainer._train_step(jparams, jtrainer.opt_state, batch)
    return jax.device_get(stats), jax.device_get(jp["trainable"])


def _jax_ilql_steps(cfg, params0, data):
    mesh = jax_build_mesh({"fsdp": 2, "tp": 2},
                          devices=jax.devices()[:WORLD])
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


def _gptj_config():
    """configs/ppo_gptj.yml with toy widths, as tests/test_parallel.py
    cuts it, on {dp: -1, fsdp: 2, tp: 2}."""
    config = TRLConfig.load_yaml(str(ROOT / "configs" / "ppo_gptj.yml"))
    config.model.model_spec = {
        "arch": "gptj", "vocab_size": 257, "n_layer": 2, "n_head": 4,
        "d_model": 64, "n_positions": 64, "rotary_dim": 16,
        "tie_lm_head": False,
    }
    config.model.tokenizer_path = "byte"
    config.model.compute_dtype = "float32"
    config.train.mesh = {"dp": -1, "fsdp": 2, "tp": 2}
    config.train.total_steps = 2
    config.train.epochs = 1
    config.train.batch_size = 8
    config.train.input_size = 4
    config.train.gen_size = 8
    config.train.log_interval = 1
    config.train.eval_interval = 10**9
    config.train.checkpoint_interval = 10**9
    config.method.num_rollouts = 8
    config.method.chunk_size = 8
    config.method.ppo_epochs = 1
    return config.to_nested_dict()


def _spawn(workdir: Path, scenarios: str = "mesh"):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH", "")) if p)
    logs = [workdir / f"rank{r}.log" for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_parallel_worker.py"),
         f"tcp://127.0.0.1:{port}", str(r), str(WORLD), str(workdir),
         scenarios],
        cwd=workdir, env=env, stdout=open(log, "w"),
        stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    for p in procs:
        try:
            p.wait(timeout=CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        text = log.read_text()
        assert p.returncode == 0 and f"WORKER OK {r}" in text, (
            f"rank {r} failed (rc={p.returncode}):\n{text[-6000:]}")
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The references in this process, then the 4-rank world:
    {"ranks": per-rank results, "ref": the references, "inputs": ...}."""
    workdir = tmp_path_factory.mktemp("torch_parallel_dist")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _run(workdir)
    finally:
        torch.set_num_threads(threads)


def _run(workdir: Path):
    ref = {}
    jcfg, tcfg = ppo_configs()
    params0 = jax.device_get(jax_get_model("JaxPPOTrainer")(jcfg).params)
    data, data2 = ppo_data(0), ppo_data(1)
    for name, mesh_config in (("ppo_fsdp_tp", {"fsdp": 2, "tp": 2}),
                              ("ppo_dp", {"dp": 4})):
        ref[name + "_jax"] = _jax_ppo_step(jcfg, params0, data, mesh_config)
    # the port in one process through the flash seam (plain versions)
    from trlx_tpu_torch.ops import flash_attention as tfa

    fcfg = ppo_configs(fused=True)[1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfa, "_MIN_FUSED_T", 0)
        fused = get_model("JaxPPOTrainer")(fcfg, device="cpu",
                                           params=params0)
        ref["ppo_fused"] = ({k: float(v) for k, v in fused.train_step(
            PPORLBatch(**{k: torch.from_numpy(v)
                          for k, v in data.items()})).items()},
            _np(hydra_to_numpy(fused.params["trainable"])))
    # the port in one process: a step, its checkpoint, the next step
    plain = get_model("JaxPPOTrainer")(tcfg, device="cpu", params=params0)
    ref["ppo_plain"] = ({k: float(v) for k, v in plain.train_step(
        PPORLBatch(**{k: torch.from_numpy(v)
                      for k, v in data.items()})).items()},
        _np(hydra_to_numpy(plain.params["trainable"])))
    plain_ckpt = workdir / "ckpt_plain"
    plain.save(str(plain_ckpt))
    ref["plain_saved"] = _np(hydra_to_numpy(plain.params))
    ref["plain_next"] = ({k: float(v) for k, v in plain.train_step(
        PPORLBatch(**{k: torch.from_numpy(v)
                      for k, v in data2.items()})).items()},
        _np(hydra_to_numpy(plain.params["trainable"])))

    icfg = ilql_config_dict()
    iparams0 = jax.device_get(jax_get_model("JaxILQLTrainer")(
        JaxConfig.from_dict(icfg)).params)
    idata = ilql_data()
    ref["ilql_jax"] = _jax_ilql_steps(icfg, iparams0, idata)

    rng = np.random.default_rng(7)
    gen = {}
    for name, n in (("greedy", 5), ("sampled", 6)):
        q = rng.integers(0, 256, (n, 4)).astype(np.int32)
        m = np.ones((n, 4), np.int32)
        m[1, :2] = 0
        gen[name] = (q, m)
        tr = get_model("JaxPPOTrainer")(tcfg, device="cpu", params=params0)
        tr.gen_config = tr.gen_config._replace(
            sampling=tr.gen_config.sampling._replace(do_sample=name
                                                     == "sampled"))
        tr.generator.manual_seed(11)
        ref["gen_" + name] = tr.generate(q, m).gen_tokens.numpy()

    rm_spec = ModelSpec(vocab_size=257, n_layer=2, n_head=4, d_model=32,
                        n_positions=32)
    rm_model = RewardModel(spec=rm_spec, compute_dtype=torch.float32)
    rm_params = rm_model.init(seed=3)
    rm_tokens = rng.integers(0, 257, (5, 12)).astype(np.int32)
    rm_mask = np.ones((5, 12), np.int32)
    rm_mask[2, :5] = 0
    rm_mask[3, 9:] = 0
    ref["reward"] = DeviceRewardModel(
        rm_model, rm_params, load_tokenizer("byte"), device="cpu",
    ).score_tokens(torch.from_numpy(rm_tokens),
                   torch.from_numpy(rm_mask)).numpy()

    B, T, H, hd = 4, 128, 4, 16
    attn = {n: rng.standard_normal((B, T, H, hd)).astype(np.float32)
            for n in ("q", "k", "v", "w")}
    attn["mask"] = np.ones((B, T), np.int32)
    attn["mask"][1, :40] = 0
    attn["mask"][3, :7] = 0

    ada = {"params": {"wq": rng.standard_normal((2, 256, 128)),
                      "w_out": rng.standard_normal((2, 128, 256)),
                      "b_in": rng.standard_normal((2, 128)),
                      "wte": rng.standard_normal((130, 64))},
           "grads": []}
    ada["params"] = {k: (0.1 * v).astype(np.float32)
                     for k, v in ada["params"].items()}
    for _ in range(2):
        ada["grads"].append({k: (0.01 * rng.standard_normal(v.shape))
                             .astype(np.float32)
                             for k, v in ada["params"].items()})
    ref["adafactor"] = _plain_adafactor(ada)

    torch.save({
        "ppo_config": tcfg.to_nested_dict(), "ppo_params": params0,
        "ppo_fused_config": fcfg.to_nested_dict(),
        "ppo_batch": data, "ppo_batch2": data2,
        "plain_ckpt": str(plain_ckpt),
        "ilql_config": icfg, "ilql_params": iparams0, "ilql_batch": idata,
        "gptj_config": _gptj_config(), "prompts": PROMPTS,
        "ilql_rows": [rng.integers(0, 256, n).tolist()
                      for n in rng.integers(5, 15, 10)],
        "ilql_prompts": [[1, 2], [3], [4, 5, 6]],
        "gen_greedy": gen["greedy"], "gen_sampled": gen["sampled"],
        "gen_seed": 11,
        "rm_spec": rm_spec, "rm_params": rm_params, "rm_tokens": rm_tokens,
        "rm_mask": rm_mask, "attn": attn, "adafactor": ada,
    }, workdir / "inputs.pt")
    ranks = _spawn(workdir)

    # the mesh's checkpoint in one plain process, and its next update
    back = get_model("JaxPPOTrainer")(tcfg, device="cpu", params=params0)
    back.load(str(workdir / "ckpt_mesh"))
    ref["mesh_restored"] = _np(hydra_to_numpy(back.params))
    ref["mesh_restored_next"] = ({k: float(v) for k, v in back.train_step(
        PPORLBatch(**{k: torch.from_numpy(v)
                      for k, v in data2.items()})).items()},
        _np(hydra_to_numpy(back.params["trainable"])))
    return {"ranks": ranks, "ref": ref, "params0": params0,
            "iparams0": iparams0}


def _plain_adafactor(ada):
    from trlx_tpu_torch.trainers import Adafactor
    from trlx_tpu_torch.utils import cosine_schedule

    keys = sorted(ada["params"])
    leaves = [torch.from_numpy(ada["params"][k].copy()) for k in keys]
    opt = Adafactor(cosine_schedule(1e-2, 10), 1.0, 1e-4)
    state = opt.init(leaves)
    for grads in ada["grads"]:
        opt.step(leaves, [torch.from_numpy(grads[k]) for k in keys], state)
    return [p.numpy() for p in leaves]


def _bk_step(lr=3e-3, steps=1):
    return 1.01 * lr * steps


@pytest.mark.parametrize("name", ["ppo_fsdp_tp", "ppo_dp"])
def test_ppo_step_on_mesh_matches_jax_and_one_process(run, name):
    ref, ranks = run["ref"], run["ranks"]
    jstats, jtrainable = ref[name + "_jax"]
    pstats, ptrainable = ref["ppo_plain"]
    ours = ranks[0][name]
    assert all(r[name]["dtensors"] for r in ranks)
    # Megatron compute over tp where the mesh has it
    assert all(r[name]["tp"] == (name == "ppo_fsdp_tp") for r in ranks)
    _assert_stats(ours["stats"], jstats)
    _assert_stats(ours["stats"], pstats)
    start = run["params0"]["trainable"]
    _assert_updates_close(ours["trainable"], jtrainable, start,
                          max_step=_bk_step())
    _assert_updates_close(ours["trainable"], ptrainable, start,
                          max_step=_bk_step())
    assert len({r[name]["digest"] for r in ranks}) == 1


def test_ppo_step_through_the_flash_seam_on_tp(run):
    """The fused forward on {fsdp: 2, tp: 2}: the seam gets each
    process's heads from the tp-sharded blocks; the step equals the
    port's single-process fused step."""
    pstats, ptrainable = run["ref"]["ppo_fused"]
    ranks = [r["ppo_fused"] for r in run["ranks"]]
    assert all(r["tp"] and r["fused"] for r in ranks)
    _assert_stats(ranks[0]["stats"], pstats)
    _assert_updates_close(ranks[0]["trainable"], ptrainable,
                          run["params0"]["trainable"], max_step=_bk_step())


def test_ilql_steps_on_mesh_match_jax(run):
    jsteps, jtrainable = run["ref"]["ilql_jax"]
    ranks = run["ranks"]
    ours = ranks[0]["ilql"]
    assert all(r["ilql"]["dtensors"] and r["ilql"]["tp"] for r in ranks)
    for step, (o, j) in enumerate(zip(ours["steps"], jsteps)):
        _assert_stats(o, j)
    _assert_updates_close(ours["trainable"], jtrainable,
                          run["iparams0"]["trainable"],
                          max_step=_bk_step(steps=2))
    # alpha 1: the Polyak sync made the sharded targets the Q heads
    for name in ours["target"]:
        _assert_trees_equal(ours["target"][name], ours["trainable"][name])
    assert len({r["ilql"]["digest"] for r in ranks}) == 1


def test_ppo_gptj_config_trains_on_mesh(run):
    ranks = [r["gptj"] for r in run["ranks"]]
    assert ranks[0]["mesh"] == {"dp": 1, "pp": 1, "fsdp": 2, "sp": 1,
                                "tp": 2}
    assert ranks[0]["losses"] and np.all(np.isfinite(ranks[0]["losses"]))
    assert ranks[0]["iter"] >= 1
    assert len({r["iter"] for r in ranks}) == 1
    # the main process alone logs
    assert all(not r["losses"] for r in ranks[1:])
    assert len({r["digest"] for r in ranks}) == 1
    # rank 1 scored +100: process 0's rewards were used everywhere
    scores = [r["mean_score"] for r in ranks]
    assert scores[0] < 100 and len(set(scores)) == 1


def test_ppo_with_device_reward_saves_and_resumes_on_mesh(run):
    """ppo_tldr's wiring on {dp: 2, tp: 2}: the reward model lives on the
    mesh and scores alike everywhere; learn() writes step_2 and a fresh
    mesh trainer resumes from it bit for bit, on every rank."""
    ranks = [r["ppo_resume"] for r in run["ranks"]]
    assert all(r["rm_dtensors"] for r in ranks)
    assert [e for e in ranks[0]["steps"] if e.startswith("step_")] == \
        ["step_2"]
    assert all(r["iter"] == r["resumed_iter"] == 2 for r in ranks)
    for key in ("mean_score", "store", "digest", "opt_digest"):
        assert len({r[key] for r in ranks}) == 1, key
    for r in ranks:
        assert r["resumed_digest"] == r["digest"]
        assert r["resumed_opt_digest"] == r["opt_digest"]
    assert np.isfinite(ranks[0]["mean_score"])


def test_ilql_learn_on_mesh(run):
    """ILQL's learn() on {fsdp: 2, tp: 2}: 10 rows in batches of 4 (the
    partial third dropped on a mesh), rank 1's reordered returns
    overridden by rank 0's, the parameters identical on every rank, the
    eval's 3 prompts padded to 4 and sliced back."""
    ranks = [r["ilql_learn"] for r in run["ranks"]]
    assert all(r["iter"] == 2 for r in ranks)
    for key in ("rewards", "digest"):
        assert len({r[key] for r in ranks}) == 1, key
    # the main process alone logs the eval
    assert np.isfinite(ranks[0]["eval"])
    assert all(r["eval"] is None for r in ranks[1:])


def test_generation_on_tp_matches_one_process(run):
    ref, ranks = run["ref"], [r["generation"] for r in run["ranks"]]
    for r in ranks:
        np.testing.assert_array_equal(r["greedy"], ref["gen_greedy"])
        # every rank's rows come from its own tp group's draws: the tp
        # peers drew alike, and as one process draws
        np.testing.assert_array_equal(r["sampled"], ranks[0]["sampled"])
        np.testing.assert_array_equal(r["sampled_logprobs"],
                                      ranks[0]["sampled_logprobs"])
    np.testing.assert_array_equal(ranks[0]["sampled"], ref["gen_sampled"])


def test_reward_model_on_mesh_matches_one_process(run):
    for r in run["ranks"]:
        assert r["reward"]["dtensors"]
        np.testing.assert_allclose(r["reward"]["scores"], run["ref"]["reward"],
                                   rtol=1e-5, atol=1e-6)


def test_checkpoint_mesh_to_one_process(run):
    """Saved on the mesh of 4, restored in one plain process: every tensor
    bit-identical; the next update matches the mesh's own."""
    ref, ours = run["ref"], run["ranks"][0]["ppo_fsdp_tp"]
    _assert_trees_equal(ref["mesh_restored"], ours["saved"])
    rstats, rtrainable = ref["mesh_restored_next"]
    _assert_stats(ours["next_stats"], rstats)
    _assert_updates_close(ours["next_trainable"], rtrainable,
                          ours["saved"]["trainable"], max_step=_bk_step())


def test_checkpoint_one_process_to_mesh(run):
    """Saved by one plain process, restored on the mesh of 4: every
    tensor bit-identical (on every rank), the state carried; the next
    update matches the plain process's own."""
    ref, ranks = run["ref"], [r["ppo_fsdp_tp"] for r in run["ranks"]]
    ours = ranks[0]
    assert all(r["restored_dtensors"] for r in ranks)
    _assert_trees_equal(ours["restored"], ref["plain_saved"])
    assert len({r["restored_digest"] for r in ranks}) == 1
    assert ours["restored_iter"] == 0
    pstats, ptrainable = ref["plain_next"]
    _assert_stats(ours["restored_stats"], pstats)
    _assert_updates_close(ours["restored_next"], ptrainable,
                          ref["plain_saved"]["trainable"],
                          max_step=_bk_step())


def test_flash_seam_on_mesh_matches_dense(run):
    for r in run["ranks"]:
        f = r["flash"]
        assert f["global_err"] < 1e-5 and f["rows_err"] < 1e-5
        assert f["dense_err"] < 1e-5 and f["grad_err"] < 1e-5
        assert f["tp_heads_err"] < 1e-5 and f["tp_heads_grad_err"] < 1e-5


def test_adafactor_on_mesh_matches_one_process(run):
    for ours, theirs in zip(run["ranks"][0]["adafactor"]["leaves"],
                            run["ref"]["adafactor"]):
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-7)
