"""trlx_tpu_torch.parallel in one process, against trlx_tpu.parallel:

- ``resolve_axis_sizes`` on a table of configs, the errors included;
- ``param_placements`` / ``param_sharding_specs`` leaf for leaf against
  trlx_tpu's ``param_sharding_specs(params, mesh)`` for the hydra, ILQL
  and reward trees of gpt2, gptj, gptneox and llama, on meshes built
  from the 8 virtual CPU devices;
- ``sp`` with ``pp`` refused at construction, ``mesh_from_config``
  None for a world of one, ``broadcast_host_floats`` the identity,
  ``shard_batch``'s divisibility error, ``initialize_runtime``'s
  refusal of more processes than cards;
- the mesh code path on a world of one (a gloo group of this process):
  every leaf a DTensor, the PPO update and greedy rollout equal to the
  plain trainer's, a mesh checkpoint restored into a plain trainer with
  the next update bit-identical, ``aot_jit`` keying a DTensor by its
  placements. The four-process checks are
  tests/test_torch_parallel_dist.py."""

import socket

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from tests.test_torch_ppo import _batch as ppo_data
from tests.test_torch_ppo import _configs as ppo_configs
from trlx_tpu.parallel import build_mesh as jax_build_mesh
from trlx_tpu.parallel import param_sharding_specs as jax_specs
from trlx_tpu.parallel.mesh import resolve_axis_sizes as jax_resolve
from trlx_tpu_torch import parallel
from trlx_tpu_torch.data.configs import ModelSpec, TRLConfig
from trlx_tpu_torch.data.ppo_types import PPORLBatch
from trlx_tpu_torch.models.params import (
    hydra_to_numpy,
    init_hydra_numpy,
    init_ilql_numpy,
)
from trlx_tpu_torch.models.reward import RewardModel
from trlx_tpu_torch.parallel import AXES
from trlx_tpu_torch.parallel.mesh import resolve_axis_sizes
from trlx_tpu_torch.parallel.sharding import is_dtensor
from trlx_tpu_torch.utils.loading import get_model


@pytest.mark.parametrize("config,n", [
    (None, 8), ({}, 1), ({"dp": -1}, 8), ({"dp": -1, "fsdp": 2, "tp": 2}, 8),
    ({"fsdp": 2, "tp": 4}, 8), ({"dp": 2, "tp": -1}, 8), ({"tp": 4}, 4),
    ({"dp": 1, "fsdp": 1, "tp": 1}, 1), ({"dp": -1, "sp": 2}, 4),
    # errors: unknown axis, bad size, two wildcards, no fit, wrong count
    ({"ep": 2}, 8), ({"dp": 0}, 8), ({"dp": -2}, 8), ({"dp": -1, "tp": -1}, 8),
    ({"dp": -1, "tp": 3}, 8), ({"dp": 2, "tp": 2}, 8),
])
def test_resolve_axis_sizes_matches_trlx_tpu(config, n):
    try:
        want = jax_resolve(config, n)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            resolve_axis_sizes(config, n)
        assert str(ours.value) == str(e)
        return
    assert resolve_axis_sizes(config, n) == want
    assert parallel.AXES == ("dp", "pp", "fsdp", "sp", "tp")


def _jax_placements(spec, ndim):
    """trlx_tpu's PartitionSpec as one placement per mesh dim."""
    out = [Replicate() for _ in AXES]
    for d, entry in enumerate(tuple(spec)):
        for ax in (() if entry is None else
                   entry if isinstance(entry, tuple) else (entry,)):
            out[AXES.index(ax)] = Shard(d)
    return out


def _trees(arch):
    extra = {"rotary_dim": 8} if arch in ("gptj", "gptneox") else {}
    if arch == "llama":
        extra = {"n_kv_heads": 2}
    spec = ModelSpec(arch=arch, vocab_size=257, n_layer=3, n_head=4,
                     d_model=64, n_positions=32,
                     tie_lm_head=arch in ("gpt2", "gptneox"), **extra)
    return {"hydra": init_hydra_numpy(spec, 2, seed=0),
            "ilql": init_ilql_numpy(spec, -1, True, seed=0),
            "ilql_partial": init_ilql_numpy(spec, 1, False, seed=0),
            "reward": RewardModel(spec=spec).init(seed=0)}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("mesh_config", [
    {"fsdp": 2, "tp": 2}, {"tp": 4}, {"fsdp": 8}, {"dp": 2, "tp": 4}])
@pytest.mark.parametrize("arch", ["gpt2", "gptj", "gptneox", "llama"])
def test_param_placements_match_trlx_tpu_specs(arch, mesh_config, devices):
    n = int(np.prod(list(mesh_config.values())))
    mesh = jax_build_mesh(mesh_config, devices=devices[:n])
    sizes = resolve_axis_sizes(mesh_config, n)
    for name, tree in _trees(arch).items():
        theirs = _flat(jax_specs(tree, mesh))
        ours = _flat(parallel.param_placements(tree, sizes))
        specs = _flat(parallel.param_sharding_specs(tree, sizes))
        leaves = _flat(tree)
        assert sorted(ours) == sorted(theirs) == sorted(leaves), name
        for path, spec in theirs.items():
            assert tuple(specs[path]) == tuple(spec), (name, path)
            assert ours[path] == _jax_placements(spec, leaves[path].ndim), \
                (name, path)


@pytest.mark.parametrize("trainer", ["JaxPPOTrainer", "JaxILQLTrainer"])
@pytest.mark.parametrize("mesh_config", [{"dp": -1, "sp": 2, "pp": 2},
                                         {"dp": -1, "pp": 2, "sp": 4},
                                         {"fsdp": 2, "tp": 2, "sp": 2,
                                          "pp": 2}])
def test_sp_and_pp_refused_at_construction(trainer, mesh_config):
    """sp and pp together, refused at construction before any process
    group or mesh is built (each alone runs, across processes:
    tests/test_torch_sp_pp_dist.py)."""
    from tests.test_torch_ilql import _config_dict

    if trainer == "JaxPPOTrainer":
        cfg = ppo_configs()[1]
    else:
        cfg = TRLConfig.from_dict(_config_dict())
    cfg.train.mesh = mesh_config
    with pytest.raises(ValueError, match="cannot combine with sp > 1"):
        get_model(trainer)(cfg, device="cpu")


@pytest.mark.parametrize("config", [None, {}, {"dp": -1},
                                    {"dp": -1, "fsdp": 1, "tp": 1},
                                    {"dp": 1, "fsdp": 1, "tp": 1}])
def test_mesh_from_config_is_none_for_a_world_of_one(config):
    cfg = ppo_configs()[1]
    cfg.train.mesh = config
    assert parallel.process_count() == 1
    assert parallel.mesh_from_config(cfg.train, "cpu") is None


def test_more_than_one_device_in_a_world_of_one_raises():
    cfg = ppo_configs()[1]
    cfg.train.mesh = {"dp": 2}
    with pytest.raises(ValueError, match="require 2 devices but 1"):
        get_model("JaxPPOTrainer")(cfg, device="cpu")


def test_broadcast_host_floats_is_the_identity_in_one_process():
    vals = [0.5, -1.25, 3.0]
    out = parallel.broadcast_host_floats(vals)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, np.asarray(vals, np.float32))
    assert parallel.is_main_process() and parallel.process_index() == 0


class _FakeMesh:
    """The axis sizes of a mesh, all shard_batch reads before it places
    anything."""

    def __init__(self, sizes):
        self.sizes = [sizes.get(ax, 1) for ax in AXES]

    def size(self, i):
        return self.sizes[i]


def test_shard_batch_divisibility_error_matches_trlx_tpu(devices):
    from trlx_tpu.parallel import shard_batch as jax_shard_batch

    batch = {"x": np.zeros((6, 3), np.float32)}
    with pytest.raises(ValueError, match=r"not divisible by dp\*fsdp = 4") \
            as theirs:
        jax_shard_batch(jax_build_mesh({"dp": 2, "fsdp": 2},
                                       devices=devices[:4]), batch)
    with pytest.raises(ValueError, match=r"not divisible by dp\*fsdp = 4") \
            as ours:
        parallel.shard_batch(_FakeMesh({"dp": 2, "fsdp": 2}), batch)
    assert str(ours.value).split(" (mesh")[0] == \
        str(theirs.value).split(" (mesh")[0]
    assert str(ours.value).endswith("as a multiple of 4")


def test_initialize_runtime_refuses_more_processes_than_cards(monkeypatch):
    import torch.distributed as dist

    parallel.initialize_runtime()  # one process, no torchrun: a no-op
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="local rank 1 has no card"):
        parallel.initialize_runtime()
    assert not dist.is_initialized()


def test_relayout_for_decode_returns_the_same_tree():
    tree = {"frozen_base": {"blocks": {"attn": {"wq": torch.zeros(2, 4, 4)}}}}
    assert parallel.relayout_for_decode(tree) is tree


@pytest.fixture
def world_of_one():
    """A gloo process group of this process alone, destroyed after."""
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    parallel.initialize_runtime(f"tcp://127.0.0.1:{port}", 1, 0, "cpu")
    yield parallel.build_mesh({"dp": -1, "fsdp": 1, "tp": 1}, "cpu")
    dist.destroy_process_group()


def _leaves(tree):
    out = []
    from trlx_tpu_torch.models.transformer import tree_map

    tree_map(out.append, tree)
    return out


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def test_mesh_of_one_equals_the_plain_path(world_of_one, tmp_path):
    """The mesh code path on a world of one (chip_smoke.py's [mesh] phase
    on the CPU): every leaf a DTensor; greedy rollout tokens, the
    update's stats and the updated parameters equal the plain trainer's;
    a checkpoint of the mesh trainer restored into a plain trainer gives
    a bit-identical next update."""
    from trlx_tpu_torch.utils import aotjit

    mesh = world_of_one
    tcfg = ppo_configs()[1]
    params0 = init_hydra_numpy(tcfg.model.resolve_spec(), 1, seed=0)
    meshed = get_model("JaxPPOTrainer")(tcfg, device="cpu", params=params0,
                                        mesh=mesh)
    plain = get_model("JaxPPOTrainer")(tcfg, device="cpu", params=params0)
    assert plain.mesh is None and meshed.mesh is mesh
    assert all(is_dtensor(x) for x in _leaves(meshed.params))
    assert all(is_dtensor(x) for x in _leaves(meshed.opt_state["mu"]))
    # greedy rollouts: identical tokens
    for tr in (meshed, plain):
        tr.gen_config = tr.gen_config._replace(
            sampling=tr.gen_config.sampling._replace(do_sample=False))
    q = np.random.default_rng(0).integers(0, 256, (4, 4)).astype(np.int32)
    m = np.ones((4, 4), np.int32)
    m[0, :2] = 0
    np.testing.assert_array_equal(meshed.generate(q, m).gen_tokens.numpy(),
                                  plain.generate(q, m).gen_tokens.numpy())
    data = PPORLBatch(**{k: torch.from_numpy(v)
                         for k, v in ppo_data().items()})
    s_mesh, s_plain = meshed.train_step(data), plain.train_step(data)
    for k in s_plain:
        np.testing.assert_allclose(float(s_mesh[k]), float(s_plain[k]),
                                   rtol=1e-5, err_msg=k)
    a, b = _flat(hydra_to_numpy(meshed.params)), \
        _flat(hydra_to_numpy(plain.params))
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7,
                                   err_msg=str(k))
    # mesh checkpoint -> plain trainer: the next update bit-identical
    meshed.save(str(tmp_path / "mesh"))
    back = get_model("JaxPPOTrainer")(tcfg, device="cpu", params=params0)
    back.load(str(tmp_path / "mesh"))
    saved = _np(hydra_to_numpy(meshed.params))
    restored = _flat(_np(hydra_to_numpy(back.params)))
    for k, v in _flat(saved).items():
        np.testing.assert_array_equal(restored[k], v, err_msg=str(k))
    data2 = PPORLBatch(**{k: torch.from_numpy(v)
                          for k, v in ppo_data(1).items()})
    s1, s2 = meshed.train_step(data2), back.train_step(data2)
    for k in s1:
        assert float(s1[k]) == float(s2[k]), k
    a, b = _flat(hydra_to_numpy(meshed.params)), \
        _flat(hydra_to_numpy(back.params))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    # a DTensor's signature holds its placements and mesh
    d = meshed.params["trainable"]["ln_f"]["scale"]
    sig = aotjit._leaf_sig(d)
    assert tuple(map(str, d.placements)) in sig and AXES in sig
    assert aotjit._leaf_sig(d.to_local()) != sig
