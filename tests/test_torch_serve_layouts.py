"""The port's serve-mesh placements and surface against trlx_tpu's
(trlx_tpu_torch.serve.layouts vs trlx_tpu.serve.layouts), on the 8
virtual CPU devices — no serve step is compiled, so these take seconds:

- ``decode_spec_for_leaf`` and the fitted placement of every decode-view
  leaf (gpt2-like and gpt-j-like tiny specs, int8 views, {tp: 2},
  {tp: 4}, {tp: 2, fsdp: 2}, ``weights`` fsdp and replicated);
- the KV pool placements (paged, contiguous, int8 codes and scales);
- ``build_serve_mesh``'s refusals, ``parse_mesh``'s messages, the
  ``mesh_weights`` check and ``mesh_info``;
- the mesh code path in a world of ONE gloo process: the slot engine
  on ``serve.mesh {tp: 1}`` decodes bit-identically to the plain one,
  with 0 recompiles.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_serve import tiny_config_dict
from trlx_tpu.data.configs import TRLConfig as JaxConfig
from trlx_tpu.parallel.sharding import _fit_spec_to_shape as jax_fit
from trlx_tpu.parallel.sharding import _path_names as jax_path_names
from trlx_tpu.serve import InferenceEngine as JaxEngine
from trlx_tpu.serve import ServeConfig as JaxServe
from trlx_tpu.serve import layouts as jl
from trlx_tpu.serve.__main__ import parse_mesh as jax_parse_mesh
from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.configs import ModelSpec, TRLConfig
from trlx_tpu_torch.models.generation import init_page_pool, init_slot_pool
from trlx_tpu_torch.models.params import init_decode_views
from trlx_tpu_torch.parallel.mesh import AXES
from trlx_tpu_torch.serve import InferenceEngine, ServeConfig, SlotScheduler
from trlx_tpu_torch.serve import layouts as tl
from trlx_tpu_torch.serve.__main__ import build_parser, parse_mesh
from trlx_tpu_torch.serve.__main__ import serve_config_from_args
from trlx_tpu_torch.serve.engine import quantize_serve_weights

GPT2 = ModelSpec(vocab_size=257, n_layer=2, n_head=4, d_model=64,
                 n_positions=32)
GPTJ = ModelSpec(vocab_size=256, n_layer=3, n_head=4, d_model=64,
                 n_positions=32, arch="gptj", rotary_dim=8,
                 tie_lm_head=False)
MESHES = [{"tp": 2}, {"tp": 4}, {"tp": 2, "fsdp": 2}]


def _sizes(mesh_config):
    return {ax: int(mesh_config.get(ax, 1)) for ax in AXES}


def _padded(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _trimmed(spec):
    """A spec without its trailing Nones (replicated dims), the form both
    packages' specs compare in."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _shapes(tree):
    """A torch tree as jax.ShapeDtypeStructs of the same structure."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_shapes(v) for v in tree)
    return jax.ShapeDtypeStruct(tuple(tree.shape), np.float32)


def _views(spec, int8):
    views = init_decode_views(spec, seed=0, num_layers_unfrozen=1)
    blocks = views.blocks
    if int8:
        blocks = quantize_serve_weights(blocks)
    return (tuple(blocks), views.embed, views.ln_f)


def _port_specs(views, mesh_config, weights):
    """{key path: fitted spec} of the port's decode views."""
    flat = {}

    def walk(x, path):
        if isinstance(x, tl.P):
            flat[path] = _trimmed(x)
        elif isinstance(x, dict):
            for k in x:
                walk(x[k], path + (str(k),))
        else:
            for i, v in enumerate(x):
                walk(v, path + (str(i),))

    walk(tl.decode_specs(views, _sizes(mesh_config), weights), ())
    return flat


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("spec", [GPT2, GPTJ], ids=["gpt2", "gptj"])
@pytest.mark.parametrize("mesh_config", MESHES, ids=str)
@pytest.mark.parametrize("weights", ["fsdp", "replicated"])
def test_decode_view_placements_equal_trlx_tpu(spec, mesh_config, weights,
                                               int8):
    """Every decode-view leaf: the port's fitted spec is trlx_tpu's rule
    (``decode_spec_for_leaf`` with the weights knob) fitted on its mesh;
    at ``weights: fsdp`` that is ``decode_param_shardings`` itself."""
    views = _views(spec, int8)
    template = _shapes(views)
    mesh = jl.build_serve_mesh(mesh_config)
    theirs = {}

    def leaf(kp, x):
        names = jax_path_names(kp)
        rule = jl.decode_spec_for_leaf(names, x.ndim, weights)
        assert tuple(tl.decode_spec_for_leaf(names, x.ndim, weights)) \
            == tuple(rule), names
        theirs[names] = _trimmed(jax_fit(rule, x.shape, mesh))

    jax.tree_util.tree_map_with_path(leaf, template)
    assert _port_specs(views, mesh_config, weights) == theirs
    if weights == "fsdp":
        placed = {}
        jax.tree_util.tree_map_with_path(
            lambda kp, s, x: placed.__setitem__(
                jax_path_names(kp), _trimmed(s.spec)),
            jl.decode_param_shardings(mesh, template), template)
        assert placed == theirs


@pytest.mark.parametrize("layout", ["paged", "contiguous", "int8"])
@pytest.mark.parametrize("spec", [GPT2, GPTJ], ids=["gpt2", "gptj"])
@pytest.mark.parametrize("mesh_config", MESHES, ids=str)
def test_kv_pool_placements_equal_trlx_tpu(spec, mesh_config, layout):
    """Heads (axis 3) over tp for K/V and the int8 scale planes; the port's
    pool carries a drop page (or row and position), the same axis 3."""
    if layout == "contiguous":
        pool = init_slot_pool(spec, [1, 1], 4, 16, device="meta")
    else:
        pool = init_page_pool(spec, [1, 1], 8, 4, torch.int8
                              if layout == "int8" else torch.bfloat16,
                              device="meta")
    mesh = jl.build_serve_mesh(mesh_config)
    template = _shapes(pool)
    theirs = [_padded(s.spec, x.ndim) for s, x in zip(
        jax.tree_util.tree_leaves(jl.kv_pool_shardings(mesh, template)),
        jax.tree_util.tree_leaves(template))]
    ours = [_padded(tl.kv_pool_spec(x.shape, _sizes(mesh_config)), x.ndim)
            for x in jax.tree_util.tree_leaves(template)]
    assert ours == theirs


def _message(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


@pytest.mark.parametrize("mesh_config", [
    {"dp": 2}, {"tp": 2, "sp": 2}, {"tp": 0}, {"fsdp": -1}, {"tp": 16},
])
def test_build_serve_mesh_refusals_equal_trlx_tpu(monkeypatch, mesh_config):
    """Unknown axes, sizes below 1 and a mesh larger than what is there
    (8 devices on both sides) give trlx_tpu's messages."""
    monkeypatch.setattr(tl, "_world_size", lambda: 8)
    assert _message(tl.build_serve_mesh, mesh_config) \
        == _message(jl.build_serve_mesh, mesh_config)


def test_serve_mesh_is_the_world():
    """A mesh smaller than the world of processes is refused (the port's
    own message: the serve mesh spans every process); no mesh is None."""
    assert tl.build_serve_mesh(None) is None
    assert tl.build_serve_mesh({}) is None
    with pytest.raises(ValueError, match="needs 2 devices but only 1"):
        tl.build_serve_mesh({"tp": 2})


def test_parse_mesh_and_cli_flags_equal_trlx_tpu():
    for spec in ("tp=2,fsdp=2", "tp=4", "", " fsdp = 2 , "):
        assert parse_mesh(spec) == jax_parse_mesh(spec)
    for bad in ("tp", "tp:2"):
        assert _message(parse_mesh, bad) == _message(jax_parse_mesh, bad)
    with pytest.raises(ValueError):
        parse_mesh("tp=x")
    args = build_parser().parse_args(
        ["--config", "x.json", "--mesh", "tp=2,fsdp=2",
         "--mesh-weights", "replicated"])
    cfg = serve_config_from_args(args, {"serve": {"mesh": {"tp": 4}}})
    assert cfg.mesh == {"tp": 2, "fsdp": 2}
    assert cfg.mesh_weights == "replicated"
    args = build_parser().parse_args(["--config", "x.json", "--mesh", ""])
    assert serve_config_from_args(
        args, {"serve": {"mesh": {"tp": 4}}}).mesh is None


class _StubMesh:
    """What ``mesh_info`` reads of a DeviceMesh: each axis' size."""

    def __init__(self, mesh_config):
        self._sizes = _sizes(mesh_config)

    def size(self, i):
        return self._sizes[AXES[i]]


@pytest.mark.parametrize("mesh_config", [{}] + MESHES, ids=str)
@pytest.mark.parametrize("weights", ["fsdp", "replicated"])
def test_mesh_info_equal_trlx_tpu(mesh_config, weights):
    mesh = _StubMesh(mesh_config) if mesh_config else None
    assert tl.mesh_info(mesh, weights) == jl.mesh_info(
        jl.build_serve_mesh(mesh_config or None), weights)


def test_serve_config_accepts_the_mesh_and_checks_its_weights():
    cfg = ServeConfig.from_dict({"mesh": {"tp": 2}, "mesh_weights": "fsdp"})
    assert cfg.mesh == {"tp": 2} and cfg.mesh_weights == "fsdp"
    assert dataclasses.asdict(ServeConfig())["mesh"] is None
    bad = {"buckets": [[2, 8, 8]], "mesh_weights": "sharded"}
    with pytest.raises(ValueError) as theirs:
        JaxEngine(JaxConfig.from_dict(tiny_config_dict()),
                  serve=JaxServe(**bad), init=False)
    with pytest.raises(ValueError) as ours:
        InferenceEngine(TRLConfig.from_dict(tiny_config_dict()),
                        serve=ServeConfig(**bad), device="cpu")
    assert str(ours.value) == str(theirs.value)


ROWS = [[11, 22, 33, 44, 1, 2, 3], [11, 22, 33, 44, 4, 5], [2, 4, 6],
        [11, 22, 33, 44, 6, 7, 8, 9], [11, 22, 33, 44, 1, 3]]


def _served(mesh, **serve):
    telemetry.start()
    engine = InferenceEngine(
        TRLConfig.from_dict(tiny_config_dict()), serve=ServeConfig(
            buckets=[[2, 8, 8], [4, 8, 8]], slots=4, page_size=4,
            mesh=mesh, **serve), device="cpu")
    s = SlotScheduler(engine)
    s.warmup()
    s.start()
    try:
        reqs = [s.submit(list(r), max_new_tokens=4) for r in ROWS]
        got = [r.wait(timeout=60.0).result for r in reqs]
        return (got, s.runtime.digest.hexdigest(), engine.mesh_info(),
                telemetry.current().registry.counters.get(
                    "compile/recompiles", 0.0))
    finally:
        s.stop()
        telemetry.start()


@pytest.mark.parametrize("serve", [{}, {"attention": "pallas"},
                                   {"kv_dtype": "int8",
                                    "weights_dtype": "int8"}], ids=str)
def test_world_of_one_mesh_decodes_as_the_plain_engine(serve):
    """``serve.mesh {tp: 1}`` in a world of one gloo process: the mesh
    code path (its collectives over a group of one) emits the plain
    engine's tokens bit for bit, 0 recompiles, and reports one device."""
    plain = _served(None, **serve)
    meshed = _served({"tp": 1}, **serve)
    assert meshed[0] == plain[0] and meshed[1] == plain[1]
    assert meshed[3] == 0.0
    assert meshed[2]["devices"] == 1 and meshed[2]["axes"] == {"tp": 1}
