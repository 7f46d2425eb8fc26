"""The port's tp serve mesh across processes: gloo worlds of 2 and 4
ranks on the CPU (tests/torch_serve_mesh_worker.py), started once for the
module, held against trlx_tpu's single-device engine from the same numpy
weights at float32 — the oracle of tests/test_serve_mesh.py:

- greedy tokens of the {tp: 2} engine at page sizes 3, 8 and 16 with
  staggered admission and a shared prefix; of {tp: 2, fsdp: 2} (fsdp
  weights, gathered on use), {tp: 2} with replicated weights and {tp: 4};
  of a vocabulary that tp splits (256: the masked embedding lookup and
  the logits' gather); through the paged-decode seam (its plain version
  on the CPU), under lookup and draft speculation; at int8 weights and
  KV, and at grouped-query heads tp 4 does not divide (whole-width
  attention), against the port's single-process engine;
- replay after a poisoned step, and a hot-swap under load through
  ``POST /admin/reload`` (each follower restores its own slices);
- ``scheduler: static`` on {tp: 2}, {tp: 2, fsdp: 2} and {tp: 4}: the
  micro-batcher's greedy tokens equal trlx_tpu's single-device static
  engine's (its per-bucket ``decode``); a poisoned flush fails its
  requests before any follower enters that ``generate``, and the rows
  sent again decode right; a hot-swap by ``request_swap`` and one by
  ``POST /admin/reload``, each follower restoring its own slices;
- the streaming reload restores the decode subset only, each rank its
  slices; the /healthz, /debug/state and /metrics mesh surface;
- every scenario: 0 recompiles on every rank, no leaked pages (slots),
  the ranks' token digests equal, every follower's loop returning 0
  after the stop.

Each child writes its log to a file (a failing rank must not fill a
pipe and wedge its peers in a collective) and has its own timeout."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from test_paged import build_engine as jax_paged_engine
from test_serve import tiny_config_dict
from test_slots import direct_generate
from trlx_tpu.data.configs import TRLConfig as JaxConfig
from trlx_tpu.serve import InferenceEngine as JaxEngine
from trlx_tpu.serve import ServeConfig as JaxServe
from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.params import init_hydra_numpy
from trlx_tpu_torch.models.transformer import tree_map
from trlx_tpu_torch.serve import InferenceEngine, ServeConfig, SlotScheduler
from trlx_tpu_torch.utils.checkpoint import save_step_checkpoint

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT = 600
BUCKETS = [[2, 8, 8], [4, 8, 8]]
MAX_NEW = 4
PREFIX = [11, 22, 33, 44]
ROWS = [PREFIX + [1, 2, 3], PREFIX + [4, 5], PREFIX + [6, 7, 8, 9],
        [2, 4, 6], PREFIX + [1, 3], PREFIX + [9, 8, 7]]
REPLAY_ROWS = [[11, 22, 1], [11, 22, 4, 5], [6, 7], [11, 22, 9], [2, 4, 6],
               [11, 22, 3, 1]]


def _jax_tokens(tree, rows, config=None):
    """trlx_tpu's one-shot generate on a single-device engine holding
    ``tree``: the oracle of every mesh (greedy decode is Markov on the
    token prefix, so it is the same for every page size and mesh)."""
    engine = jax_paged_engine(buckets=BUCKETS) if config is None else \
        JaxEngine(JaxConfig.from_dict(config), serve=JaxServe(
            buckets=BUCKETS, slots=4, page_size=4))
    engine._install_params(tree)
    out = []
    for i in range(0, len(rows), 2):
        pair = rows[i:i + 2]
        gen = direct_generate(engine, pair, (2, 8, 8), gen_size=MAX_NEW)
        out += [engine.depad_row(gen, j, MAX_NEW) for j in range(len(pair))]
    return out


def _jax_static_tokens(tree, batches, config=None):
    """trlx_tpu's single-device static engine holding ``tree``: each
    batch of rows through ``decode`` on the smallest bucket that holds it
    (a one-row batch repeats its row, as the micro-batcher pads), cut to
    MAX_NEW tokens a row."""
    engine = JaxEngine(JaxConfig.from_dict(config or tiny_config_dict()),
                       serve=JaxServe(buckets=BUCKETS, scheduler="static"),
                       params=tree)
    out = []
    for rows in batches:
        bucket = next(tuple(b) for b in BUCKETS if b[0] >= len(rows))
        gen = engine.decode(bucket, *engine.pad_batch(rows, bucket), seed=0)
        out += [engine.depad_row(gen, j, MAX_NEW) for j in range(len(rows))]
    return out


def _jax_tree(config):
    engine = JaxEngine(JaxConfig.from_dict(config), serve=JaxServe(
        buckets=BUCKETS, slots=4, page_size=4), init=False)
    return jax.device_get(engine._init_params())


def _port_tokens(tree, config=None, **serve):
    """The port's single-process engine (held to trlx_tpu's by the
    single-device serve tests: tests/test_torch_int8_serve.py for the
    int8 tiers, tests/test_torch_transformer.py for llama's grouped-query
    heads)."""
    telemetry.start()
    engine = InferenceEngine(
        TRLConfig.from_dict(config or tiny_config_dict()), serve=ServeConfig(
            buckets=BUCKETS, max_queue=64, slots=4, page_size=4,
            attention="pallas", **serve),
        params=tree, device="cpu")
    s = SlotScheduler(engine)
    s.warmup()
    s.start()
    try:
        from torch_serve_mesh_worker import run_staggered

        return run_staggered(s, ROWS)
    finally:
        s.stop()


def _spawn(workdir: Path, world: int):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH", "")) if p)
    logs = [workdir / f"w{world}_rank{r}.log" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_serve_mesh_worker.py"),
         f"tcp://127.0.0.1:{port}", str(r), str(world), str(workdir)],
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
            f"rank {r} of {world} failed (rc={p.returncode}):\n"
            f"{text[-6000:]}")
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The oracles in this process, then the worlds of 2 and 4 ranks:
    {"want": oracle tokens, 2: per-rank results, 4: per-rank results}."""
    workdir = tmp_path_factory.mktemp("torch_serve_mesh_dist")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        config = tiny_config_dict()
        spec = TRLConfig.from_dict(config).model.resolve_spec()
        tree1 = _jax_tree(config)
        tree2 = init_hydra_numpy(spec, 1, seed=1)
        config256 = tiny_config_dict()
        config256["model"]["model_spec"]["vocab_size"] = 256
        tree256 = _jax_tree(config256)
        # grouped-query heads (llama, 4 query heads over 2 KV heads): tp 4
        # divides neither, so the attention runs whole width on each rank
        config_gqa = tiny_config_dict()
        config_gqa["model"]["model_spec"].update(arch="llama", n_kv_heads=2)
        tree_gqa = init_hydra_numpy(
            TRLConfig.from_dict(config_gqa).model.resolve_spec(), 1, seed=2)
        run_dir = str(workdir / "run")
        for step, tree in ((1, tree1), (2, tree2)):
            save_step_checkpoint({"params": tree_map(torch.tensor, tree),
                                  "config": config}, run_dir, step)
        want = {
            "rows": _jax_tokens(tree1, ROWS),
            "replay": _jax_tokens(tree1, REPLAY_ROWS),
            "step2": _jax_tokens(tree2, ROWS[:2]),
            "vocab256": _jax_tokens(tree256, ROWS, config256),
            "int8": _port_tokens(tree1, weights_dtype="int8",
                                 kv_dtype="int8"),
            "gqa": _port_tokens(tree_gqa, config_gqa),
            # the micro-batcher's flushes: rows 0-3, then rows 4-5
            "static_rows": _jax_static_tokens(tree1, [ROWS[:4], ROWS[4:]]),
            "static_pair": _jax_static_tokens(tree1, [ROWS[:2]]),
            "static_step2": _jax_static_tokens(tree2, [ROWS[:2]]),
            # one /generate at a time: each row alone in a batch-2 bucket
            "static_single": _jax_static_tokens(tree1, [ROWS[:1], ROWS[1:2]]),
            "static_single_step2": _jax_static_tokens(
                tree2, [ROWS[:1], ROWS[1:2]]),
        }
        torch.save({"config": config, "tree1": tree1, "config256": config256,
                    "tree256": tree256, "config_gqa": config_gqa,
                    "tree_gqa": tree_gqa, "run": run_dir, "rows": ROWS,
                    "replay_rows": REPLAY_ROWS},
                   workdir / "inputs.pt")
        return {"want": want, "spec": spec, "run": run_dir,
                2: _spawn(workdir, 2), 4: _spawn(workdir, 4)}
    finally:
        torch.set_num_threads(threads)
        telemetry.start()


def _check_invariants(ranks, name):
    """0 recompiles on every rank, no leaked pages, equal digests, every
    follower's loop ended by the stop with 0."""
    lead = _check_ranks(ranks, name)
    assert lead["no_leaks"], f"{name}: leaked pages or slots"
    return lead


def _check_ranks(ranks, name):
    """0 recompiles on every rank, equal digests, every follower's loop
    ended by the stop with 0."""
    lead = ranks[0][name]
    for r, res in enumerate(ranks):
        got = res[name]
        assert got["recompiles"] == 0.0, (name, r)
        assert got["digest"] == lead["digest"], (
            f"{name}: rank {r}'s tokens diverged from rank 0's")
        if r:
            assert got["rc"] == 0, (name, r)
    return lead


@pytest.mark.parametrize("page_size", [3, 8, 16])  # 16 = bucket T_max
def test_tp2_greedy_parity_page_sweep(run, page_size):
    lead = _check_invariants(run[2], f"tp2_ps{page_size}")
    assert lead["tokens"] == run["want"]["rows"]
    # the pool really is head-sharded: each rank holds Hkv / 2 heads
    spec = run["spec"]
    for res in run[2]:
        assert res[f"tp2_ps{page_size}"]["pool_heads"] == spec.kv_heads // 2
    assert lead["mesh_info"] == {"devices": 2, "axes": {"tp": 2},
                                 "weights": "fsdp",
                                 "params_gb_per_device":
                                     lead["mesh_info"]["params_gb_per_device"]}


@pytest.mark.parametrize("world,name,want", [
    (4, "tp2_fsdp2", "rows"),
    (2, "tp2_replicated", "rows"),
    (4, "tp4", "rows"),
    (2, "tp2_vocab_split", "vocab256"),
    (2, "tp2_int8", "int8"),
    (4, "tp4_gqa_whole_width", "gqa"),
])
def test_mesh_variants_greedy_parity(run, world, name, want):
    """tp x fsdp with fsdp weights, tp with replicated weights, tp 4 (one
    head a rank), a vocabulary tp splits, the int8 tiers, and heads tp
    does not divide (whole-width attention, the pool replicated): each
    decodes what one device does."""
    lead = _check_invariants(run[world], name)
    assert lead["tokens"] == run["want"][want], name
    if name == "tp4_gqa_whole_width":
        assert all(r[name]["pool_heads"] == 2 for r in run[world])


def test_fsdp_weights_hold_less_per_rank(run):
    """fsdp weights: each rank of {tp: 2, fsdp: 2} holds fewer parameter
    bytes than a rank of {tp: 2}, which holds fewer than one device."""
    fsdp = run[4][0]["tp2_fsdp2"]["mesh_info"]
    tp2 = run[2][0]["tp2_ps3"]["mesh_info"]
    repl = run[2][0]["tp2_replicated"]["mesh_info"]
    assert fsdp["axes"] == {"fsdp": 2, "tp": 2} and fsdp["devices"] == 4
    assert fsdp["params_gb_per_device"] < tp2["params_gb_per_device"]
    assert repl["weights"] == "replicated"


@pytest.mark.parametrize("world,name", [(2, "tp2_kernel"),
                                        (4, "tp2_fsdp2_kernel_lookup")])
def test_tp2_kernel_seam_greedy_parity(run, world, name):
    """``serve.attention: pallas`` on the mesh: the paged-decode seam on
    each rank's heads (its plain version on the CPU)."""
    lead = _check_invariants(run[world], name)
    assert lead["tokens"] == run["want"]["rows"]


@pytest.mark.parametrize("name", ["tp2_lookup", "tp2_draft"])
def test_tp2_speculation_greedy_parity(run, name):
    """Lookup proposals from rank 0 inside the verify op, and the draft
    model sharded on the same mesh: tokens equal the oracle's."""
    lead = _check_invariants(run[2], name)
    assert lead["tokens"] == run["want"]["rows"]
    assert lead["spec_fallbacks"] == 0.0
    assert lead["speculation"]["verify_steps"] > 0


def test_replay_after_poisoned_step_parity_mesh(run):
    lead = _check_invariants(run[2], "tp2_replay")
    assert lead["tokens"] == run["want"]["replay"]
    assert lead["replays"] >= 1
    assert lead["request_errors"] == 0.0


def test_hot_swap_under_load_mesh(run):
    """/admin/reload on rank 0 mid-burst: every rank installs its own
    slices of step_2, in-flight requests finish, and later requests
    decode step_2's tokens; 0 recompiles."""
    lead = _check_invariants(run[2], "tp2_hot_swap")
    assert lead["reload_code"] == 200, lead["reload"]
    assert lead["reload"]["reloaded"] is True
    assert lead["reload"]["checkpoint"].endswith("step_2")
    assert lead["model_version"] == 2
    assert all(r for r in lead["inflight"])
    assert lead["after"] == run["want"]["step2"]


def test_mesh_observability_surface(run):
    lead = run[2][0]["tp2_hot_swap"]
    body = lead["healthz"]
    assert body["mesh"]["devices"] == 2
    assert body["mesh"]["axes"] == {"tp": 2}
    assert body["mesh"]["weights"] == "fsdp"
    assert body["mesh"]["params_gb_per_device"] > 0
    assert body["kv"]["pool_gb_per_device"] > 0
    assert body["kv"]["pool_gb"] == pytest.approx(
        2 * body["kv"]["pool_gb_per_device"], rel=1e-3)
    assert lead["state_mesh"]["devices"] == 2
    assert lead["gauges"]["serve/mesh_devices"] == 2
    assert lead["gauges"]["serve/params_gb_per_device"] > 0


def test_streaming_reload_is_partial_and_sharded(run):
    """load_params restores the decode subset only (no reference branch,
    no value head), each leaf this rank's slice, equal to the slice the
    engine serves from the same checkpoint."""
    spec = run["spec"]
    for res in run[2]:
        got = res["streaming_reload"]
        assert got["resolved"].endswith("step_2")
        assert "ref" not in got["keys"]
        assert "v_head" not in got["trainable"]
        assert got["bytes"] < got["full_bytes"]
        assert got["wq_shape"][-1] == spec.n_head * spec.head_dim // 2
        assert got["wq_equal"] and got["ln_f_equal"]


@pytest.mark.parametrize("world,name", [(2, "tp2_static"),
                                        (4, "tp2_fsdp2_static"),
                                        (4, "tp4_static")])
def test_static_scheduler_greedy_parity_mesh(run, world, name):
    """``scheduler: static`` on the mesh: the micro-batcher's flushes are
    mirrored to every rank, whose greedy tokens equal trlx_tpu's static
    engine's; a poisoned flush fails its two requests (its seam fires
    before the publish, so no follower enters that ``generate``) and the
    rows sent again decode right, with every rank still in step."""
    lead = _check_ranks(run[world], name)
    want = run["want"]
    assert lead["tokens"] == want["static_rows"]
    assert lead["poisoned"] == ["ChaosError", "ChaosError"]
    assert lead["request_errors"] == 2.0
    assert lead["resent"] == want["static_pair"]


def test_static_hot_swap_mesh(run):
    """``MicroBatcher.request_swap`` on rank 0 with the run's newest step:
    every follower restores its own slices, the probe runs on every
    rank, and later flushes decode step_2's tokens."""
    lead = _check_ranks(run[2], "tp2_static")
    assert lead["swap"]["reloaded"] is True, lead["swap"]
    assert lead["model_version"] == 2
    assert lead["swapped"] == run["want"]["static_step2"]


def test_static_server_reload_and_stop_mesh(run):
    """The static scheduler behind HTTP on {tp: 2}: /generate, ``POST
    /admin/reload`` (200; each rank restores its slices), /generate on
    step_2, and the server's stop ending the follower's loop."""
    lead = _check_ranks(run[2], "tp2_static_http")
    want = run["want"]
    assert lead["healthz"]["scheduler"] == "static"
    assert lead["healthz"]["mesh"]["devices"] == 2
    assert lead["reload_code"] == 200, lead["reload"]
    assert lead["reload"]["checkpoint"].endswith("step_2")
    assert lead["before"] == want["static_single"]
    assert lead["after"] == want["static_single_step2"]
    assert lead["versions"] == [1, 1, 2, 2]
