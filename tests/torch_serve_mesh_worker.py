"""One process of the gloo worlds of tests/test_torch_serve_mesh_dist.py
(torch only, no JAX):

    python tests/torch_serve_mesh_worker.py <init_method> <rank> <world> <dir>

reads ``<dir>/inputs.pt`` (the configs, the numpy weights and the run
directory the test wrote), runs every serve-mesh scenario of its world
size (2: ``{tp: 2}``; 4: ``{tp: 2, fsdp: 2}`` and ``{tp: 4}``, also at
grouped-query heads that tp 4 does not divide), under the slot scheduler
and under ``scheduler: static``, and writes ``<dir>/rank<r>.pt`` with
what it saw, printing ``WORKER OK <rank>`` last. In every scenario each
process builds the engine from the same config; process 0 drives the
slot scheduler, the static micro-batcher or the HTTP server, and the
others follow its device calls (trlx_tpu_torch.serve.follower) until the
scheduler's stop ends their loops. Each process reports its token digest
(the slot runtime's or, under ``static``, the engine's), its
``compile/recompiles`` and its follower's exit code.
"""

import json
import os
import sys
import urllib.request

import torch

BUCKETS = [[2, 8, 8], [4, 8, 8]]
MAX_NEW = 4


def serve_cfg(**serve):
    from trlx_tpu_torch.serve.engine import ServeConfig

    return ServeConfig(**{"buckets": BUCKETS, "max_queue": 64,
                          "request_timeout": 60.0, "scheduler": "slots",
                          "slots": 4, "kv_layout": "paged", "page_size": 4,
                          **serve})


def run_staggered(sched, rows):
    """trlx_tpu's two admission waves: the second submits while the
    first decodes (6 requests > 4 slots queue either way)."""
    first = [sched.submit(list(r), max_new_tokens=MAX_NEW) for r in rows[:4]]
    first[0].wait(timeout=60.0)
    rest = [sched.submit(list(r), max_new_tokens=MAX_NEW) for r in rows[4:]]
    for r in first + rest:
        r.wait(timeout=60.0)
    return [r.result for r in first + rest]


def no_leaks(sched) -> bool:
    stats = sched.pool_stats()
    return (sched.free_slots() == sched.runtime.num_slots
            and stats["pages_free"] + stats["pages_cached"]
            == stats["pages_total"])


def http(port, path, payload=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode() if payload is not None else None,
        headers={"Content-Type": "application/json"},
        method="POST" if payload is not None else "GET")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def pool_heads(runtime) -> int:
    """The KV heads this process's pool holds (axis 3 of the K pages)."""
    k = runtime.pool[0][0]
    return (k[0] if isinstance(k, tuple) else k).shape[3]


def counters():
    from trlx_tpu_torch import telemetry

    return dict(telemetry.current().registry.counters)


def serve(inputs, drive, tree=None, config=None, checkpoint=None, **knobs):
    """One scenario on every process: the engine (from ``tree`` or a
    checkpoint), then process 0's ``drive(engine)`` while the others
    follow. Returns what ``drive`` saw (process 0) or the follower's exit
    code (the others), with the digest and the recompiles."""
    from trlx_tpu_torch import telemetry
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.serve.engine import InferenceEngine
    from trlx_tpu_torch.serve.follower import follow
    from trlx_tpu_torch.serve.slots import SlotPoolRuntime

    telemetry.start()
    static = knobs.get("scheduler") == "static"
    cfg = serve_cfg(**knobs)
    if checkpoint is not None:
        engine = InferenceEngine.from_checkpoint(checkpoint, serve=cfg,
                                                 device="cpu")
    else:
        engine = InferenceEngine(
            TRLConfig.from_dict(config or inputs["config"]), serve=cfg,
            params=tree if tree is not None else inputs["tree1"],
            device="cpu")
    if engine.channel.leader:
        out = drive(engine)
    elif static:
        out = {"rc": follow(engine), "digest": engine.digest.hexdigest()}
    else:
        runtime = SlotPoolRuntime(engine)
        draft = None
        if cfg.speculation == "draft":
            from trlx_tpu_torch.serve.speculate import DraftProposer

            draft = DraftProposer.from_checkpoint(
                cfg.spec_draft_checkpoint, engine, runtime.spec_k)
        out = {"rc": follow(runtime, draft),
               "digest": runtime.digest.hexdigest(),
               "pool_heads": pool_heads(runtime)}
    out["recompiles"] = counters().get("compile/recompiles", 0.0)
    out["mesh_info"] = engine.mesh_info()
    return out


def staggered(rows):
    """process 0's drive: the slot scheduler over ``rows``."""
    def drive(engine):
        from trlx_tpu_torch.serve.slots import SlotScheduler

        s = SlotScheduler(engine)
        s.warmup()
        s.start()
        try:
            got = run_staggered(s, rows)
            out = {"tokens": got, "no_leaks": no_leaks(s),
                   "spec_fallbacks": counters().get(
                       "serve/spec_fallbacks", 0.0),
                   "speculation": s.pool_stats().get("speculation"),
                   "pool_heads": pool_heads(s.runtime),
                   "kv": s.pool_stats()}
        finally:
            s.stop()
        out["digest"] = s.runtime.digest.hexdigest()
        return out

    return drive


def replay(rows):
    def drive(engine):
        from trlx_tpu_torch.serve.slots import SlotScheduler
        from trlx_tpu_torch.supervisor import chaos

        s = SlotScheduler(engine)
        s.warmup()
        s.start()
        try:
            chaos.configure("serve_decode:exc@2")
            reqs = [s.submit(list(r), max_new_tokens=MAX_NEW) for r in rows]
            for r in reqs:
                r.wait(timeout=60.0)
            chaos.reset()
            out = {"tokens": [r.result for r in reqs],
                   "replays": max(r.replays for r in reqs),
                   "request_errors": counters().get(
                       "serve/request_errors", 0.0),
                   "no_leaks": no_leaks(s)}
        finally:
            chaos.reset()
            s.stop()
        out["digest"] = s.runtime.digest.hexdigest()
        return out

    return drive


def hot_swap(rows, run):
    """Over HTTP on process 0: /healthz, /debug/state and /metrics carry
    the mesh; a reload of the run directory (its newest step) under load
    swaps on every process; the next requests decode on step_2."""
    def drive(engine):
        from trlx_tpu_torch.serve.server import InferenceServer

        srv = InferenceServer(engine, port=0).start()
        try:
            out = {"healthz": http(srv.port, "/healthz")[1],
                   "state_mesh": http(srv.port, "/debug/state")[1]["mesh"],
                   "gauges": http(srv.port, "/metrics")[1]["gauges"]}
            inflight = [srv.scheduler.submit(list(r), max_new_tokens=MAX_NEW)
                        for r in rows]
            code, body = http(srv.port, "/admin/reload", {})
            for r in inflight:
                r.wait(timeout=60.0)
            after = [srv.scheduler.submit(list(r), max_new_tokens=MAX_NEW)
                     for r in rows[:2]]
            for r in after:
                r.wait(timeout=60.0)
            out.update(reload_code=code, reload=body,
                       model_version=engine.model_version,
                       inflight=[r.result for r in inflight],
                       after=[r.result for r in after],
                       no_leaks=no_leaks(srv.scheduler))
        finally:
            srv.stop()
        out["digest"] = srv.scheduler.runtime.digest.hexdigest()
        return out

    return drive


def streaming_reload(inputs):
    """Every process: load_params of the run directory restores the
    decode subset only, each leaf this process's slice, equal to the
    slice the engine serves."""
    from trlx_tpu_torch import telemetry
    from trlx_tpu_torch.serve.engine import InferenceEngine

    telemetry.start()
    run = inputs["run"]
    engine = InferenceEngine.from_checkpoint(
        os.path.join(run, "step_2"), serve=serve_cfg(mesh={"tp": 2}),
        device="cpu")
    params, resolved = engine.load_params(run)
    wq = params["frozen_base"]["blocks"]["attn"]["wq"]
    full = sum(x.numel() * x.element_size() for x in _leaves(torch.load(
        os.path.join(resolved, "params.pt"), weights_only=True)))
    return {
        "resolved": resolved,
        "keys": sorted(params), "trainable": sorted(params["trainable"]),
        "wq_shape": tuple(wq.shape),
        "wq_equal": bool(torch.equal(wq, engine.blocks[0]["attn"]["wq"])),
        "ln_f_equal": bool(torch.equal(params["trainable"]["ln_f"]["scale"],
                                       engine.ln_f["scale"])),
        "bytes": sum(x.numel() * x.element_size() for x in _leaves(params)),
        "full_bytes": full,
        "mesh_info": engine.mesh_info(),
    }


def _leaves(tree):
    from trlx_tpu_torch.utils.aotjit import tree_flatten

    return [x for x in tree_flatten(tree)[0] if torch.is_tensor(x)]


def submit_all(sched, rows, max_new=MAX_NEW):
    """Queue every row at once (under the batcher's lock, so its worker
    sees them together): the flushes then take rows 0-3 as one batch-4
    bucket and the rest as a batch-2 one, whatever the timing. Waits for
    each without raising a failed batch's error (``Request.error``)."""
    with sched._cond:
        reqs = [sched.submit(list(r), max_new_tokens=max_new) for r in rows]
    for r in reqs:
        assert r.done.wait(timeout=60.0), "request not decoded in 60 s"
    return reqs


def static_burst(rows, swap_run=None):
    """process 0's drive under ``scheduler: static``: warmup (every
    bucket, mirrored), the rows through the micro-batcher, then a
    poisoned flush (the ``serve_decode`` seam fires before the publish,
    so no follower enters that generate) whose rows are sent again; with
    ``swap_run``, a hot-swap to its newest step (each follower restores
    its own slices) and the first two rows again."""
    def drive(engine):
        from trlx_tpu_torch.serve.batcher import MicroBatcher
        from trlx_tpu_torch.supervisor import chaos

        b = MicroBatcher(engine)
        b.warmup()
        b.start()
        try:
            out = {"tokens": [r.result for r in submit_all(b, rows)]}
            chaos.configure("serve_decode:exc@1")
            failed = submit_all(b, rows[:2])
            chaos.reset()
            out["poisoned"] = [type(r.error).__name__ for r in failed]
            out["resent"] = [r.result for r in submit_all(b, rows[:2])]
            out["request_errors"] = counters().get("serve/request_errors",
                                                   0.0)
            if swap_run is not None:
                params, resolved = engine.load_params(swap_run)
                out["swap"] = b.request_swap(params, label=resolved)
                del params
                out["swapped"] = [r.result for r in submit_all(b, rows[:2])]
                out["model_version"] = engine.model_version
        finally:
            chaos.reset()
            b.stop()
        out["digest"] = engine.digest.hexdigest()
        return out

    return drive


def static_http(rows):
    """process 0 serves ``scheduler: static`` over HTTP from a run's
    step_1: /generate, ``POST /admin/reload`` of the run (its newest
    step, restored by every process from its own slices), /generate
    again; the server's stop ends the followers."""
    def drive(engine):
        from trlx_tpu_torch.serve.server import InferenceServer

        srv = InferenceServer(engine, port=0).start()
        try:
            before = [http(srv.port, "/generate",
                           {"tokens": list(r), "max_new_tokens": MAX_NEW})[1]
                      for r in rows[:2]]
            code, body = http(srv.port, "/admin/reload", {})
            after = [http(srv.port, "/generate",
                          {"tokens": list(r), "max_new_tokens": MAX_NEW})[1]
                     for r in rows[:2]]
            out = {"healthz": http(srv.port, "/healthz")[1],
                   "before": [b["tokens"] for b in before],
                   "after": [b["tokens"] for b in after],
                   "versions": [b["model_version"] for b in before + after],
                   "reload_code": code, "reload": body}
        finally:
            srv.stop()
        out["digest"] = engine.digest.hexdigest()
        return out

    return drive


def scenarios(world, inputs):
    rows, run = inputs["rows"], inputs["run"]
    if world == 2:
        tp2 = {"mesh": {"tp": 2}}
        out = {f"tp2_ps{ps}": (staggered(rows), {**tp2, "page_size": ps})
               for ps in (3, 8, 16)}
        out.update({
            "tp2_replicated": (staggered(rows),
                               {**tp2, "mesh_weights": "replicated"}),
            "tp2_kernel": (staggered(rows), {**tp2, "attention": "pallas"}),
            "tp2_lookup": (staggered(rows), {**tp2, "speculation": "lookup",
                                             "spec_k": 4}),
            "tp2_draft": (staggered(rows), {
                **tp2, "speculation": "draft", "spec_k": 2,
                "spec_draft_checkpoint": os.path.join(run, "step_1")}),
            "tp2_int8": (staggered(rows), {**tp2, "weights_dtype": "int8",
                                           "kv_dtype": "int8",
                                           "attention": "pallas"}),
            "tp2_vocab_split": (staggered(rows), {**tp2, "_vocab256": True}),
            "tp2_replay": (replay(inputs["replay_rows"]), tp2),
            "tp2_hot_swap": (hot_swap(rows, run), {
                **tp2, "_checkpoint": os.path.join(run, "step_1")}),
            "tp2_static": (static_burst(rows, run), {
                **tp2, "scheduler": "static",
                "_checkpoint": os.path.join(run, "step_1")}),
            "tp2_static_http": (static_http(rows), {
                **tp2, "scheduler": "static",
                "_checkpoint": os.path.join(run, "step_1")}),
        })
        return out
    return {
        "tp2_fsdp2": (staggered(rows), {"mesh": {"tp": 2, "fsdp": 2}}),
        "tp2_fsdp2_kernel_lookup": (staggered(rows), {
            "mesh": {"tp": 2, "fsdp": 2}, "attention": "pallas",
            "speculation": "lookup", "spec_k": 4}),
        "tp4": (staggered(rows), {"mesh": {"tp": 4}, "attention": "pallas"}),
        "tp4_gqa_whole_width": (staggered(rows), {
            "mesh": {"tp": 4}, "attention": "pallas", "_gqa": True}),
        "tp2_fsdp2_static": (static_burst(rows), {
            "mesh": {"tp": 2, "fsdp": 2}, "scheduler": "static"}),
        "tp4_static": (static_burst(rows), {
            "mesh": {"tp": 4}, "scheduler": "static"}),
    }


def main():
    init_method, rank, world, workdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from trlx_tpu_torch.parallel.runtime import initialize_runtime

    initialize_runtime(init_method, world, rank, "cpu")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    results = {}
    for name, (drive, knobs) in scenarios(world, inputs).items():
        knobs = dict(knobs)
        kw = {}
        if knobs.pop("_vocab256", False):
            kw = {"tree": inputs["tree256"], "config": inputs["config256"]}
        if knobs.pop("_gqa", False):
            kw = {"tree": inputs["tree_gqa"], "config": inputs["config_gqa"]}
        checkpoint = knobs.pop("_checkpoint", None)
        print(f"rank {rank}: {name}", flush=True)
        results[name] = serve(inputs, drive, checkpoint=checkpoint, **kw,
                              **knobs)
    if world == 2:
        results["streaming_reload"] = streaming_reload(inputs)
    torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
    print(f"WORKER OK {rank}", flush=True)


if __name__ == "__main__":
    main()
