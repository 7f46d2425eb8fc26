#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (trlx_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. device — a CUDA card must be present (no CPU fallback); prints the
   card's name and power limit as nvidia-smi reports them.
2. build — compiles every kernel source under trlx_tpu_torch/csrc with
   nvcc for sm_90a (ptxas registers / shared memory / spills printed).
3. kernel — each kernel against its plain PyTorch version on the card:
   the paged-decode kernel at fp32 (GQA + sentinel pages, atol 1e-5),
   in the int8 tier (atol 1e-5), and at the serving shape in bf16 with
   a fully masked free row that must come out finite (atol 1e-2 + rtol
   1e-2 against the plain version in fp32 on the same bf16 inputs); then
   CUDA-event timings of kernel, plain version and the gather + SDPA
   yardstick at the serving shape and at a 1024-token context, each
   beside its bound: device time from CUDA-graph replay (the numbers in
   the kernels line) and the eager loop's time, which includes the
   host's launch cost.
4. serve — the port's serving path at gpt2-124M width (12 layers, seeded
   random weights, bf16) behind its HTTP server: concurrent
   ``/generate`` requests with mixed ``max_new_tokens`` and a shared
   system prompt, ``/healthz``, kernel launches == layers x decode
   steps, radix prefix hits > 0; prints tok/s and latency.
5. parity — the same requests through fp32 engines on the kernel path
   and on the plain path, with the same weights: identical greedy tokens.

Then one ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

import json
import math
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from trlx_tpu_torch import ops, telemetry
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.generation import PAGE_SENTINEL as SENT
from trlx_tpu_torch.models.params import init_decode_views
from trlx_tpu_torch.models.transformer import (
    NEG_INF,
    apply_blocks,
    causal_mask_bias,
    embed_tokens,
    lm_logits,
    quantize_kv,
)
from trlx_tpu_torch.ops import _build
from trlx_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_reference,
    shared_memory_bytes,
)
from trlx_tpu_torch.serve import (
    InferenceEngine,
    InferenceServer,
    ServeConfig,
    SlotScheduler,
)

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

#: gpt2-124M geometry from config, byte tokenizer, greedy decode
GPT2_SPEC = {"vocab_size": 50257, "n_layer": 12, "n_head": 12,
             "d_model": 768, "n_positions": 1024}
#: (batch, prompt_len, gen_len): the (16, 48) class of the serving legs
#: plus a (32, 32) class for prompts that carry a shared 16-token system
#: prompt — the radix cache only matches whole pages and always leaves a
#: suffix token, so a 16-token page is only hit by prompts of 17+
#: tokens. Every class spans 64 positions: 4 pages of 16 per slot.
SERVE_BUCKETS = [[8, 16, 48], [16, 16, 48], [16, 32, 32]]
SYSTEM_PROMPT = "You answer well."  # 16 bytes: one page
USER_PROMPTS = [
    ("Hi", 48), ("What is 2+2?", 40), ("Tell a story", 24), ("x", 8),
    (SYSTEM_PROMPT + " Who are you?", 32),
    (SYSTEM_PROMPT + " Name a fruit.", 20),
    (SYSTEM_PROMPT + " Count to 5.", 12),
    (SYSTEM_PROMPT + " Say hi.", 30),
    (SYSTEM_PROMPT + " Spell cat", 16),
    (SYSTEM_PROMPT + " Why?", 32),
]


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def config_dict(compute_dtype="bfloat16"):
    return {
        "model": {
            "model_path": "from-config", "tokenizer_path": "byte",
            "model_type": "JaxPPOTrainer", "num_layers_unfrozen": 2,
            "model_spec": dict(GPT2_SPEC), "compute_dtype": compute_dtype,
        },
        "train": {
            "n_ctx": 64, "epochs": 1, "total_steps": 4, "batch_size": 8,
            "grad_clip": 1.0, "lr_ramp_steps": 0, "lr_decay_steps": 4,
            "weight_decay": 1e-6, "learning_rate_init": 1e-3,
            "learning_rate_target": 1e-3, "log_interval": 10**9,
            "checkpoint_interval": 10**9, "eval_interval": 10**9,
            "pipeline": "PPOPipeline", "orchestrator": "PPOOrchestrator",
            "input_size": 4, "gen_size": 48, "seed": 0,
        },
        "method": {
            "name": "ppoconfig", "num_rollouts": 8, "chunk_size": 8,
            "ppo_epochs": 1,
            "gen_kwargs": {"max_length": 48, "top_k": 0, "top_p": 1.0,
                           "do_sample": False},
        },
    }


# --------------------------------------------------------------------- #
# 1. device
# --------------------------------------------------------------------- #


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# 3. kernel checks and timings
# --------------------------------------------------------------------- #


def kernel_case(dev, seed=0):
    """tests/test_paged_kernel.py's _kernel_case geometry, fp32."""
    rng = np.random.default_rng(seed)
    S, H, Hkv, hd = 3, 4, 2, 16
    num_pages, page_size, max_pages = 10, 4, 3
    T = max_pages * page_size
    q = rng.standard_normal((S, H, hd))
    k = rng.standard_normal((num_pages, page_size, Hkv, hd))
    v = rng.standard_normal((num_pages, page_size, Hkv, hd))
    pt = np.asarray([[1, 3, SENT], [0, SENT, SENT], [5, 6, 7]], np.int32)
    lengths = np.asarray([6, 3, 12])
    bias = np.where(np.arange(T)[None, :] < lengths[:, None], 0.0, NEG_INF)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    return (f32(q), f32(k), f32(v), torch.tensor(pt, device=dev),
            f32(bias))


def serving_case(dev, seed, S=16, H=12, Hkv=12, hd=64, page_size=16,
                 max_pages=4, lengths=None, free_row=None, copies=1):
    """bf16 decode inputs at a serving geometry: each slot owns its own
    pages (shuffled), ragged lengths, sentinels past each slot's pages,
    and optionally one free row (all sentinel, all masked). ``copies``
    distinct K/V pools (to time with a cold L2)."""
    rng = np.random.default_rng(seed)
    T = max_pages * page_size
    if lengths is None:
        lengths = rng.integers(1, T + 1, S)
    lengths = np.asarray(lengths)
    num_pages = S * max_pages
    perm = rng.permutation(num_pages).astype(np.int32)
    pt = np.full((S, max_pages), SENT, np.int32)
    for s in range(S):
        used = -(-int(lengths[s]) // page_size)
        pt[s, :used] = perm[s * max_pages:s * max_pages + used]
    bias = np.where(np.arange(T)[None, :] < lengths[:, None], 0.0, NEG_INF)
    if free_row is not None:
        pt[free_row] = SENT
        bias[free_row] = NEG_INF
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q = randn(S, H, hd)
    pools = [(randn(num_pages, page_size, Hkv, hd),
              randn(num_pages, page_size, Hkv, hd)) for _ in range(copies)]
    return (q, pools, torch.tensor(pt, device=dev),
            torch.tensor(bias, dtype=torch.float32, device=dev))


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_kernel(dev):
    """The correctness checks; returns the largest error seen."""
    q, k, v, pt, bias = kernel_case(dev)
    out = paged_decode_attention(q, k, v, pt, bias)
    ref = paged_decode_attention_reference(q, k, v, pt, bias)
    torch.cuda.synchronize()
    err32 = max_err(out, ref)
    log("kernel", f"fp32 GQA+sentinels max_abs_err={err32:.3e} "
                  f"(atol 1e-5)")
    assert err32 <= 1e-5, "fp32 kernel disagrees with its plain version"

    q, k, v, pt, bias = kernel_case(dev, seed=1)
    kq, vq = quantize_kv(k), quantize_kv(v)
    out = paged_decode_attention(q, kq, vq, pt, bias)
    ref = paged_decode_attention_reference(q, kq, vq, pt, bias)
    torch.cuda.synchronize()
    err8 = max_err(out, ref)
    log("kernel", f"int8 tier max_abs_err={err8:.3e} (atol 1e-5)")
    assert err8 <= 1e-5, "int8 kernel disagrees with its plain version"

    q, ((k, v),), pt, bias = serving_case(dev, seed=2, free_row=5)
    out = paged_decode_attention(q, k, v, pt, bias)
    ref = paged_decode_attention_reference(q.float(), k, v, pt, bias)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all(), "non-finite kernel output"
    errb = max_err(out, ref)
    bad = (out.float() - ref).abs() > 1e-2 + 1e-2 * ref.abs()
    log("kernel", f"bf16 serving shape (free row 5 finite) "
                  f"max_abs_err={errb:.3e} (atol 1e-2 + rtol 1e-2)")
    assert not bad.any(), "bf16 kernel disagrees with its plain version"
    return max(err32, err8, errb)


def time_ms(fn, args_list, iters):
    """Mean ms per EAGER call over ``iters`` calls cycling ``args_list``
    (so a pool set larger than L2 is read cold), CUDA events, after
    warmup. Includes the host's launch cost where that exceeds the
    device's work."""
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fns, args_list, iters):
    """Device ms per call of each function: ``iters`` calls cycling
    ``args_list`` captured into one CUDA graph per function, so no host
    launch cost is timed. The graphs replay in turns (forward, then
    reversed) and each reading is the mean of its two replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        for fn in fns:
            for a in args_list[:3]:
                fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs = []
    for fn in fns:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fn(*args_list[i % len(args_list)])
        g.replay()
        graphs.append(g)
    torch.cuda.synchronize()
    total = [0.0] * len(fns)
    order = list(range(len(fns)))
    for turn in (order, order[::-1]):
        for i in turn:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[i].replay()
            stop.record()
            torch.cuda.synchronize()
            total[i] += start.elapsed_time(stop) / iters
    del graphs
    return [t / 2 for t in total]


def library_attention(q, k_pages, v_pages, pt, bias):
    """The yardstick: clamp-gather to logical order, then one
    scaled_dot_product_attention call (two PyTorch calls; the port never
    calls this)."""
    S, H, hd = q.shape
    num_pages, ps, Hkv, _ = k_pages.shape
    ctx = pt.long().clamp(0, num_pages - 1)
    k = k_pages[ctx].reshape(S, -1, Hkv, hd).transpose(1, 2)
    v = v_pages[ctx].reshape(S, -1, Hkv, hd).transpose(1, 2)
    gqa = {"enable_gqa": True} if Hkv != H else {}
    out = F.scaled_dot_product_attention(
        q[:, :, None, :], k, v,
        attn_mask=bias[:, None, None, :].to(q.dtype), **gqa,
    )
    return out[:, :, 0, :]


def bound(q, k_pages, pt, bias):
    """Least time the card could take (ms): bytes each input needs read
    once (K/V of the pages holding any unmasked position) and the output
    written once, over HBM bandwidth, vs the score + weighted-sum FLOPs
    of those positions over the bf16 peak."""
    S, H, hd = q.shape
    _, ps, Hkv, _ = k_pages.shape
    live_pages = int((bias.reshape(S, -1, ps) > NEG_INF / 2).any(-1).sum())
    kv = 2 * live_pages * ps * Hkv * hd * k_pages.element_size()
    io = 2 * q.numel() * q.element_size() + pt.numel() * 4 \
        + bias.numel() * 4
    flops = 4 * H * hd * live_pages * ps
    by_bytes = (kv + io) / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), kv + io


def time_kernel(dev, label, max_pages, iters):
    """Kernel / plain / yardstick times at a full-length bf16 geometry,
    cycling enough pool copies to exceed the 50 MB L2."""
    pool_bytes = 2 * 16 * max_pages * 16 * 12 * 64 * 2
    copies = max(1, math.ceil(120e6 / pool_bytes))
    q, pools, pt, bias = serving_case(
        dev, seed=3, max_pages=max_pages, lengths=[max_pages * 16] * 16,
        copies=copies,
    )
    args = [(q, k, v, pt, bias) for k, v in pools]
    fns = (paged_decode_attention, paged_decode_attention_reference,
           library_attention)
    eager = [time_ms(fn, args, iters) for fn in fns]
    ms, plain, lib = graph_ms(fns, args, iters)
    b_ms, b_by, nbytes = bound(q, pools[0][0], pt, bias)
    log("kernel", f"{label}: S=16 H=Hkv=12 hd=64 ps=16 max_pages="
                  f"{max_pages} bf16, {nbytes / 1e6:.2f} MB, {copies} pool "
                  f"copies cycled; device (CUDA graph): kernel "
                  f"{ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, "
                  f"gather+SDPA {lib * 1e3:.2f} us; eager loop: kernel "
                  f"{eager[0] * 1e3:.2f} us, plain {eager[1] * 1e3:.2f} us, "
                  f"gather+SDPA {eager[2] * 1e3:.2f} us; bound "
                  f"{b_ms * 1e3:.3f} us ({b_by})")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": b_ms, "bound_by": b_by, "eager_ms": eager[0],
            "eager_plain_ms": eager[1], "eager_library_ms": eager[2]}


# --------------------------------------------------------------------- #
# 4. serve over HTTP
# --------------------------------------------------------------------- #


def build_engine(views, device, compute_dtype, attention):
    serve = ServeConfig(buckets=[list(b) for b in SERVE_BUCKETS],
                        slots=16, page_size=16, attention=attention,
                        max_queue=256, request_timeout=600.0)
    return InferenceEngine(TRLConfig.from_dict(config_dict(compute_dtype)),
                           serve=serve, views=views, device=device)


def post(url, payload, timeout=600):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def check_counts(results, eos):
    """Each response returns exactly its own count (or stops early on
    the tokenizer's eos, which then ends it)."""
    for (prompt, max_new), tokens in results:
        ended = bool(tokens) and tokens[-1] == eos
        assert len(tokens) == max_new or (ended and len(tokens) < max_new), (
            f"{prompt!r}: {len(tokens)} tokens for max_new_tokens="
            f"{max_new}")


def serve_phase(views, device, requests=USER_PROMPTS):
    """The main path: engine -> HTTP server -> concurrent /generate.
    Returns the responses' tokens and the run's numbers."""
    telemetry.start()
    engine = build_engine(views, device, "bfloat16", "pallas")
    ops.reset_launches()
    server = InferenceServer(engine, host="127.0.0.1", port=0)
    t0 = time.perf_counter()
    server.start()
    warm_s = time.perf_counter() - t0
    base = f"http://127.0.0.1:{server.port}"
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(requests)) as pool:
            bodies = list(pool.map(
                lambda r: post(f"{base}/generate",
                               {"prompt": r[0], "max_new_tokens": r[1]}),
                requests,
            ))
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES["paged_decode"]
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok", health
    finally:
        server.stop()
    steps = server.scheduler.runtime.steps
    n_layer = engine.spec.n_layer
    results = [(r, b["tokens"]) for r, b in zip(requests, bodies)]
    check_counts(results, engine.tokenizer.eos_token_id)
    registry = telemetry.current().registry
    hits = registry.counters.get("serve/prefix_tokens_saved", 0.0)
    # host-clock spans that close after the results reach the host; the
    # first call of each span is the warmup's and is left out
    step = registry.hists["time/serve/slot_step"]
    prefills = [h for name, h in registry.hists.items()
                if name.startswith("time/serve/prefill")]
    if device == "cuda":
        assert launches == n_layer * steps, (
            f"kernel launches {launches} != {n_layer} layers x {steps} "
            f"decode steps")
        assert launches > 0
    assert hits > 0, "no radix prefix hit"
    generated = sum(len(t) for _, t in results)
    lat = sorted(b["latency_ms"] for b in bodies)
    return {
        "results": results, "launches": launches, "steps": steps,
        "prefix_tokens_saved": hits, "warmup_s": warm_s, "wall_s": wall,
        "tokens": generated, "tok_per_s": generated / wall,
        "latency_p50_ms": lat[len(lat) // 2], "latency_max_ms": lat[-1],
        "kv": health["kv"],
        "step_p50_ms": step.quantile(0.5) * 1e3,
        "step_p95_ms": step.quantile(0.95) * 1e3,
        "step_count": len(step.window),
        "prefill_s": sum(h.total - h.first for h in prefills),
        "prefill_calls": sum(len(h.window) for h in prefills),
    }


# --------------------------------------------------------------------- #
# 5. greedy parity: kernel path vs plain path at fp32
# --------------------------------------------------------------------- #


def run_scheduler(engine, requests):
    sched = SlotScheduler(engine)
    sched.warmup()
    reqs = [sched.submit(engine.encode_prompt(p), max_new_tokens=n)
            for p, n in requests]
    sched.start()  # everything queued first: one admission order
    try:
        return [r.wait(timeout=600).result for r in reqs], sched
    finally:
        sched.stop()


@torch.no_grad()
def logit_gap(engine, tokens):
    """Top-1 minus top-2 next-token logit after ``tokens``, from one dense
    fp32 forward without a cache (how near a tie a divergence sits)."""
    ids = torch.tensor([tokens], device=engine.device)
    pos = torch.arange(len(tokens), device=engine.device)[None]
    h = embed_tokens(engine.embed, engine.spec, ids, pos,
                     engine.compute_dtype)
    bias = causal_mask_bias(torch.ones_like(ids))
    for seg in engine.blocks:
        h = apply_blocks(seg, engine.spec, h, bias, pos)
    top2 = lm_logits(engine.embed, engine.ln_f, engine.spec, h)[0, -1]
    top2 = top2.topk(2).values
    return float(top2[0] - top2[1])


def parity_phase(views, device, requests=USER_PROMPTS):
    out = {}
    for attention in ("pallas", "jnp"):
        telemetry.start()
        engine = build_engine(views, device, "float32", attention)
        out[attention], _ = run_scheduler(engine, requests)
    for i, (a, b) in enumerate(zip(out["pallas"], out["jnp"])):
        if a != b:
            j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            gap = logit_gap(engine, engine.encode_prompt(requests[i][0])
                            + a[:j])
            log("parity", f"request {i} diverges at token {j}: "
                          f"{a[j]} vs {b[j]}, top-2 logit gap {gap:.3e}")
    assert out["pallas"] == out["jnp"], "kernel path != plain path (fp32)"
    return out


# --------------------------------------------------------------------- #
# main
# --------------------------------------------------------------------- #


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this smoke test runs only on "
              "the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("device", f"{card}; torch {torch.__version__} cuda "
                  f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} "
                  f"x{torch.cuda.device_count()}")

    info = _build.build()
    for name, entry in info.items():
        ptxas = [ln.strip() for ln in str(entry["log"]).splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        log("build", f"{name}: {entry['seconds']:.2f}s nvcc")
        for ln in ptxas:
            log("build", f"  {ln}")
    log("build", "paged_decode dynamic shared memory per block: "
                 f"{shared_memory_bytes(12, 12, 64, 4)} B at the serving "
                 f"shape, {shared_memory_bytes(12, 12, 64, 64)} B at a "
                 f"1024-token context")

    err = check_kernel("cuda")
    serving = time_kernel("cuda", "serving shape", max_pages=4, iters=500)
    long_ctx = time_kernel("cuda", "1024-token context", max_pages=64,
                           iters=200)

    views = init_decode_views(TRLConfig.from_dict(config_dict()).model
                              .resolve_spec(), seed=0,
                              num_layers_unfrozen=2)
    run = serve_phase(views, "cuda")
    log("serve", f"{len(run['results'])} concurrent HTTP requests, "
                 f"{run['tokens']} tokens in {run['wall_s']:.3f}s = "
                 f"{run['tok_per_s']:.1f} tok/s, latency p50 "
                 f"{run['latency_p50_ms']:.1f} ms max "
                 f"{run['latency_max_ms']:.1f} ms, warmup "
                 f"{run['warmup_s']:.2f}s; {run['steps']} decode steps, "
                 f"{run['launches']} kernel launches, prefix tokens saved "
                 f"{run['prefix_tokens_saved']:.0f}; decode step p50 "
                 f"{run['step_p50_ms']:.2f} ms p95 {run['step_p95_ms']:.2f}"
                 f" ms over {run['step_count']} steps, prefill "
                 f"{run['prefill_s']:.3f}s in {run['prefill_calls']} calls "
                 f"({card}; for information, not a metric)")
    parity = parity_phase(views, "cuda")
    log("parity", f"fp32 greedy tokens identical on {len(parity['jnp'])} "
                  f"requests (kernel path vs plain path)")
    print(json.dumps({"timing": {"serving_shape": serving,
                                 "ctx1024": long_ctx}}))
    print(json.dumps({"kernels": [{
        "name": "paged_decode",
        "route": "cuda",
        "source": "trlx_tpu_torch/csrc/paged_decode.cu",
        "replaces": "trlx_tpu/ops/paged_attention.py:58",
        "launches": run["launches"],
        "max_abs_err": err,
        "ms": serving["ms"],
        "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
