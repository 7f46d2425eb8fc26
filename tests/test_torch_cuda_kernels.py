"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card (``cuda`` marker). Each test decides inside itself
whether a card is there and skips with a reason where there is none.

This file imports no JAX, so it also runs on a machine with a card and
no JAX, without the JAX test harness::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Its numpy cases are shared with tests/test_torch_paged_attention.py,
which holds the plain versions against trlx_tpu's Pallas kernels."""

import numpy as np
import pytest
import torch

from trlx_tpu_torch import ops
from trlx_tpu_torch.models.generation import PAGE_SENTINEL as SENT
from trlx_tpu_torch.models.transformer import NEG_INF, quantize_kv
from trlx_tpu_torch.ops import paged_attention as pa
from trlx_tpu_torch.ops.paged_attention import (
    decode_partitions,
    paged_decode_attention,
    paged_decode_attention_reference,
)


def _kernel_case(seed=0):
    """tests/test_paged_kernel.py's geometry (GQA, sentinel pages, ragged
    lengths), drawn with numpy."""
    rng = np.random.default_rng(seed)
    S, H, Hkv, hd = 3, 4, 2, 16
    num_pages, page_size, max_pages = 10, 4, 3
    T = max_pages * page_size
    q = rng.standard_normal((S, H, hd)).astype(np.float32)
    k = rng.standard_normal((num_pages, page_size, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages, page_size, Hkv, hd)).astype(np.float32)
    pt = np.asarray([[1, 3, SENT], [0, SENT, SENT], [5, 6, 7]], np.int32)
    lengths = np.asarray([6, 3, 12])
    bias = np.where(np.arange(T)[None, :] < lengths[:, None], 0.0,
                    NEG_INF).astype(np.float32)
    return q, k, v, pt, bias


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _split_case(seed=0, S=5, H=8, Hkv=2, hd=64, page_size=16, max_pages=64,
                lengths=(1, 128, 129, 700, 0), free_row=4):
    """A long-context decode case the planner splits (P > 1): each slot
    owns shuffled pages, sentinels past its length, ragged lengths that
    end at and beside partition edges, and one free row (all sentinel,
    all masked); float32, drawn with numpy."""
    rng = np.random.default_rng(seed)
    T = max_pages * page_size
    num_pages = S * max_pages
    perm = rng.permutation(num_pages).astype(np.int32)
    pt = np.full((S, max_pages), SENT, np.int32)
    for s, n in enumerate(lengths):
        used = -(-n // page_size)
        pt[s, :used] = perm[s * max_pages:s * max_pages + used]
    bias = np.where(np.arange(T)[None, :] < np.asarray(lengths)[:, None],
                    0.0, NEG_INF).astype(np.float32)
    pt[free_row] = SENT
    bias[free_row] = NEG_INF
    q = rng.standard_normal((S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((num_pages, page_size, Hkv, hd))
            .astype(np.float32) for _ in range(2))
    return q, k, v, pt, bias


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against its plain version on the card:
    fp32 (GQA + sentinels), the int8 tier, and bf16 with a fully masked
    row. Runs on a machine with a CUDA card; skips elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, pt, bias = _kernel_case()
    args = [_t(x).to(dev) for x in (q, k, v, pt, bias)]
    before = ops.LAUNCHES["paged_decode"]
    out = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode"] == before + 1
    ref = paged_decode_attention_reference(*args)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)

    kc, ks = quantize_kv(args[1])
    vc, vs = quantize_kv(args[2])
    out8 = paged_decode_attention(args[0], (kc, ks), (vc, vs), *args[3:])
    ref8 = paged_decode_attention_reference(args[0], (kc, ks), (vc, vs),
                                            *args[3:])
    torch.testing.assert_close(out8, ref8, atol=1e-5, rtol=0)

    qb = args[0].to(torch.bfloat16)
    kb, vb = args[1].to(torch.bfloat16), args[2].to(torch.bfloat16)
    pt_free, bias_free = args[3].clone(), args[4].clone()
    pt_free[1] = SENT
    bias_free[1] = NEG_INF
    outb = paged_decode_attention(qb, kb, vb, pt_free, bias_free)
    refb = paged_decode_attention_reference(qb.float(), kb, vb, pt_free,
                                            bias_free)
    assert torch.isfinite(outb.float()).all()
    torch.testing.assert_close(outb.float(), refb, atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_cuda_split_paged_decode_matches_plain_version(pool):
    """Split-K paged decode (P > 1 partitions, one cluster, merged through
    its shared memory) against the plain version on the card, for each
    pool dtype: a float32
    pool and the int8 tier with float32 q at atol 1e-5; a bf16 pool with
    bf16 q at atol 1e-2 + rtol 1e-2 against float32 math on the same
    inputs. GQA, lengths at partition edges, a dead partition and a free
    row that must come out finite; one launch is counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, pt, bias = (_t(x).to(dev) for x in _split_case())
    assert decode_partitions(5, 2, 64, 16)[0] > 1
    if pool == "int8":
        k, v = quantize_kv(k), quantize_kv(v)
    elif pool == "bfloat16":
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    before = ops.LAUNCHES["paged_decode"]
    out = paged_decode_attention(q, k, v, pt, bias)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode"] == before + 1
    ref = paged_decode_attention_reference(q.float(), k, v, pt, bias)
    assert out.dtype == q.dtype and torch.isfinite(out.float()).all()
    tol = dict(atol=1e-2, rtol=1e-2) if pool == "bfloat16" else \
        dict(atol=1e-5, rtol=0)
    torch.testing.assert_close(out.float(), ref, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("H,Hkv,lengths", [
    (16, 16, (1, 128, 129, 700, 0)),  # gpt-j-6B's heads
    (8, 2, (33, 1024, 511, 2, 0)),  # GQA
])
def test_cuda_paged_decode_head_dim_256(pool, H, Hkv, lengths):
    """Paged decode at head_dim 256 (a float32 row is 64 vectors of 16
    bytes, two a lane) against the plain version on the card, split-K at
    a 1024-token context with ragged lengths, a dead partition and a free
    row, and the one-partition serving context: float32 and int8 pools
    with float32 q at atol 1e-5, a bf16 pool with bf16 q at
    atol 1e-2 + rtol 1e-2 against float32 math on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    cases = [_split_case(seed=3, H=H, Hkv=Hkv, hd=256, lengths=lengths),
             _split_case(seed=4, S=16, H=H, Hkv=Hkv, hd=256, max_pages=4,
                         lengths=tuple(range(1, 65, 4)), free_row=15)]
    for case in cases:
        q, k, v, pt, bias = (_t(x).to(dev) for x in case)
        if pool == "int8":
            k, v = quantize_kv(k), quantize_kv(v)
        elif pool == "bfloat16":
            q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        before = ops.LAUNCHES["paged_decode"]
        out = paged_decode_attention(q, k, v, pt, bias)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["paged_decode"] == before + 1
        ref = paged_decode_attention_reference(q.float(), k, v, pt, bias)
        assert out.dtype == q.dtype and torch.isfinite(out.float()).all()
        tol = dict(atol=1e-2, rtol=1e-2) if pool == "bfloat16" else \
            dict(atol=1e-5, rtol=0)
        torch.testing.assert_close(out.float(), ref, **tol)


#: (q dtype, pool dtype) pairs the kernel is built for
PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
         (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.float32, torch.int8)]


def _on_card(case, q_dtype, kv_dtype):
    """A numpy case on the card: q in ``q_dtype``, the pool in
    ``kv_dtype`` (int8: the (codes, scales) pair)."""
    q, k, v, pt, bias = (_t(x).cuda() for x in case)
    if kv_dtype == torch.int8:
        k, v = quantize_kv(k), quantize_kv(v)
    else:
        k, v = k.to(kv_dtype), v.to(kv_dtype)
    return q.to(q_dtype), k, v, pt, bias


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("q_dtype,kv_dtype", PAIRS,
                         ids=["bf16-bf16", "bf16-int8", "f32-f32",
                              "f32-bf16", "f32-int8"])
def test_cuda_paged_decode_every_partition_count(q_dtype, kv_dtype, hd):
    """Every partition count P = 1 to 8 (the blocks of one cluster) at a
    64-page context (GQA H 8 / Hkv 2, lengths at partition edges, a dead
    partition, a free row), and one slot's 4096-token stream beside a
    free slot at the planner's P (8), against the plain version on the
    same inputs: float32 q at atol 1e-5, bf16 q at atol 1e-2 + rtol 1e-2
    against float32 math; every row finite; one launch counted per call.
    The short partitions (P >= 4: 16 pages or fewer) take the direct
    ring, the long ones the compact ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tol = dict(atol=1e-2, rtol=1e-2) if q_dtype == torch.bfloat16 else \
        dict(atol=1e-5, rtol=0)
    split = _on_card(_split_case(seed=7, hd=hd), q_dtype, kv_dtype)
    stream = _on_card(_split_case(seed=8, S=2, H=4, Hkv=4, hd=hd,
                                  max_pages=256, lengths=(4096, 0),
                                  free_row=1), q_dtype, kv_dtype)
    assert decode_partitions(2, 4, 256, 16)[0] == 8
    for case, counts in ((split, range(1, 9)), (stream, (None,))):
        q, k, v, pt, bias = case
        ref = paged_decode_attention_reference(q.float(), k, v, pt, bias)
        for P in counts:
            before = ops.LAUNCHES["paged_decode"]
            out = pa._launch(q, k, v, pt, bias, partitions=P)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["paged_decode"] == before + 1
            assert out.dtype == q.dtype and torch.isfinite(out.float()).all()
            torch.testing.assert_close(out.float(), ref, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", PAIRS[:2],
                         ids=["bf16-bf16", "bf16-int8"])
def test_cuda_paged_decode_graph_replay(q_dtype, kv_dtype):
    """The serve step's order captured in a CUDA graph: a scatter into the
    pool, then the kernel (a cluster launch through cudaLaunchKernelEx,
    its tensor maps passed by value). A replay equals the eager calls bit
    for bit; after the scatter's source changes, a second replay reads
    the new pool: it equals the eager calls on it, and differs from the
    first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, pt, bias = _on_card(
        _split_case(seed=9, S=16, H=12, Hkv=12, max_pages=4,
                    lengths=tuple(range(4, 68, 4)), free_row=5),
        q_dtype, kv_dtype)
    codes = k[0] if kv_dtype == torch.int8 else k
    rows = torch.arange(0, codes.shape[0], 2, device="cuda")
    src = torch.zeros_like(codes[rows])

    def step():
        codes.index_copy_(0, rows, src)
        return paged_decode_attention(q, k, v, pt, bias)

    src.copy_(codes[rows])
    eager = step().clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    src.copy_(codes[rows.flip(0)])
    graph.replay()
    torch.cuda.synchronize()
    replayed = out.clone()
    fresh = step()
    torch.cuda.synchronize()
    assert torch.equal(replayed, fresh)
    assert not torch.equal(fresh, eager)


@pytest.mark.cuda
def test_cuda_paged_decode_refuses_misaligned_rows():
    """The kernel reads 16-byte vectors, so the wrapper raises on a q or
    a pool that does not start 16-byte aligned rather than launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, k, v, pt, bias = (_t(x).to(dev) for x in _kernel_case())
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))

    def shifted(x):  # contiguous, 2 bytes off
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
        return buf.view(x.shape).copy_(x)
    for args in ((shifted(q), k, v), (q, shifted(k), v), (q, k, shifted(v))):
        with pytest.raises(ValueError, match="16-byte aligned"):
            paged_decode_attention(*args, pt, bias)


#: generate at gpt-j widths, 2 layers, as the PPO TL;DR rollout runs it:
#: B prompts of 192-512 tokens left-padded to P, G tokens, greedy
ROLLOUT = dict(B=32, P=512, G=64)


def _rollout(dtype, kernel, monkeypatch, seed=0):
    """(generate's output, paged-decode launches of each call, telemetry
    counters) for two calls of one decoder with CUDA graphs on, its step
    attending through the kernel (``kernel``) or the plain path."""
    from trlx_tpu_torch import telemetry
    from trlx_tpu_torch.data.configs import ModelSpec
    from trlx_tpu_torch.models import generation as tg
    from trlx_tpu_torch.models.params import (
        decode_views_from_numpy,
        init_hydra_numpy,
    )
    from trlx_tpu_torch.models.transformer import tree_map

    if not kernel:
        monkeypatch.setattr(tg, "rollout_page_size", lambda *a: None)
    spec = ModelSpec(arch="gptj", vocab_size=4096, n_layer=2, n_head=16,
                     d_model=4096, rotary_dim=64, n_positions=2048,
                     tie_lm_head=False)
    views = decode_views_from_numpy(
        init_hydra_numpy(spec, num_layers_unfrozen=1, seed=seed), spec, 1)
    blocks, embed, ln_f = tree_map(
        lambda x: x.to("cuda", dtype),
        (views.blocks, views.embed, views.ln_f))
    B, P, G = ROLLOUT["B"], ROLLOUT["P"], ROLLOUT["G"]
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, spec.vocab_size, (B, P))
    mask = np.ones((B, P), np.int32)
    for b, n in enumerate(rng.integers(192, P + 1, B)):
        mask[b, :P - n] = 0
        tokens[b, :P - n] = 0
    cfg = tg.GenerationConfig.from_gen_kwargs(
        G, {"max_length": G, "min_length": G, "do_sample": False}, -1, 0, P)
    decoder = tg.RolloutDecoder()
    session = telemetry.start()
    launches = []
    try:
        for _ in range(2):
            before = ops.LAUNCHES["paged_decode"]
            out = tg.generate(
                spec, blocks, embed, ln_f, _t(tokens).to("cuda"),
                _t(mask).to("cuda"), None, cfg, compute_dtype=dtype,
                cache_dtype=dtype, decoder=decoder,
                phase_args={"chunk": 0, "rows": B})
            torch.cuda.synchronize()
            launches.append(ops.LAUNCHES["paged_decode"] - before)
        counters = dict(session.registry.counters)
    finally:
        telemetry.stop()
    assert decoder.step.signatures() == 1
    return out, launches, counters


def _agreeing(a, b, steps):
    """[B, steps] bool: the steps before each row's first token where the
    two outputs differ (their distributions follow the same prefix)."""
    same = a.gen_tokens == b.gen_tokens
    first = torch.where(same.all(1), steps, (~same).int().argmax(1))
    return torch.arange(steps, device="cuda")[None, :] < first[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_rollout_decode_through_paged_kernel(dtype, monkeypatch):
    """``generate`` at gpt-j widths (16 heads of 256), 2 layers, B 32,
    512 + 64 keys, each step a CUDA-graph replay: its attention runs the
    paged-decode kernel over the dense cache viewed as pages, one launch
    a layer a step (counted through the graph's replays too), and
    ``rollout/decode_plain_steps`` reads 0. In float32 the greedy tokens
    equal the plain path's and the logprobs lie within 2e-2 nats. In
    bf16 the plain path rounds its scores to bf16 where the kernel
    accumulates in float32, so near-ties turn greedy choices and the
    logprobs differ by a few hundredths: there both are held against
    the float32 run, and over the steps where each agrees with it the
    kernel's logprobs lie no farther from it than the plain path's (a
    tenth of the gap and 1e-3 of room)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dtype = getattr(torch, dtype)
    steps = ROLLOUT["G"]
    out, launches, counters = _rollout(dtype, True, monkeypatch)
    plain, plain_launches, plain_counters = _rollout(dtype, False,
                                                     monkeypatch)
    assert launches == [steps * 2] * 2
    assert counters["rollout/decode_kernel_steps"] == 2 * steps
    assert counters["rollout/decode_plain_steps"] == 0
    assert plain_launches == [0, 0]
    assert plain_counters["rollout/decode_plain_steps"] == 2 * steps
    if dtype == torch.float32:
        assert torch.equal(out.gen_tokens, plain.gen_tokens)
        torch.testing.assert_close(out.gen_logprobs, plain.gen_logprobs,
                                   atol=2e-2, rtol=0)
        return
    monkeypatch.undo()
    ref = _rollout(torch.float32, True, monkeypatch)[0]
    gaps = {}
    for name, o in (("kernel", out), ("plain", plain)):
        live = _agreeing(o, ref, steps)
        gaps[name] = float((o.gen_logprobs - ref.gen_logprobs)[live]
                           .abs().max())
        print(f"bf16 {name} path against float32: {int(live.sum())} "
              f"steps agree, largest logprob gap {gaps[name]:.4f}")
    assert gaps["kernel"] <= 1.1 * gaps["plain"] + 1e-3, gaps


def _flash_case(B, T, H, hd, pads, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
                  for _ in range(4))
    mask = np.ones((B, T), np.int32)
    for i, p in enumerate(pads):
        mask[i, :p] = 0
    return q, k, v, g, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,causal,pads", [
    (52, True, (0, 5, 11, 17)), (130, True, (0, 64)), (48, False, (0, 9)),
])
def test_cuda_flash_kernels_match_plain_version(dtype, T, causal, pads):
    """The three flash kernels against the dense oracle and its autograd
    on the card, left padding included (real rows for the forward; dO is
    0 on pad rows, as the trainer's losses make it, so every gradient
    compares). float32: outputs 1e-5, gradients 2e-4; bfloat16 (against
    float32 math on the same bf16 inputs): outputs and gradients
    1e-2 + rtol 1e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from trlx_tpu_torch.ops import flash_attention as fa

    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    q, k, v, g, mask = (_t(x).to(dev) for x in _flash_case(len(pads), T, 2,
                                                            64, pads))
    q, k, v = (x.to(dt) for x in (q, k, v))
    g = (g * mask[:, :, None, None]).to(dt)
    real = mask.bool()
    tol = (dict(atol=1e-5, rtol=0), dict(atol=2e-4, rtol=0)) \
        if dt == torch.float32 else (dict(atol=1e-2, rtol=1e-2),) * 2
    before = {n: ops.LAUNCHES[n] for n in
              ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, mask, causal)
    out.backward(g)
    torch.cuda.synchronize()
    for n in before:
        assert ops.LAUNCHES[n] == before[n] + 1, n
    assert torch.isfinite(out.float()).all()
    ref_leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref = fa.flash_attention_reference(*ref_leaves, mask, causal)
    ref.backward(g.float())
    torch.testing.assert_close(out.float()[real], ref.detach()[real],
                               **tol[0])
    _, lse = fa.flash_fwd(q, k, v, mask, causal)
    _, lse_ref = fa.flash_fwd_reference(q, k, v, mask, causal)
    torch.testing.assert_close(lse.permute(0, 2, 1)[real],
                               lse_ref.permute(0, 2, 1)[real], atol=1e-4,
                               rtol=1e-5)
    for a, b in zip(leaves, ref_leaves):
        torch.testing.assert_close(a.grad.float(), b.grad, **tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("T,causal,pads", [
    (130, True, (0, 130, 17)), (96, False, (0, 9)),
])
def test_cuda_float32_flash_kernels_head_dim_256(T, causal, pads):
    """The float32 flash kernels at head_dim 256, where a block owns 32
    query (or key) rows, against the dense oracle and its autograd on
    the card: O and lse on real rows at 1e-5 and 1e-4, the gradients at
    2e-4, as at hd 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from trlx_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    q, k, v, g, mask = (_t(x).to(dev) for x in _flash_case(len(pads), T, 2,
                                                            256, pads, 256))
    g = g * mask[:, :, None, None]
    real = mask.bool()
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, mask, causal)
    out.backward(g)
    torch.cuda.synchronize()
    ref_leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ref = fa.flash_attention_reference(*ref_leaves, mask, causal)
    ref.backward(g)
    torch.testing.assert_close(out[real], ref.detach()[real], atol=1e-5,
                               rtol=0)
    _, lse = fa.flash_fwd(q, k, v, mask, causal)
    _, lse_ref = fa.flash_fwd_reference(q, k, v, mask, causal)
    torch.testing.assert_close(lse.permute(0, 2, 1)[real],
                               lse_ref.permute(0, 2, 1)[real], atol=1e-4,
                               rtol=1e-5)
    for a, b in zip(leaves, ref_leaves):
        assert torch.isfinite(a.grad).all()
        torch.testing.assert_close(a.grad, b.grad, atol=2e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("T,causal,pads", [
    (130, True, (0, 130, 17)),  # ragged T, one fully left-padded row
    (96, False, (0, 9)),
])
def test_cuda_bf16_backward_kernels_match_plain_version(hd, T, causal, pads):
    """The bf16 backward kernels (wgmma, TMA) against their plain
    versions on the same bf16 q, k, v, dO, O and lse, at atol 1e-2 +
    rtol 1e-2: the kernels split P and dS into bf16 hi + lo pairs before
    the second product (2^-17 relative each) and round each output once
    to bf16, as the plain version does from its float32 sums. The dq
    kernel's D equals softmax_jacobian_diag at atol 1e-5 (float32 sums
    in another order). dO is 0 on pad rows, as the trainer's losses
    make it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from trlx_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    q, k, v, g, mask = (_t(x).to(dev) for x in _flash_case(len(pads), T, 2,
                                                            hd, pads, hd))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    g = (g * mask[:, :, None, None]).to(torch.bfloat16)
    out, lse = fa.flash_fwd(q, k, v, mask, causal)
    before = {n: ops.LAUNCHES[n] for n in ("flash_bwd_dq", "flash_bwd_dkv")}
    dq, dD = fa.flash_bwd_dq(q, k, v, g, out, lse, mask, causal)
    got = (dq, *fa.flash_bwd_dkv(q, k, v, g, lse, dD, mask, causal))
    torch.cuda.synchronize()
    for n in before:
        assert ops.LAUNCHES[n] == before[n] + 1, n
    torch.testing.assert_close(dD, fa.softmax_jacobian_diag(g, out),
                               atol=1e-5, rtol=0)
    dq_ref, d_ref = fa.flash_bwd_dq_reference(q, k, v, g, out, lse, mask,
                                              causal)
    want = (dq_ref,
            *fa.flash_bwd_dkv_reference(q, k, v, g, lse, d_ref, mask,
                                        causal))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), b.float(), atol=1e-2,
                                   rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("T,causal,pads", [
    (130, True, (0, 130, 17)),  # ragged T, one fully left-padded row
    (96, False, (0, 9)),
])
def test_cuda_bf16_forward_kernel_matches_plain_version(hd, T, causal, pads):
    """The bf16 forward kernel (wgmma, TMA) against its plain version on
    the same bf16 q, k, v: O on real rows at atol 1e-2 + rtol 1e-2 (the
    kernel rounds P to bf16 before P V, 2^-9 relative, and O once), lse
    on real rows at atol 1e-3 (float32 sums in another order), every row
    of O and lse finite, one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from trlx_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    q, k, v, _, mask = (_t(x).to(dev) for x in _flash_case(len(pads), T, 2,
                                                            hd, pads, hd + 1))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    real = mask.bool()
    before = ops.LAUNCHES["flash_fwd"]
    out, lse = fa.flash_fwd(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_fwd"] == before + 1
    ref, lse_ref = fa.flash_fwd_reference(q, k, v, mask, causal)
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out.float()[real], ref.float()[real],
                               atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse.permute(0, 2, 1)[real],
                               lse_ref.permute(0, 2, 1)[real], atol=1e-3,
                               rtol=0)


@pytest.mark.cuda
def test_cuda_bf16_backward_refuses_misaligned_rows():
    """The bf16 kernels copy 16-byte rows, so the wrappers of the forward
    and of both backward kernels raise on a tensor that does not start
    16-byte aligned rather than launch: a forward input 2 bytes off
    raises and no forward launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from trlx_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    q, k, v, g, mask = (_t(x).to(dev) for x in _flash_case(1, 64, 1, 16,
                                                            (0,)))
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:]
    shifted = shifted.view(q.shape).copy_(q)  # contiguous, 2 bytes off
    before = ops.LAUNCHES["flash_fwd"]
    for args in ((shifted, k, v), (q, shifted, v), (q, k, shifted)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_fwd(*args, mask)
    assert ops.LAUNCHES["flash_fwd"] == before
    out, lse = fa.flash_fwd(q, k, v, mask)
    dD = fa.softmax_jacobian_diag(g, out)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_bwd_dq(shifted, k, v, g, out, lse, mask)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_bwd_dkv(shifted, k, v, g, lse, dD, mask)
