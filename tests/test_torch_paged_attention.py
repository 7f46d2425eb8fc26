"""The port's paged-decode attention module (trlx_tpu_torch.ops
.paged_attention) against trlx_tpu's Pallas kernel run through the
Pallas interpreter: the plain version on the ``_kernel_case`` geometry
(GQA, sentinel pages, ragged lengths) with a bf16-stored pool and with
the int8 tier, the wrapper's CPU dispatch and its device check; the
split-K kernel's algebra (partitions, page skipping, the fixed-order
combine) emulated in torch at float32, and a block-by-block model of the
cluster merge (each partition's mode and (m, l, acc), each block's share
of the columns merged in partition order), with the direct ring's every
page against the compact ring's used pages; the partition planner, the
least shared memory a block takes, the dealing of ring stages to
consumer warps under the kernel's mbarrier waits, and the C entry's
signature.
The CUDA kernel itself runs only on the card
(tests/test_torch_cuda_kernels.py, ``cuda`` marker; skipped here)."""

import itertools
import random
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda_kernels import SENT, _kernel_case, _split_case, _t
from trlx_tpu.models.transformer import quantize_kv as jax_quantize_kv
from trlx_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention,
)
from trlx_tpu_torch import ops
from trlx_tpu_torch.models.transformer import (
    NEG_INF,
    _rsqrt_scale,
    dequantize_kv,
    quantize_kv,
)
from trlx_tpu_torch.ops import paged_attention as pa
from trlx_tpu_torch.ops.paged_attention import (
    decode_partitions,
    make_paged_decode_fn,
    paged_decode_attention,
    paged_decode_attention_reference,
)


def test_plain_matches_pallas_kernel_bf16_pool():
    """bf16-stored pages, f32 queries: the plain version equals the TPU
    kernel (interpret mode) to 1e-5."""
    q, k, v, pt, bias = _kernel_case()
    kb = jnp.asarray(k, jnp.bfloat16)
    vb = jnp.asarray(v, jnp.bfloat16)
    ref = jax_paged_decode_attention(
        jnp.asarray(q), kb.astype(jnp.float32), vb.astype(jnp.float32),
        jnp.asarray(pt), jnp.asarray(bias), interpret=True,
    )
    out = paged_decode_attention_reference(
        _t(q), _t(k).to(torch.bfloat16), _t(v).to(torch.bfloat16), _t(pt),
        _t(bias),
    )
    assert out.dtype == torch.float32 and out.shape == (3, 4, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_plain_matches_pallas_kernel_int8_pool():
    """int8 codes + f32 scales, dequantized at the gather: equal to the
    TPU kernel's in-kernel dequant, and the port's quantizer gives the
    JAX quantizer's codes and scales."""
    q, k, v, pt, bias = _kernel_case(seed=1)
    kc, ks = quantize_kv(_t(k))
    vc, vs = quantize_kv(_t(v))
    jkc, jks = jax_quantize_kv(jnp.asarray(k))
    np.testing.assert_array_equal(kc.numpy(), np.asarray(jkc))
    np.testing.assert_allclose(ks.numpy(), np.asarray(jks), rtol=1e-6)
    ref = jax_paged_decode_attention(
        jnp.asarray(q), jax_quantize_kv(jnp.asarray(k)),
        jax_quantize_kv(jnp.asarray(v)), jnp.asarray(pt),
        jnp.asarray(bias), interpret=True,
    )
    out = paged_decode_attention_reference(_t(q), (kc, ks), (vc, vs),
                                           _t(pt), _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_plain_matches_pallas_kernel_head_dim_256(H, Hkv):
    """gpt-j-6B's head dim (and a GQA variant): the plain version at hd
    256, with sentinel pages and ragged lengths, equals the TPU kernel in
    interpret mode at 1e-5, for a float32 pool and for the int8 tier."""
    rng = np.random.default_rng(256 + Hkv)
    S, hd, num_pages, page_size, max_pages = 3, 256, 8, 4, 3
    q = rng.standard_normal((S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((num_pages, page_size, Hkv, hd))
            .astype(np.float32) for _ in range(2))
    pt = np.asarray([[1, 3, SENT], [0, SENT, SENT], [5, 6, 7]], np.int32)
    lengths = np.asarray([6, 3, 12])
    bias = np.where(np.arange(max_pages * page_size)[None, :]
                    < lengths[:, None], 0.0, NEG_INF).astype(np.float32)
    ref = jax_paged_decode_attention(*map(jnp.asarray, (q, k, v, pt, bias)),
                                     interpret=True)
    out = paged_decode_attention(*map(_t, (q, k, v, pt, bias)))
    assert out.shape == (S, H, hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    ref8 = jax_paged_decode_attention(
        jnp.asarray(q), jax_quantize_kv(jnp.asarray(k)),
        jax_quantize_kv(jnp.asarray(v)), jnp.asarray(pt), jnp.asarray(bias),
        interpret=True)
    out8 = paged_decode_attention(_t(q), quantize_kv(_t(k)),
                                  quantize_kv(_t(v)), _t(pt), _t(bias))
    np.testing.assert_allclose(out8.numpy(), np.asarray(ref8), atol=1e-5)
    assert 256 in pa.HEAD_DIMS


def test_cpu_wrapper_runs_plain_version_and_counts_nothing():
    """A CPU tensor goes to the plain version — and only a launch on the
    card counts as one."""
    q, k, v, pt, bias = _kernel_case(seed=2)
    ops.reset_launches()
    fn = make_paged_decode_fn()
    out = fn(_t(q), _t(k), _t(v), _t(pt), _t(bias))
    ref = paged_decode_attention_reference(_t(q), _t(k), _t(v), _t(pt),
                                           _t(bias))
    assert torch.equal(out, ref)
    assert ops.LAUNCHES["paged_decode"] == 0


def test_fully_masked_row_is_finite():
    """A free slot's row (every position masked, sentinel table) comes
    out finite: the finite NEG_INF bias makes it a uniform average."""
    q, k, v, pt, bias = _kernel_case(seed=3)
    pt[1] = SENT
    bias[1] = NEG_INF
    out = paged_decode_attention(_t(q), _t(k), _t(v), _t(pt), _t(bias))
    assert torch.isfinite(out).all()


def test_wrapper_refuses_other_devices():
    q, k, v, pt, bias = _kernel_case()
    with pytest.raises(ValueError, match="unsupported device"):
        paged_decode_attention(_t(q).to("meta"), _t(k), _t(v), _t(pt),
                               _t(bias))


def _split_k(q, k_pages, v_pages, page_table, bias, partitions=None):
    """The split-K kernel's algebra in float32 torch: the context cut into
    ``partitions`` parts of whole pages (the planner's count by default);
    pages with no unmasked position skipped only when the row has one;
    per part the running (max, sum, accumulator) over its kept tokens
    (max -1e30 and sum 0 when it keeps none); the parts merged in order."""
    (k_codes, k_scales), (v_codes, v_scales) = (
        pa._split(k_pages), pa._split(v_pages))
    S, H, hd = q.shape
    num_pages, ps, Hkv, _ = k_codes.shape
    max_pages = page_table.shape[1]
    ctx = page_table.long().clamp(0, num_pages - 1)
    if k_scales is not None:
        k = dequantize_kv(k_codes[ctx], k_scales[ctx], q.dtype)
        v = dequantize_kv(v_codes[ctx], v_scales[ctx], q.dtype)
    else:
        k, v = k_codes[ctx].to(q.dtype), v_codes[ctx].to(q.dtype)
    G, T = H // Hkv, max_pages * ps
    k = k.float().reshape(S, T, Hkv, hd).repeat_interleave(G, dim=2)
    v = v.float().reshape(S, T, Hkv, hd).repeat_interleave(G, dim=2)
    x = torch.einsum("shd,sthd->sht", q.float(), k) * _rsqrt_scale(hd) \
        + bias[:, None, :]
    live = bias > -5e8
    page_live = live.reshape(S, max_pages, ps).any(-1)
    keep = ~live.any(-1, keepdim=True) | page_live.repeat_interleave(ps, -1)
    if partitions is None:
        partitions, per = decode_partitions(S, Hkv, max_pages, ps)
    else:
        per = -(-max_pages // partitions)
    parts = []
    for p in range(partitions):
        span = slice(p * per * ps, min(T, (p + 1) * per * ps))
        xp = torch.where(keep[:, None, span], x[..., span], -float("inf"))
        m = torch.clamp(xp.max(-1).values, min=-1e30)
        e = torch.exp(xp - m[..., None])
        parts.append((m, e.sum(-1), torch.einsum("sht,sthd->shd", e,
                                                  v[:, span])))
    M = torch.stack([m for m, _, _ in parts]).max(0).values
    L = sum(l * torch.exp(m - M) for m, l, _ in parts)
    A = sum(a * torch.exp(m - M)[..., None] for m, _, a in parts)
    return A / L.clamp(min=1e-30)[..., None]


@pytest.mark.parametrize("pool,partitions", [
    ("float32", None), ("float32", 3), ("int8", None), ("int8", 5),
])
def test_split_k_algebra_matches_plain_version(pool, partitions):
    """The split-K algebra equals the plain version at atol 1e-5 in
    float32 on a 64-page context: GQA (H 8, Hkv 2), lengths at and beside
    partition edges, rows whose later partitions are all dead, and a
    fully masked free row (the uniform average over every position)."""
    q, k, v, pt, bias = (_t(x) for x in _split_case())
    if pool == "int8":
        k, v = quantize_kv(k), quantize_kv(v)
    if partitions is None:
        assert decode_partitions(5, 2, 64, 16) == (8, 8)
    out = _split_k(q, k, v, pt, bias, partitions)
    ref = paged_decode_attention_reference(q, k, v, pt, bias)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("partitions", [2, 3])
def test_split_k_algebra_matches_pallas_kernel(partitions):
    """The same algebra on tests/test_paged_kernel.py's geometry (GQA,
    sentinels, ragged lengths) against the TPU kernel in interpret mode,
    with the 3 pages cut into 2 or 3 partitions. No free row here: the
    TPU kernel reads a sentinel's page as page 0, the plain version as
    the last page, so a fully masked row averages other rows."""
    q, k, v, pt, bias = _kernel_case(seed=4)
    ref = jax_paged_decode_attention(
        *map(jnp.asarray, (q, k, v, pt, bias)), interpret=True)
    out = _split_k(*map(_t, (q, k, v, pt, bias)), partitions)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_partition_planner():
    """One partition at the serving shape; several at a 1024-token
    context; at most 8 (a portable cluster), the longer partitions
    instead at one slot's 4096-token stream; always whole pages, none
    empty, none shorter than the planner's floor unless the context is,
    and a split grid within one wave of ``_BLOCKS_PER_SM`` blocks an
    SM."""
    assert decode_partitions(16, 12, 4, 16) == (1, 4)
    P, per = decode_partitions(16, 12, 64, 16)
    assert P > 1 and (P - 1) * per < 64 <= P * per
    assert decode_partitions(1, 12, 256, 16) == (8, 32)
    for S, Hkv, max_pages, ps in itertools.product(
            (1, 4, 16, 64), (1, 2, 12), (1, 3, 4, 17, 64, 256), (1, 8, 16)):
        P, per = decode_partitions(S, Hkv, max_pages, ps)
        assert 1 <= P <= min(max_pages, pa._MAX_PARTITIONS)
        assert (P - 1) * per < max_pages <= P * per
        if P > 1:
            assert per * ps >= pa._MIN_PART_TOKENS
            assert S * Hkv * P <= pa._BLOCKS_PER_SM * pa._SMS


def test_shared_memory_bytes():
    """The least a block takes, a ring of one stage (a page's K and V
    rows of one kv-head, each a 128-byte aligned TMA box, its bias words
    and the int8 tier's scales) after the barriers, two words a page, the
    partition's bias words and the four consumer warps' and the block's
    (m, l, acc) rows per head of the head group (4, 2 or 1 heads of a
    kv-head); every planned shape within one Hopper block's 232,448
    bytes, and the largest pages beyond it refused before a launch."""
    # the serving shape: 1648 B before the ring, a stage of 2 x 2048 B
    # of rows and 64 B of bias words (4224 B), 128 B of alignment room
    assert pa.shared_memory_bytes(12, 12, 64, 16, 4) == 6000
    # head groups of 4 and 2: the (m, l, acc) rows grow with the group
    assert pa.shared_memory_bytes(8, 2, 64, 16, 4) == 9952
    assert pa.shared_memory_bytes(12, 2, 64, 16, 4) == 7312
    # the int8 tier at gpt-j's width: 256-byte rows, scales in the stage
    assert pa.shared_memory_bytes(16, 16, 256, 16, 4, torch.int8) == 14064
    # a page of 4 rows of 16 bytes: each box still starts 128-byte aligned
    assert pa.shared_memory_bytes(4, 2, 16, 4, 3, torch.int8) == 1344
    for S, H, Hkv, hd, max_pages, dt in itertools.product(
            (1, 16), (16,), (16, 4), (64, 256), (4, 64, 256),
            (torch.bfloat16, torch.float32, torch.int8)):
        P, per = decode_partitions(S, Hkv, max_pages, 16)
        assert pa.shared_memory_bytes(H, Hkv, hd, 16, per, dt) <= \
            pa._SMEM_LIMIT
    assert pa.shared_memory_bytes(16, 16, 256, 256, 1, torch.float32) > \
        pa._SMEM_LIMIT


def _ring_run(n_pages, stages, units, seed):
    """The ring's protocol under one random interleaving: a producer
    issuing page j into stage j mod stages once the stage's empty barrier
    has completed the phase of page j - stages, copies landing in any
    order and completing the stage's full barrier, and the consumer warps
    of each stage (unit c of stage st is warp (st units + c) mod 4's)
    waiting on its full barrier by phase parity, as try_wait.parity does,
    then arriving on its empty barrier (count min(units, 4)). Returns
    "ok", or how it failed: a wait that passed on a page not yet landed,
    or no actor able to move."""
    rng = random.Random(seed)
    full, empty, arrived = [0] * stages, [0] * stages, [0] * stages
    content, flight, issued = [None] * stages, [], 0
    takers = min(units, 4)
    work = {w: [j for j in range(n_pages)
                if w in {(j % stages * units + c) % 4 for c in range(units)}]
            for w in range(4)}
    done = {w: 0 for w in range(4)}
    while True:
        moves = []
        if issued < n_pages:
            st = issued % stages
            if issued < stages or empty[st] % 2 != (issued // stages - 1) % 2:
                moves.append(("issue", None))
        if flight:
            moves.append(("land", None))
        for w in range(4):
            if done[w] < len(work[w]):
                j = work[w][done[w]]
                if full[j % stages] % 2 != (j // stages) % 2:
                    moves.append(("read", w))
        if not moves:
            finished = issued == n_pages and all(
                done[w] == len(work[w]) for w in range(4))
            return "ok" if finished and not flight else "stuck"
        kind, w = rng.choice(moves)
        if kind == "issue":
            content[issued % stages] = None
            flight.append(issued)
            issued += 1
        elif kind == "land":
            j = flight.pop(rng.randrange(len(flight)))
            content[j % stages] = j
            full[j % stages] += 1
        else:
            j = work[w][done[w]]
            if content[j % stages] != j:
                return f"warp {w} read page {j} before it landed"
            done[w] += 1
            arrived[j % stages] += 1
            if arrived[j % stages] == takers:
                arrived[j % stages] = 0
                empty[j % stages] += 1


@pytest.mark.parametrize("units", [1, 2, 3, 4, 8])
def test_ring_dealing_model(units):
    """The ring with the kernel's dealing of stages to consumer warps
    (every stage always the same warps, so each waits for every phase of
    its stages in order) neither deadlocks nor reads a page before it
    lands, for any depth, under random interleavings: the direct ring
    (no more pages than stages) and the compact one that wraps. A page
    of 16 rows is 1 unit of a warp's round at hd 64, 4 at hd 256."""
    for n_pages, stages, seed in itertools.product(
            (1, 3, 7, 22, 33), (1, 2, 3, 4, 6, 8, 16), range(3)):
        assert _ring_run(n_pages, stages, units, seed) == "ok", (
            n_pages, stages, seed)


def test_c_entry_signature_matches_binding():
    """The ctypes binding's argument types follow the C entry point's
    parameters one by one (pointers, ints, the float scale, the stream):
    a mismatch passes garbage rather than failing."""
    src = (Path(pa.__file__).resolve().parents[1] / "csrc" /
           "paged_decode.cu").read_text()
    m = re.search(r'extern "C" int paged_decode_attention\((.*?)\)\s*\{',
                  src, re.S)
    kinds = []
    for param in m.group(1).split(","):
        param = param.strip()
        kinds.append("p" if "*" in param else
                     ("f" if param.startswith("float") else "i"))
    lib = types.SimpleNamespace(paged_decode_attention=types.SimpleNamespace())
    fn = pa._bind(lib)
    code = {pa.ctypes.c_void_p: "p", pa.ctypes.c_int: "i",
            pa.ctypes.c_float: "f"}
    assert [code[t] for t in fn.argtypes] == kinds
    assert "partials" not in m.group(1)


def _cluster_decode(q, k_pages, v_pages, page_table, bias, partitions=None,
                    direct=False):
    """The kernel block by block, in float32 torch: partition p of a
    (slot, head group) holds pages [p per, (p + 1) per); with the compact
    ring its mode comes from its own bias words and the cluster's flags
    (its live pages; none when it has none and another partition has
    one; every page when the row is free), with the ``direct`` ring it
    uses every page; it folds the used pages' positions into (m, l, acc)
    per head (m at least -1e30, l 0 with no position); then block p of
    the cluster merges its share of the head group's GT x hd output
    columns from every partition's row, in partition order. Every column
    is written by exactly one block."""
    (k_codes, k_scales), (v_codes, v_scales) = (
        pa._split(k_pages), pa._split(v_pages))
    S, H, hd = q.shape
    num_pages, ps, Hkv, _ = k_codes.shape
    max_pages = page_table.shape[1]
    ctx = page_table.long().clamp(0, num_pages - 1)
    if k_scales is not None:
        k = dequantize_kv(k_codes[ctx], k_scales[ctx], q.dtype)
        v = dequantize_kv(v_codes[ctx], v_scales[ctx], q.dtype)
    else:
        k, v = k_codes[ctx].to(q.dtype), v_codes[ctx].to(q.dtype)
    G, T = H // Hkv, max_pages * ps
    k = k.float().reshape(S, T, Hkv, hd).repeat_interleave(G, dim=2)
    v = v.float().reshape(S, T, Hkv, hd).repeat_interleave(G, dim=2)
    x = torch.einsum("shd,sthd->sht", q.float(), k) * _rsqrt_scale(hd) \
        + bias[:, None, :]
    page_live = (bias > -5e8).reshape(S, max_pages, ps).any(-1)
    if partitions is None:
        partitions, per = decode_partitions(S, Hkv, max_pages, ps)
    else:
        per = -(-max_pages // partitions)
    spans = [range(p * per, min(max_pages, (p + 1) * per))
             for p in range(partitions)]
    flags = torch.stack([page_live[:, list(sp)].any(-1) for sp in spans])
    rows = []  # per partition: (m [S, H], l [S, H], acc [S, H, hd])
    for p, sp in enumerate(spans):
        others = torch.cat([flags[:p], flags[p + 1:]]).any(0)
        mode = torch.where(flags[p], 1, torch.where(others, 0, 2))  # [S]
        if direct:
            mode = torch.full_like(mode, 2)
        used = torch.zeros(S, max_pages, dtype=torch.bool)
        used[:, list(sp)] = (mode[:, None] == 2) | (
            (mode[:, None] == 1) & page_live[:, list(sp)])
        keep = used.repeat_interleave(ps, -1)[:, None, :]
        xp = torch.where(keep, x, -float("inf"))
        m = torch.clamp(xp.max(-1).values, min=-1e30)
        e = torch.exp(xp - m[..., None])
        rows.append((m, e.sum(-1), torch.einsum("sht,sthd->shd", e, v)))
    gt = pa._head_group(H, Hkv)
    n_cols = gt * hd
    share = -(-n_cols // partitions)
    out = torch.full((S, H // gt, n_cols), float("nan"))
    for blk in range(partitions):
        cols = torch.arange(blk * share, min(n_cols, (blk + 1) * share))
        g, d = cols // hd, cols % hd
        heads = torch.arange(H // gt)[:, None] * gt + g[None, :]
        M = torch.full((S,) + tuple(heads.shape), -1e30)
        for m, _, _ in rows:
            M = torch.maximum(M, m[:, heads])
        L = torch.zeros_like(M)
        A = torch.zeros_like(M)
        for m, l, acc in rows:  # partition order
            f = torch.exp(m[:, heads] - M)
            L = L + l[:, heads] * f
            A = A + acc[:, heads, d[None, :].expand_as(heads)] * f
        assert torch.isnan(out[:, :, cols]).all()  # written once
        out[:, :, cols] = A / L.clamp(min=1e-30)
    assert not torch.isnan(out).any()
    return out.reshape(S, H, hd)


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("partitions", [None, 1, 3, 8])
def test_cluster_merge_matches_plain_version(pool, partitions):
    """The cluster merge model equals the plain version at atol 1e-5 in
    float32 on a 64-page context, for every pool tier: GQA (H 8, Hkv 2),
    lengths at and beside partition edges, rows whose later partitions
    are dead, and a fully masked free row (the uniform average)."""
    q, k, v, pt, bias = (_t(x) for x in _split_case())
    if pool == "int8":
        k, v = quantize_kv(k), quantize_kv(v)
    elif pool == "bfloat16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    out = _cluster_decode(q, k, v, pt, bias, partitions)
    ref = paged_decode_attention_reference(q, k, v, pt, bias)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("partitions", [1, 2, 3])
def test_cluster_merge_matches_pallas_kernel(partitions):
    """The cluster merge model on tests/test_paged_kernel.py's geometry
    (GQA, sentinels, ragged lengths) against the TPU kernel in interpret
    mode, the 3 pages cut into 1, 2 or 3 partitions (no free row, as in
    test_split_k_algebra_matches_pallas_kernel)."""
    q, k, v, pt, bias = _kernel_case(seed=5)
    ref = jax_paged_decode_attention(
        *map(jnp.asarray, (q, k, v, pt, bias)), interpret=True)
    out = _cluster_decode(*map(_t, (q, k, v, pt, bias)), partitions)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("partitions", [None, 1, 3, 8])
def test_direct_ring_matches_compact_ring(pool, partitions):
    """The direct ring reads every page of a partition, the dead ones
    (sentinels past a slot's length, whole dead partitions) with their
    -1e9 bias, where the compact ring skips them: once a row's running
    max is a live score their share underflows to exactly 0, so the
    cluster merge model gives the same bits either way, and the plain
    version's result at atol 1e-5 (free row included)."""
    q, k, v, pt, bias = (_t(x) for x in _split_case())
    if pool == "int8":
        k, v = quantize_kv(k), quantize_kv(v)
    elif pool == "bfloat16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    direct = _cluster_decode(q, k, v, pt, bias, partitions, direct=True)
    compact = _cluster_decode(q, k, v, pt, bias, partitions)
    assert torch.equal(direct, compact)
    ref = paged_decode_attention_reference(q, k, v, pt, bias)
    torch.testing.assert_close(direct, ref, atol=1e-5, rtol=0)
