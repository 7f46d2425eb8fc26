"""The port's paged-decode attention module (trlx_tpu_torch.ops
.paged_attention) against trlx_tpu's Pallas kernel run through the
Pallas interpreter: the plain version on the ``_kernel_case`` geometry
(GQA, sentinel pages, ragged lengths) with a bf16-stored pool and with
the int8 tier, the wrapper's CPU dispatch and its device check; the
split-K kernel's algebra (partitions, page skipping, the fixed-order
combine) emulated in torch at float32, and its partition planner. The
CUDA kernel itself runs only on the card (tests/test_torch_cuda_kernels.py,
``cuda`` marker; skipped here)."""

import itertools

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
    """One partition (one launch) at the serving shape; several at a
    1024-token context; always whole pages, none empty, and none shorter
    than the planner's floor unless the context is."""
    assert decode_partitions(16, 12, 4, 16) == (1, 4)
    P, per = decode_partitions(16, 12, 64, 16)
    assert P > 1 and (P - 1) * per < 64 <= P * per
    for S, Hkv, max_pages, ps in itertools.product(
            (1, 4, 16, 64), (1, 2, 12), (1, 3, 4, 17, 64, 256), (1, 8, 16)):
        P, per = decode_partitions(S, Hkv, max_pages, ps)
        assert 1 <= P <= max_pages
        assert (P - 1) * per < max_pages <= P * per
        if P > 1:
            assert per * ps >= pa._MIN_PART_TOKENS
            assert S * Hkv * (P - 1) < pa._BLOCKS_PER_SM * pa._SMS


def test_shared_memory_bytes():
    """q rows of the head group (4, 2 or 1 heads of a kv-head), each
    warp's merge row per head, and two ints per page of the partition
    (csrc/paged_decode.cu ``launch``)."""
    row = {(12, 12): 1, (8, 2): 4, (12, 2): 2, (6, 2): 1}
    for (H, Hkv), gt in row.items():
        assert pa.shared_memory_bytes(H, Hkv, 64, 4) == \
            4 * (gt * 64 + 4 * gt * 66) + 32
    assert pa.shared_memory_bytes(8, 2, 128, 8) == \
        4 * (4 * 128 + 4 * 4 * 130) + 64
    # hd 256: gpt-j-6B's serving shape (G 1) and a GQA head group of 4,
    # at the serving context and a split 1024-token one, under one
    # Hopper block's 232,448 bytes
    assert pa.shared_memory_bytes(16, 16, 256, 4) == \
        4 * (256 + 4 * 258) + 32
    for H, Hkv in ((16, 16), (16, 4)):
        for max_pages in (4, 64):
            per = decode_partitions(16, Hkv, max_pages, 16)[1]
            assert pa.shared_memory_bytes(H, Hkv, 256, per) <= \
                pa._SMEM_LIMIT
