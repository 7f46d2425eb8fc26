"""The port's transformer block (trlx_tpu_torch.models.transformer) against
trlx_tpu's, from the same numpy weights and inputs at float32: dense,
dense-with-cache and paged modes (bf16 and int8 pools, decode through the
paged_decode_fn seam, prefix-suffix writes with sentinel pages and
past-the-table drops) across the four arch families, GQA included.
Tolerance 2e-4, as tests/test_hf_parity.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelSpec as JaxSpec
from trlx_tpu.models import transformer as jt
from trlx_tpu_torch.data.configs import ModelSpec
from trlx_tpu_torch.models import transformer as tt
from trlx_tpu_torch.models.params import init_hydra_numpy
from trlx_tpu_torch.ops.paged_attention import make_paged_decode_fn

ATOL = 2e-4
SENT = 2**30

SPECS = {
    "gpt2": dict(arch="gpt2", vocab_size=257, n_layer=2, n_head=4,
                 d_model=32, n_positions=32),
    "gptj": dict(arch="gptj", vocab_size=257, n_layer=2, n_head=4,
                 d_model=32, n_positions=32, rotary_dim=4,
                 tie_lm_head=False),
    "gptneox": dict(arch="gptneox", vocab_size=257, n_layer=2, n_head=4,
                    d_model=32, n_positions=32, tie_lm_head=False),
    "llama_gqa": dict(arch="llama", vocab_size=257, n_layer=2, n_head=4,
                      n_kv_heads=2, d_model=32, n_positions=32,
                      tie_lm_head=False),
}


def _layer0(name, seed=0):
    """(jax spec, torch spec, numpy layer-0 params) — every leaf jittered
    so biases and norm scales are not trivially 0 / 1."""
    spec = ModelSpec(**SPECS[name])
    rng = np.random.default_rng(seed)
    tree = init_hydra_numpy(spec, -1, seed)["trainable"]["blocks"]
    p = tt.tree_map(
        lambda x: (x[0] + 0.05 * rng.standard_normal(x[0].shape)).astype(
            np.float32), tree)
    return JaxSpec(**SPECS[name]), spec, p


def _jax(p):
    return tt.tree_map(jnp.asarray, p)


def _torch(p):
    return tt.tree_map(lambda x: torch.from_numpy(np.asarray(x).copy()), p)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_block_dense_and_cached_match_jax(name):
    jspec, spec, p = _layer0(name)
    rng = np.random.default_rng(1)
    B, T, D = 2, 6, spec.d_model
    h = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, :2] = 0  # left padding
    jflags, tflags = jt.ArchFlags.for_spec(jspec), tt.ArchFlags.for_spec(spec)

    jbias = jt.causal_mask_bias(jnp.asarray(mask))
    jpos = jt.positions_from_mask(jnp.asarray(mask))
    tbias = tt.causal_mask_bias(torch.from_numpy(mask))
    tpos = tt.positions_from_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(tpos.numpy(), _np(jpos))
    np.testing.assert_array_equal(tbias.numpy(), _np(jbias))
    ref, _ = jt.block_apply(jspec, jflags, _jax(p), jnp.asarray(h), jbias,
                            jpos)
    out, _ = tt.block_apply(spec, tflags, _torch(p), torch.from_numpy(h),
                            tbias, tpos)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL)

    # dense-with-cache: T fresh tokens written at offset 2 of a 10-slot
    # buffer, attending over the whole (otherwise masked) buffer
    Tb, off = 10, 2
    buf = rng.standard_normal((B, Tb, spec.kv_heads, spec.head_dim))
    buf = buf.astype(np.float32)
    allowed = np.zeros((B, 1, T, Tb), np.float32) + tt.NEG_INF
    for t in range(T):
        allowed[:, 0, t, :off + t + 1] = 0.0
    ref, (jk, jv) = jt.block_apply(
        jspec, jflags, _jax(p), jnp.asarray(h), jnp.asarray(allowed), jpos,
        kv_cache=(jnp.asarray(buf), jnp.asarray(buf)),
        cache_offset=jnp.int32(off),
    )
    kc, vc = torch.from_numpy(buf.copy()), torch.from_numpy(buf.copy())
    out, (tk, tv) = tt.block_apply(
        spec, tflags, _torch(p), torch.from_numpy(h),
        torch.from_numpy(allowed), tpos, kv_cache=(kc, vc),
        cache_offset=off,
    )
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), _np(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), atol=ATOL)


def _paged_case(spec, rng, num_pages=6, page_size=3):
    pool = rng.standard_normal(
        (num_pages, page_size, spec.kv_heads, spec.head_dim)
    ).astype(np.float32)
    return pool


def _torch_pool(pool, int8=False):
    """numpy [np, ps, Hkv, hd] -> the port's pool with its drop page."""
    t = torch.from_numpy(pool.copy())
    t = torch.cat([t, torch.zeros_like(t[:1])])
    if int8:
        return tt.quantize_kv(t)
    return t.to(torch.bfloat16)


def _jax_pool(pool, int8=False):
    if int8:
        return jt.quantize_kv(jnp.asarray(pool))
    return jnp.asarray(pool, jnp.bfloat16)


def _pool_np(entry, num_pages):
    if isinstance(entry, (tuple, list)):
        return tuple(_pool_np(x, num_pages) for x in entry)
    if torch.is_tensor(entry):
        return entry[:num_pages].float().numpy()
    return np.asarray(entry.astype(jnp.float32))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", ["gpt2", "llama_gqa"])
def test_block_paged_prefix_write_matches_jax(name, int8):
    """Paged mode, T > 1: rows write a suffix at a page-aligned start
    through their tables (one row's tail runs onto a sentinel page, one
    row past the table extent), then attend over the gathered context.
    Outputs and every real pool page agree with JAX's ``mode="drop"``."""
    jspec, spec, p = _layer0(name, seed=2)
    rng = np.random.default_rng(3)
    num_pages, ps, max_pages = 6, 3, 3
    B, T, D = 3, 4, spec.d_model
    T_buf = max_pages * ps
    h = rng.standard_normal((B, T, D)).astype(np.float32)
    pool_k, pool_v = _paged_case(spec, rng), _paged_case(spec, rng)
    pt = np.asarray([[0, 2, 4], [1, 3, SENT], [5, SENT, SENT]], np.int32)
    start = np.asarray([0, 3, 6], np.int32)  # row 2 runs past the table
    positions = start[:, None] + np.arange(T)[None, :]
    allowed = np.arange(T_buf)[None, None, :] <= positions[:, :, None]
    bias = np.where(allowed, 0.0, tt.NEG_INF).astype(np.float32)[:, None]

    jflags, tflags = jt.ArchFlags.for_spec(jspec), tt.ArchFlags.for_spec(spec)
    ref, (jk, jv) = jt.block_apply(
        jspec, jflags, _jax(p), jnp.asarray(h), jnp.asarray(bias),
        jnp.asarray(positions),
        kv_cache=(_jax_pool(pool_k, int8), _jax_pool(pool_v, int8)),
        cache_row_offsets=jnp.asarray(start), page_table=jnp.asarray(pt),
        page_size=ps,
    )
    out, (tk, tv) = tt.block_apply(
        spec, tflags, _torch(p), torch.from_numpy(h), torch.from_numpy(bias),
        torch.from_numpy(positions),
        kv_cache=(_torch_pool(pool_k, int8), _torch_pool(pool_v, int8)),
        cache_row_offsets=torch.from_numpy(start),
        page_table=torch.from_numpy(pt), page_size=ps,
    )
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL)
    for mine, theirs in ((tk, jk), (tv, jv)):
        mine, theirs = _pool_np(mine, num_pages), _pool_np(theirs, num_pages)
        if int8:
            np.testing.assert_array_equal(mine[0], theirs[0].astype(np.int8))
            np.testing.assert_allclose(mine[1], theirs[1], rtol=1e-6)
        else:
            np.testing.assert_allclose(mine, theirs, atol=ATOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", ["gpt2", "llama_gqa"])
def test_block_paged_decode_seam_matches_jax(name, int8):
    """Paged decode, T == 1: per-row offsets (one row non-emitting at the
    sentinel), through the paged_decode_fn seam (the plain version on the
    CPU) and through the plain gather — both equal JAX's jnp path."""
    jspec, spec, p = _layer0(name, seed=4)
    rng = np.random.default_rng(5)
    num_pages, ps, max_pages = 6, 3, 3
    B, D = 3, spec.d_model
    T_buf = max_pages * ps
    h = rng.standard_normal((B, 1, D)).astype(np.float32)
    pool_k, pool_v = _paged_case(spec, rng), _paged_case(spec, rng)
    pt = np.asarray([[0, 2, 4], [1, 3, SENT], [num_pages] * 3], np.int32)
    off = np.asarray([7, 4, 2], np.int32)
    valid = np.arange(T_buf)[None, :] <= off[:, None]
    valid[2] = False
    bias = np.where(valid, 0.0, tt.NEG_INF).astype(np.float32)
    bias = bias[:, None, None, :]
    pos = off[:, None]

    jflags, tflags = jt.ArchFlags.for_spec(jspec), tt.ArchFlags.for_spec(spec)
    ref, (jk, _) = jt.block_apply(
        jspec, jflags, _jax(p), jnp.asarray(h), jnp.asarray(bias),
        jnp.asarray(pos),
        kv_cache=(_jax_pool(pool_k, int8), _jax_pool(pool_v, int8)),
        cache_row_offsets=jnp.asarray(off), page_table=jnp.asarray(pt),
        page_size=ps,
    )
    for fn in (None, make_paged_decode_fn()):
        out, (tk, _) = tt.block_apply(
            spec, tflags, _torch(p), torch.from_numpy(h),
            torch.from_numpy(bias), torch.from_numpy(pos),
            kv_cache=(_torch_pool(pool_k, int8), _torch_pool(pool_v, int8)),
            cache_row_offsets=torch.from_numpy(off),
            page_table=torch.from_numpy(pt), page_size=ps,
            paged_decode_fn=fn,
        )
        np.testing.assert_allclose(out[:2].numpy(), _np(ref)[:2], atol=ATOL)
        mine, theirs = _pool_np(tk, num_pages), _pool_np(jk, num_pages)
        if int8:
            np.testing.assert_array_equal(mine[0], theirs[0].astype(np.int8))
        else:
            np.testing.assert_allclose(mine, theirs, atol=ATOL)


def test_embed_logits_and_quantize_match_jax():
    jspec, spec = JaxSpec(**SPECS["gptj"]), ModelSpec(**SPECS["gptj"])
    tree = init_hydra_numpy(spec, -1, 7)
    embed = dict(tree["frozen_base"]["embed"],
                 lm_head=tree["trainable"]["lm_head"])
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 257, (2, 5)).astype(np.int32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    h_j = jt.embed_tokens(_jax(embed), jspec, jnp.asarray(tokens),
                          jnp.asarray(pos), jnp.float32)
    h_t = tt.embed_tokens(_torch(embed), spec, torch.from_numpy(tokens),
                          torch.from_numpy(pos), torch.float32)
    np.testing.assert_allclose(h_t.numpy(), _np(h_j), atol=ATOL)
    ln = {k: v for k, v in tree["trainable"]["ln_f"].items()}
    lj = jt.lm_logits(_jax(embed), _jax(ln), jspec, h_j)
    lt = tt.lm_logits(_torch(embed), _torch(ln), spec, h_t)
    assert lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), _np(lj), atol=ATOL)
    x = rng.standard_normal((4, 3, 16)).astype(np.float32) * 3
    x[1] = 0.0
    jc, js = jt.quantize_kv(jnp.asarray(x))
    tc, ts = tt.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), _np(jc))
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=1e-6)
    np.testing.assert_allclose(
        tt.dequantize_kv(tc, ts, torch.float32).numpy(),
        _np(jt.dequantize_kv(jc, js, jnp.float32)), atol=1e-6,
    )
