"""The port's flash attention on the CPU — the kernels' plain versions
behind the autograd seam — against trlx_tpu's Pallas flash attention in
interpret mode, on tests/test_pallas_attention.py's cases (inputs drawn
with numpy and fed to both): T = 32 / 48 / 52 / 64, unequal JAX blocks,
left padding (real rows only: tile skipping changes pad rows), the
non-causal form, gradients; and the seam's dense fallback below
``min_fused_t``. Outputs at atol 1e-5, gradients at atol 2e-4, float32;
bfloat16 gradients at atol 1e-2 + rtol 1e-2. A torch model of the bf16
forward kernel's rounding (P rounded to bf16 per 64-key tile, online
rescaling), and one of the backward kernels' (dS and P split into bf16
hi + lo pairs for the second products) on ILQL's right-padded,
terminal-holed layout, are held to the same bound against the plain
versions, so the card's tolerance is known before the card runs. The hand-written kernels
themselves run in tests/test_torch_cuda_kernels.py on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.pallas_attention import flash_attention as jax_flash
from trlx_tpu_torch import ops
from trlx_tpu_torch.ops import flash_attention as fa


def _case(seed, B, T, H, hd, pads=()):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((B, T), np.int32)
    for i, p in enumerate(pads):
        mask[i, :p] = 0
    return q, k, v, mask


def _torch(*xs, grad=False):
    return [torch.from_numpy(x.copy()).requires_grad_(grad) for x in xs]


@pytest.mark.parametrize("T,block,pads", [
    (32, 16, ()), (64, 32, ()), (48, 16, ()),
    (52, 16, ()),  # T not a block multiple
    (32, 16, (0, 5, 11, 17)),  # left padding
])
def test_forward_matches_jax_flash(T, block, pads):
    B = max(2, len(pads))
    q, k, v, mask = _case(T, B, T, 2, 16, pads)
    ref = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v, mask)),
                               block, block))
    real = mask.astype(bool)
    fn = fa.make_flash_attention_fn(min_fused_t=0)
    out = fn(*_torch(q, k, v, mask)).numpy()
    np.testing.assert_allclose(out[real], ref[real], atol=1e-5, rtol=0)
    plain, lse = fa.flash_fwd_reference(*_torch(q, k, v, mask))
    np.testing.assert_allclose(plain.numpy()[real], ref[real], atol=1e-5,
                               rtol=0)
    assert np.isfinite(lse.numpy()).all()
    dense = fa.flash_attention_reference(*_torch(q, k, v, mask)).numpy()
    np.testing.assert_allclose(dense[real], ref[real], atol=1e-5, rtol=0)
    assert ops.LAUNCHES["flash_fwd"] == 0  # CPU tensors never launch


@pytest.mark.parametrize("T,bq,bk", [
    (32, 16, 16), (52, 16, 16), (32, 16, 8), (32, 8, 16),
])
def test_gradients_match_jax_flash(T, bq, bk):
    q, k, v, mask = _case(100 + T, 2, T, 2, 16)
    mask[1, :7] = 0
    jm = jnp.asarray(mask)

    def loss_jax(q, k, v):
        out = jax_flash(q, k, v, jm, bq, bk)
        return ((out * jm[:, :, None, None]) ** 2).sum()

    gj = jax.grad(loss_jax, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _torch(q, k, v, grad=True)
    tm = torch.from_numpy(mask)
    out = fa.flash_attention(tq, tk, tv, tm)
    ((out * tm[:, :, None, None]) ** 2).sum().backward()
    for t, j in zip((tq, tk, tv), gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=2e-4,
                                   rtol=0)


@pytest.mark.parametrize("T,block,causal", [
    (32, 16, True), (52, 16, True), (48, 16, False),
])
def test_bf16_gradients_match_jax_flash(T, block, causal):
    """The same numpy inputs cast to bfloat16 on both sides; the port's
    seam returns bf16 dq, dk, dv matching JAX's interpret-mode flash at
    atol 1e-2 + rtol 1e-2: both sides round float32 sums once to bf16
    and both take D = rowsum(dO * O) over the bf16-rounded O, so they
    differ by the order of float32 sums and, where that moves an
    element across a rounding boundary, one bf16 step (2^-8 relative)."""
    q, k, v, mask = _case(200 + T, 2, T, 2, 16)
    mask[1, :7] = 0
    q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jm = jnp.asarray(mask)

    def loss_jax(q, k, v):
        out = jax_flash(q, k, v, jm, block, block, causal)
        return ((out.astype(jnp.float32) * jm[:, :, None, None]) ** 2).sum()

    gj = jax.grad(loss_jax, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
              .requires_grad_() for x in (q, k, v)]
    tm = torch.from_numpy(mask)
    fn = fa.make_flash_attention_fn(min_fused_t=0, causal=causal)
    out = fn(*leaves, tm)
    ((out.float() * tm[:, :, None, None]) ** 2).sum().backward()
    for t, j in zip(leaves, gj):
        assert t.grad.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(j, np.float32), atol=1e-2,
                                   rtol=1e-2)
    assert ops.LAUNCHES["flash_bwd_dq"] == ops.LAUNCHES["flash_bwd_dkv"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_return_q_dtype(dtype):
    """On CPU tensors the wrappers run the plain versions, which return
    O, dq, dk and dv in q's dtype (float32 math inside) and lse float32,
    the kernels' contract."""
    q, k, v, mask = _case(8, 2, 24, 2, 16, (0, 5))
    g = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv, tg = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    tm = torch.from_numpy(mask)
    out, lse = fa.flash_fwd(tq, tk, tv, tm)
    dq, dD = fa.flash_bwd_dq(tq, tk, tv, tg, out, lse, tm)
    dk, dv = fa.flash_bwd_dkv(tq, tk, tv, tg, lse, dD, tm)
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    assert lse.dtype == dD.dtype == torch.float32
    torch.testing.assert_close(dD, fa.softmax_jacobian_diag(tg, out),
                               atol=0, rtol=0)
    for x in (out, dq, dk, dv):
        assert x.shape == tq.shape and torch.isfinite(x.float()).all()
    dq32, _ = fa.flash_bwd_dq_reference(
        *(x.float() for x in (tq, tk, tv, tg)), out, lse, tm)
    torch.testing.assert_close(dq.float(), dq32.to(dtype).float(), atol=0,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_256_matches_jax_flash(causal):
    """gpt-j-6B's head dim: the seam's plain versions at hd 256, left
    padding and a ragged T against JAX's Pallas flash attention in
    interpret mode, on the same numpy inputs: O on real rows at atol
    1e-5, gradients at atol 2e-4 (dO zero on pad rows), float32."""
    q, k, v, mask = _case(256 + causal, 2, 40, 2, 256, (0, 7))
    jm = jnp.asarray(mask)
    real = mask.astype(bool)

    def loss_jax(q, k, v):
        out = jax_flash(q, k, v, jm, 16, 16, causal)
        return ((out * jm[:, :, None, None]) ** 2).sum(), out

    (_, ref), gj = jax.value_and_grad(loss_jax, argnums=(0, 1, 2),
                                      has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _torch(q, k, v, grad=True)
    tm = torch.from_numpy(mask)
    out = fa.make_flash_attention_fn(min_fused_t=0, causal=causal)(
        tq, tk, tv, tm)
    np.testing.assert_allclose(out.detach().numpy()[real],
                               np.asarray(ref)[real], atol=1e-5, rtol=0)
    ((out * tm[:, :, None, None]) ** 2).sum().backward()
    for t, j in zip((tq, tk, tv), gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=2e-4,
                                   rtol=0)


def test_shared_memory_fits_one_block_at_every_head_dim():
    """Every kernel instance, both dtypes, hd 16-256, asks for at most one
    Hopper block's 232,448 bytes of shared memory; at hd 256 the float32
    kernels own 32 rows a block (four 64-row tiles of 257 floats would
    not fit), the bf16 forward keeps its two consumers' 64-row Q tiles
    and two stages of K and V, and the bf16 backward its one 64-row
    slice."""
    for hd in fa.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            sm = fa.shared_memory_bytes(hd, dtype)
            assert max(sm.values()) <= 232448, (hd, dtype, sm)
    assert fa.fma_rows(256) == 32 and fa.fma_rows(128) == 64
    sm = fa.shared_memory_bytes(256, torch.bfloat16)
    assert (sm["flash_fwd"], sm["flash_bwd_dq"], sm["flash_bwd_dkv"]) == \
        (198216, 198440, 198696)
    sm = fa.shared_memory_bytes(256, torch.float32)
    assert (sm["flash_fwd"], sm["flash_bwd_dq"], sm["flash_bwd_dkv"]) == \
        (173056, 206080, 214528)


def test_non_causal_matches_jax_flash():
    q, k, v, mask = _case(4, 2, 32, 2, 16, (0, 9))
    ref = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v, mask)), 16, 16,
                               False))
    tq, tk, tv = _torch(q, k, v, grad=True)
    tm = torch.from_numpy(mask)
    out = fa.flash_attention(tq, tk, tv, tm, False)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=0)
    out.square().sum().backward()
    dq, dk, dv = (t.grad.clone() for t in (tq, tk, tv))
    for t in (tq, tk, tv):
        t.grad = None
    fa.flash_attention_reference(tq, tk, tv, tm, False).square().sum() \
        .backward()
    for a, t in zip((dq, dk, dv), (tq, tk, tv)):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), atol=2e-4,
                                   rtol=0)


def test_seam_dense_fallback_gqa_and_no_grad():
    """Below min_fused_t the seam is the dense path; above it a GQA K/V is
    repeated to H heads (gradients summed back over each group); under
    no_grad nothing is recorded."""
    q, _, _, mask = _case(5, 2, 24, 4, 16, (0, 3))
    rng = np.random.default_rng(6)
    k, v = (rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv, tm = _torch(q, k, v, mask)
    dense = fa.flash_attention_reference(tq, tk, tv, tm)
    out = fa.make_flash_attention_fn()(tq, tk, tv, tm)  # 24 < 128
    np.testing.assert_array_equal(out.numpy(), dense.numpy())

    real = mask.astype(bool)
    tq, tk, tv = _torch(q, k, v, grad=True)
    out = fa.make_flash_attention_fn(min_fused_t=0)(tq, tk, tv, tm)
    np.testing.assert_allclose(out.detach().numpy()[real],
                               dense.numpy()[real], atol=1e-5, rtol=0)
    (out * tm[:, :, None, None]).square().sum().backward()
    grads = [t.grad.clone() for t in (tq, tk, tv)]
    for t in (tq, tk, tv):
        t.grad = None
    (fa.flash_attention_reference(tq, tk, tv, tm) * tm[:, :, None, None]) \
        .square().sum().backward()
    for a, t in zip(grads, (tq, tk, tv)):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), atol=2e-4,
                                   rtol=0)
    with torch.no_grad():
        out = fa.make_flash_attention_fn(min_fused_t=0)(tq, tk, tv, tm)
    assert out.grad_fn is None


def test_wrappers_refuse_bad_inputs():
    q, k, v, mask = _torch(*_case(7, 1, 8, 1, 16)[:3], np.ones((1, 8),
                                                               np.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_fwd(q.to("meta"), k, v, mask)
    for dtype in (torch.float32, torch.bfloat16):
        sm = fa.shared_memory_bytes(128, dtype)
        assert max(sm.values()) <= 232448  # one Hopper block's ceiling
    # bf16: 1 KB of alignment in each; in the forward the one consumer's
    # Q tile, four stages of K, V and the key mask, the barriers; in the
    # backward the block's own 64 rows (Q, dO; K, V) and four stages of
    # the streamed 64-row tiles and rows, dq's D, the barriers
    sm = fa.shared_memory_bytes(64, torch.bfloat16)
    assert (sm["flash_fwd"], sm["flash_bwd_dq"], sm["flash_bwd_dkv"]) == \
        (75912, 84296, 85064)
    # float32: [64][65] float tiles, score tiles and row vectors
    sm = fa.shared_memory_bytes(64, torch.float32)
    assert (sm["flash_fwd"], sm["flash_bwd_dkv"]) == (66816, 100352)


def _bf16_forward_model(q, k, v, mask, causal):
    """The bf16 forward kernel's rounding in float32 torch: per 64-row
    query tile, 64-key tiles in order (those wholly above the diagonal
    skipped), S = Q K^T over the bf16 inputs times scale plus the bias,
    the running max from -1e30, P = exp(S - m) rounded to bf16 before
    P V while the row sum takes P unrounded, O = acc / max(l, 1e-30)
    rounded once to bf16, lse = m + log(l)."""
    B, T, H, hd = q.shape
    qf, kf, vf = (x.float() for x in (q, k, v))
    key_bias = torch.where(mask > 0, 0.0, fa.NEG_INF).float()  # [B, T]
    out = torch.empty(B, T, H, hd)
    lse = torch.empty(B, H, T)
    n = -(-T // fa.TILE)
    for iq in range(n):
        rows = slice(iq * fa.TILE, min(T, (iq + 1) * fa.TILE))
        m = torch.full((B, H, rows.stop - rows.start), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, rows.stop - rows.start, hd)
        for jt in range(min(n, iq + 1) if causal else n):
            keys = slice(jt * fa.TILE, min(T, (jt + 1) * fa.TILE))
            s = torch.einsum("bqhd,bkhd->bhqk", qf[:, rows], kf[:, keys]) \
                * fa.flash_scale(hd) + key_bias[:, None, None, keys]
            if causal and jt == iq:
                qpos = torch.arange(rows.start, rows.stop)[:, None]
                kpos = torch.arange(keys.start, keys.stop)[None, :]
                s = s + torch.where(qpos < kpos, fa.NEG_INF, 0.0)
            m_new = torch.maximum(m, s.max(-1).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), vf[:, keys])
            m = m_new
        l = l.clamp(min=1e-30)
        out[:, rows] = (acc / l[..., None]).permute(0, 2, 1, 3)
        lse[..., rows] = m + torch.log(l)
    return out.to(torch.bfloat16), lse


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("T,causal,pads", [
    (130, True, (0, 130, 17)),  # ragged T, one fully left-padded row
    (96, False, (0, 9)),
])
def test_bf16_forward_rounding_model_within_tolerance(hd, T, causal, pads):
    """The bf16 forward kernel's rounding, modelled in torch, stays inside
    the bound the card checks it to against the plain version on the same
    bf16 inputs: O on real rows at largest |err| / (1e-2 + 1e-2 |ref|)
    <= 1 (here below 0.6), lse on real rows at atol 1e-3, every row
    finite (the fully left-padded row too)."""
    q, k, v, mask = _case(300 + hd + T, len(pads), T, 2, hd, pads)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    tm = torch.from_numpy(mask)
    out, lse = _bf16_forward_model(q, k, v, tm, causal)
    ref, lse_ref = fa.flash_fwd_reference(q, k, v, tm, causal)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    real = tm.bool()
    err = (out.float() - ref.float())[real].abs()
    assert (err / (1e-2 + 1e-2 * ref.float()[real].abs())).max() < 0.6
    torch.testing.assert_close(lse.permute(0, 2, 1)[real],
                               lse_ref.permute(0, 2, 1)[real], atol=1e-3,
                               rtol=0)


def _bf16_backward_model(q, k, v, g, lse, dD, mask, causal, split):
    """The bf16 backward kernels' rounding in float32 torch: S, dP, P and
    dS as the plain versions form them, then the second products (dS K,
    P^T dO, dS^T Q) over dS and P either split into a bf16 pair hi + lo,
    as the kernels run them, or rounded once to bf16 (``split`` False);
    outputs rounded once to bf16."""
    def operand(x):
        hi = x.to(torch.bfloat16).float()
        return hi + (x - hi).to(torch.bfloat16).float() if split else hi

    scale = fa.flash_scale(q.shape[-1])
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    p, _ = fa._probs(qf, kf, mask, causal, lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = operand(p * (dp - dD[..., None]))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", operand(p), gf)
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def test_bf16_backward_rounding_model_within_tolerance():
    """The bf16 backward kernels' rounding, modelled in torch on ILQL's
    layout (right-padded rows, the terminal key masked, T 500 not a tile
    multiple; dO 0 past each row's end), against the plain versions on
    the same bf16 inputs and the same lse and D: dq, dk, dv at largest
    |err| / (1e-2 + 1e-2 |ref|) below 0.5 with dS and P split into bf16
    hi + lo, and below what rounding them once gives, every value
    finite."""
    B, T, H, hd = 3, 500, 2, 64
    rng = np.random.default_rng(11)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, T, H, hd))
                                   .astype(np.float32)).to(torch.bfloat16)
                  for _ in range(4))
    mask = torch.zeros((B, T), dtype=torch.int32)
    for i, n in enumerate((500, 257, 131)):
        mask[i, :n - 1] = 1
        g[i, n:] = 0
    out, lse = fa.flash_fwd_reference(q, k, v, mask)
    dD = fa.softmax_jacobian_diag(g, out)
    ref = (fa.flash_bwd_dq_reference(q, k, v, g, out, lse, mask)[0],
           *fa.flash_bwd_dkv_reference(q, k, v, g, lse, dD, mask))

    def ratios(split):
        got = _bf16_backward_model(q, k, v, g, lse, dD, mask, True, split)
        assert all(torch.isfinite(x.float()).all() for x in got)
        return [((a.float() - b.float()).abs()
                 / (1e-2 + 1e-2 * b.float().abs())).max().item()
                for a, b in zip(got, ref)]

    split, once = ratios(True), ratios(False)
    assert max(split) < 0.5, split
    assert all(s < o for s, o in zip(split, once)), (split, once)
