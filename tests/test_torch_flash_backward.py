"""The port's flash backward on the CPU: dq returns D = rowsum(dO * O)
beside dq, the seam launches dq then dk/dv and nothing else, the ring
takes D from each rank's first dq call, and the bf16 backward kernels'
host-side plan (shared memory, TMA tensor maps) obeys Hopper's limits.

The plain versions run here (CPU tensors never launch a kernel) against
trlx_tpu's Pallas ``_flash_backward`` in interpret mode, as
tests/test_pallas_attention.py runs it, on the same numpy inputs and the
same O and lse (JAX's forward's): dq, dk, dv at atol 2e-4 in float32, D
at atol 1e-5 against numpy. The hand-written kernels themselves run on
a card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.pallas_attention import _flash_backward, _flash_forward
from trlx_tpu_torch import ops
from trlx_tpu_torch.ops import flash_attention as fa
from trlx_tpu_torch.ops import ring_attention as ra

#: (T, block, left pads, causal): tests/test_pallas_attention.py's cases
CASES = [(32, 16, (), True), (48, 16, (), True), (52, 16, (), True),
         (64, 32, (), True), (32, 16, (0, 5, 11, 17), True),
         (32, 16, (0, 9), False)]


def _case(seed, B, T, H, hd, pads=()):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
                  for _ in range(4))
    mask = np.ones((B, T), np.int32)
    for i, p in enumerate(pads):
        mask[i, :p] = 0
    return q, k, v, g, mask


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("T,block,pads,causal", CASES)
def test_plain_dq_returns_d_and_matches_jax_backward(T, block, pads, causal):
    """flash_bwd_dq takes O and returns (dq, D): D is
    softmax_jacobian_diag's, and dq (then dk, dv from that D) equal
    trlx_tpu's interpret-mode backward given the same O and lse. dO is 0
    on left-pad rows, as the trainers' losses make it: a pad row sees
    only -1e9 keys, so its probabilities rest on float32 sums near -1e9
    that the two sides round in another order."""
    B = max(2, len(pads))
    q, k, v, g, mask = _case(40 + T, B, T, 2, 16, pads)
    g *= mask[:, :, None, None]
    jq, jk, jv, jg, jm = map(jnp.asarray, (q, k, v, g, mask))
    out, lse = _flash_forward(jq, jk, jv, jm, block, block, causal)
    want = _flash_backward((jq, jk, jv, jm, out, lse), jg, block, block,
                           causal)[:3]
    out, lse = np.asarray(out), np.asarray(lse)[..., :T]
    tq, tk, tv, tg, to, tl, tm = _t(q, k, v, g, out, lse, mask)
    ops.reset_launches()
    dq, dD = fa.flash_bwd_dq(tq, tk, tv, tg, to, tl, tm, causal)
    assert dD.dtype == torch.float32 and dD.shape == (B, 2, T)
    torch.testing.assert_close(dD, fa.softmax_jacobian_diag(tg, to),
                               atol=0, rtol=0)
    np.testing.assert_allclose(dD.numpy(),
                               (g * out).sum(-1).transpose(0, 2, 1),
                               atol=1e-5, rtol=0)
    dk, dv = fa.flash_bwd_dkv(tq, tk, tv, tg, tl, dD, tm, causal)
    for name, ours, theirs in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=2e-4, rtol=0, err_msg=name)
    assert all(n == 0 for n in ops.LAUNCHES.values())


@pytest.mark.parametrize("causal", [True, False])
def test_seam_backward_runs_dq_then_dkv_only(monkeypatch, causal):
    """FlashAttention.backward calls exactly flash_bwd_dq (with O) and
    then flash_bwd_dkv with the D dq returned, and computes no D of its
    own; its gradients equal the dense oracle's autograd at atol 2e-4."""
    calls, inside = [], []
    dq_fn, dkv_fn = fa.flash_bwd_dq, fa.flash_bwd_dkv
    jacobian = fa.softmax_jacobian_diag

    def dq(*args):
        calls.append("dq")
        inside.append(True)
        result = dq_fn(*args)
        inside.pop()
        calls.append(result[1])
        return result

    def dkv(q, k, v, g, lse, dD, mask, causal):
        calls.append(("dkv", dD))
        return dkv_fn(q, k, v, g, lse, dD, mask, causal)

    def plain_d(*args):  # the plain dq's own D, never the seam's
        assert inside, "the seam computed D outside dq"
        return jacobian(*args)

    monkeypatch.setattr(fa, "flash_bwd_dq", dq)
    monkeypatch.setattr(fa, "flash_bwd_dkv", dkv)
    monkeypatch.setattr(fa, "softmax_jacobian_diag", plain_d)
    q, k, v, g, mask = _case(7, 2, 40, 2, 16, (0, 6))
    g *= mask[:, :, None, None]
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    tg, tm = _t(g, mask)
    fa.flash_attention(*leaves, tm, causal).backward(tg)
    monkeypatch.undo()
    assert calls[0] == "dq" and calls[2][0] == "dkv" and len(calls) == 3
    assert calls[2][1] is calls[1]
    refs = [x.requires_grad_() for x in _t(q, k, v)]
    fa.flash_attention_reference(*refs, tm, causal).backward(tg)
    for a, b in zip(leaves, refs):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=2e-4, rtol=0)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_backward_takes_d_from_the_first_dq_call(monkeypatch, sp):
    """The ring's backward runs every pair's dk/dv on the D that its
    rank's first dq call (the diagonal pair, step 0) returned, and its
    gradients equal the one-call seam's at atol 1e-4, as
    tests/test_torch_ring_attention.py holds the ring."""
    first_d, dkv_d = {}, []
    dq_fn, dkv_fn = fa.flash_bwd_dq, fa.flash_bwd_dkv

    def dq(q, *args):
        result = dq_fn(q, *args)
        first_d.setdefault(id(q), result[1])
        return result

    def dkv(q, k, v, g, lse, dD, mask, causal):
        dkv_d.append((id(q), dD))
        return dkv_fn(q, k, v, g, lse, dD, mask, causal)

    monkeypatch.setattr(fa, "flash_bwd_dq", dq)
    monkeypatch.setattr(fa, "flash_bwd_dkv", dkv)
    q, k, v, g, mask = _case(60 + sp, 2, 32, 2, 8, (0, 5))
    g *= mask[:, :, None, None]
    tg, tm = _t(g, mask)
    ring = [x.requires_grad_() for x in _t(q, k, v)]
    ra.ring_attention_loopback(*ring, tm, sp, min_fused_t=0).backward(tg)
    monkeypatch.undo()
    pairs = sp * (sp + 1) // 2  # causal: the diagonal and those below
    assert len(first_d) == sp and len(dkv_d) == pairs
    assert all(dD is first_d[key] for key, dD in dkv_d)
    seam = [x.requires_grad_() for x in _t(q, k, v)]
    fa.make_flash_attention_fn(min_fused_t=0)(*seam, tm).backward(tg)
    for a, b in zip(ring, seam):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_backward_tile_plan_fits_one_block(hd):
    """The bf16 backward kernels' plan at every head dim: the boxes cover
    the head dim, the swizzled tiles keep the 128 B swizzle's 1024 B
    period, one consumer warpgroup keeps all output columns while its
    float32 accumulators fit (dq to hd 128, dk/dv to hd 64) and two split
    them beyond, and each kernel asks for at most one Hopper block's
    232,448 bytes of shared memory (two blocks an SM where one consumer
    warpgroup leaves the registers for two)."""
    g = fa.backward_geometry(hd)
    assert g["box_cols"] * g["boxes"] == hd
    assert g["row_bytes"] == 2 * g["box_cols"] <= 128
    assert g["tile_bytes"] == fa.TILE * 2 * hd
    assert g["tile_bytes"] % 1024 == 0
    split = g["split"]
    assert split["flash_bwd_dq"] == (2 if hd == 256 else 1)
    assert split["flash_bwd_dkv"] == (1 if hd <= 64 else 2)
    sm = fa.shared_memory_bytes(hd)
    for name, n in split.items():
        assert sm[name] <= 232448, (name, sm)
        if n == 1:  # two blocks: 228 KB an SM, 1 KB reserved for each
            assert 2 * (sm[name] + 1024) <= 233472, (name, sm)


#: the main path's shapes (training, ILQL, gpt-j's TL;DR) and a ragged
#: one (T not a multiple of 4 or of the 64-row tile)
MAP_SHAPES = [(32, 576, 12), (80, 500, 12), (8, 576, 16), (3, 130, 2)]


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("B,T,H", MAP_SHAPES)
def test_tma_maps_obey_the_hardware_rules(B, T, H, hd):
    """Every tensor map the bf16 backward encodes obeys
    cuTensorMapEncodeTiled's rules: rank 1-5, dims below 2^32, global
    strides multiples of 16 bytes below 2^40, every box dim 1-256, the
    inner box a multiple of 16 bytes and, under a swizzle, no wider than
    it (at most 128 bytes); the 4-D maps' boxes are whole 64-row tiles."""
    for name, m in fa.tma_maps(B, T, H, hd).items():
        dims, box, strides = m["dims"], m["box"], m["strides"]
        assert 1 <= len(dims) <= 5 and len(box) == len(dims), name
        assert len(strides) == len(dims) - 1, name
        assert all(0 < d < 2 ** 32 for d in dims), name
        assert all(s % 16 == 0 and 0 < s < 2 ** 40 for s in strides), name
        assert all(1 <= b <= 256 for b in box), name
        inner = box[0] * m["elem"]
        assert inner % 16 == 0, name
        if m["swizzle"]:
            assert m["swizzle"] in (32, 64, 128), name
            assert inner == m["swizzle"] <= 128, name
    rows = fa.tma_maps(B, T, H, hd)["q/k/v/dO/O"]
    assert rows["box"][2] == fa.TILE and rows["dims"] == (hd, H, T, B)
    assert rows["strides"][-1] == 2 * hd * H * T
