"""The port's ring attention (trlx_tpu_torch.ops.ring_attention) run as
an in-process ring (every sp rank in this process, the loopback
exchange) on the CPU, where each block pair runs the flash kernels'
plain versions, against trlx_tpu.ops.ring_attention's shard_map ring
on the 8 virtual CPU devices, from the same numpy inputs at float32:
values at atol 1e-5 (real query rows only where rows are left-padded:
both rings give a row that sees only padding a different meaningless
mix), gradients at atol 1e-4 as tests/test_ring_attention.py holds
trlx_tpu's ring to dense attention; causal and not, sp 2 / 4 / 8, GQA
(the port carries the compact K/V; trlx_tpu's ring takes it repeated),
the refusals, and the launch counters (CPU tensors never launch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.ring_attention import ring_attention as jax_ring
from trlx_tpu.parallel import build_mesh
from trlx_tpu_torch import ops
from trlx_tpu_torch.ops import ring_attention as ra
from trlx_tpu_torch.ops.flash_attention import flash_attention_reference


def _case(seed, B, T, H, hd, Hkv=None, pads=()):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, Hkv or H, hd)).astype(np.float32)
            for _ in range(2))
    mask = np.ones((B, T), np.int32)
    for i, p in enumerate(pads):
        mask[i, :p] = 0
    return q, k, v, mask


def _repeat(x, H):
    return np.repeat(x, H // x.shape[2], axis=2)


def _jax_out(q, k, v, mask, sp, causal=True, **kw):
    mesh = build_mesh({"dp": -1, "sp": sp})
    H = q.shape[2]
    return np.asarray(jax_ring(*map(jnp.asarray, (q, _repeat(k, H),
                                                  _repeat(v, H), mask)),
                               mesh, causal=causal, **kw))


def _jax_grads(q, k, v, mask, w, sp, causal=True):
    """Gradients of sum(ring(q, k, v) * w) w.r.t. q and the compact k, v
    (the repeat's transpose sums each group)."""
    mesh = build_mesh({"dp": -1, "sp": sp})
    H = q.shape[2]
    jm, jw = jnp.asarray(mask), jnp.asarray(w)

    def loss(q, k, v):
        g = H // k.shape[2]
        kr, vr = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
        return (jax_ring(q, kr, vr, jm, mesh, causal=causal) * jw).sum()

    return [np.asarray(x) for x in jax.jit(jax.grad(
        loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))]


def _port(q, k, v, mask, sp, causal=True, grad_w=None, **kw):
    tq, tk, tv = (torch.from_numpy(x.copy()).requires_grad_(grad_w
                                                            is not None)
                  for x in (q, k, v))
    out = ra.ring_attention_loopback(tq, tk, tv, torch.from_numpy(mask),
                                     sp, causal=causal, **kw)
    if grad_w is None:
        return out.detach().numpy(), None
    (out * torch.from_numpy(grad_w)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (tq, tk, tv)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [2, 4, 8])
def test_ring_matches_trlx_tpu(devices, sp, causal):
    q, k, v, mask = _case(sp, 2, 32, 2, 8)
    ops.reset_launches()
    out, _ = _port(q, k, v, mask, sp, causal)
    np.testing.assert_allclose(out, _jax_out(q, k, v, mask, sp, causal),
                               atol=1e-5, rtol=0)
    assert all(n == 0 for n in ops.LAUNCHES.values())


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_ring_gradients_match_trlx_tpu(devices, sp):
    q, k, v, mask = _case(10 + sp, 2, 32, 2, 8)
    w = np.random.default_rng(sp).standard_normal(q.shape).astype(np.float32)
    out, grads = _port(q, k, v, mask, sp, grad_w=w)
    np.testing.assert_allclose(out, _jax_out(q, k, v, mask, sp), atol=1e-5,
                               rtol=0)
    for name, ours, theirs in zip("qkv", grads,
                                  _jax_grads(q, k, v, mask, w, sp)):
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_left_padding_real_rows_and_gradients(devices, causal):
    """Rows of left padding, as rollouts have them: real query rows agree,
    and with the upstream gradient zero on pad rows (the losses never
    read them) every gradient agrees, so a pad row's meaningless block
    mix does no harm in the backward."""
    sp = 4
    q, k, v, mask = _case(3, 4, 16, 2, 8, pads=(0, 3, 7, 11))
    real = mask.astype(bool)
    w = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    w = w * real[:, :, None, None]
    out, grads = _port(q, k, v, mask, sp, causal, grad_w=w)
    ref = _jax_out(q, k, v, mask, sp, causal)
    np.testing.assert_allclose(out[real], ref[real], atol=1e-5, rtol=0)
    assert np.isfinite(out).all()
    for name, ours, theirs in zip("qkv", grads,
                                  _jax_grads(q, k, v, mask, w, sp, causal)):
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0,
                                   err_msg=name)
        assert np.isfinite(ours).all()


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_gqa_carries_the_compact_kv(devices, sp):
    """H 4 over Hkv 2: the ring carries [B, Tc, 2, hd] chunks and repeats
    them per pair; dK / dV come back compact, summed over each group."""
    q, k, v, mask = _case(20 + sp, 2, 32, 4, 8, Hkv=2, pads=(5,))
    real = mask.astype(bool)
    w = np.random.default_rng(sp).standard_normal(q.shape).astype(np.float32)
    w = w * real[:, :, None, None]
    out, grads = _port(q, k, v, mask, sp, grad_w=w)
    assert grads[1].shape == k.shape and grads[2].shape == v.shape
    np.testing.assert_allclose(out[real],
                               _jax_out(q, k, v, mask, sp)[real],
                               atol=1e-5, rtol=0)
    for name, ours, theirs in zip("qkv", grads,
                                  _jax_grads(q, k, v, mask, w, sp)):
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0,
                                   err_msg=name)


def test_ring_matches_the_dense_oracle_with_a_sub_block(devices):
    """trlx_tpu's sub-blocked hops (sub_block 8 over chunks of 32): the
    port takes the knob and its kernels tile the chunk themselves; both
    equal dense attention on real rows."""
    q, k, v, mask = _case(7, 2, 64, 2, 8, pads=(0, 9))
    real = mask.astype(bool)
    out, _ = _port(q, k, v, mask, 2, sub_block=8)
    ref = _jax_out(q, k, v, mask, 2, sub_block=8)
    dense = flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v, mask))).numpy()
    np.testing.assert_allclose(out[real], ref[real], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out[real], dense[real], atol=1e-5, rtol=0)


def test_ring_rejects_indivisible_seq(devices):
    q = np.zeros((1, 6, 2, 8), np.float32)
    mask = np.ones((1, 6), np.int32)
    with pytest.raises(ValueError, match="not divisible") as ours:
        _port(q, q, q, mask, 4)
    with pytest.raises(ValueError, match="not divisible") as theirs:
        _jax_out(q, q, q, mask, 4)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="sub_block"):
        _port(q[:, :4], q[:, :4], q[:, :4], mask[:, :4], 4, sub_block=0)


def test_ring_without_gradient_records_nothing(devices):
    q, k, v, mask = _case(8, 2, 16, 2, 8)
    tq = torch.from_numpy(q).requires_grad_(True)
    with torch.no_grad():
        out = ra.ring_attention_loopback(
            tq, torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(mask), 4)
    assert out.grad_fn is None
    np.testing.assert_allclose(out.numpy(), _jax_out(q, k, v, mask, 4),
                               atol=1e-5, rtol=0)


def test_ring_pairs_skip_the_upper_triangle():
    """Causal: rank r runs r + 1 block pairs (its diagonal and the chunks
    before it), sp (sp + 1) / 2 in all; non-causal: sp * sp."""
    calls = []

    def fwd(q, k, v, mask, causal):
        calls.append(causal)
        from trlx_tpu_torch.ops.flash_attention import flash_fwd_reference

        return flash_fwd_reference(q, k, v, mask, causal)

    q, k, v, mask = _case(9, 1, 16, 2, 8)
    for causal, want in ((True, 10), (False, 16)):
        calls.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ra, "_pair_ops", lambda Tc, floor: (fwd, None, None))
            ra.ring_attention_loopback(*(torch.from_numpy(x)
                                         for x in (q, k, v, mask)), 4,
                                       causal=causal)
        assert len(calls) == want
        assert calls.count(True) == (4 if causal else 0)
