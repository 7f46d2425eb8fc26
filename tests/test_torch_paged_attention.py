"""The port's paged-decode attention module (trlx_tpu_torch.ops
.paged_attention) against trlx_tpu's Pallas kernel run through the
Pallas interpreter: the plain version on the ``_kernel_case`` geometry
(GQA, sentinel pages, ragged lengths) with a bf16-stored pool and with
the int8 tier, the wrapper's CPU dispatch and its device check. The
CUDA kernel itself runs only on the card (tests/test_torch_cuda_kernels.py,
``cuda`` marker; skipped here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda_kernels import SENT, _kernel_case, _t
from trlx_tpu.models.transformer import quantize_kv as jax_quantize_kv
from trlx_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention,
)
from trlx_tpu_torch import ops
from trlx_tpu_torch.models.transformer import NEG_INF, quantize_kv
from trlx_tpu_torch.ops.paged_attention import (
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
