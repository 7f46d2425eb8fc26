"""Flash attention for training: the hand-written Hopper kernels, their
plain versions and the autograd seam (port of
trlx_tpu.ops.pallas_attention).

Three kernels live in ``csrc/flash_attention.cu`` (built at first use):

- :func:`flash_fwd` — O and the float32 logsumexp; replaces
  ``_flash_fwd_kernel`` (launched by ``_flash_forward``);
- :func:`flash_bwd_dq` — dq from the saved logsumexp; replaces
  ``_flash_bwd_dq_kernel``;
- :func:`flash_bwd_dkv` — dk and dv; replaces ``_flash_bwd_dkv_kernel``
  (both launched by ``_flash_backward``).

Each takes q, k, v (and dO) as [B, T, H, hd] in float32 or bfloat16, the
raw key mask [B, T] int32 (1 = real), ``causal``; lse and
D = rowsum(dO * O) are float32 [B, H, T]; O and the gradients come back
in q's dtype, rounded once from float32 sums. The bias is the TPU
kernels': 0 / ``NEG_INF`` from the mask plus ``NEG_INF`` above the
diagonal, scale 1 / sqrt(hd).

What bounds them on an H100: at the training shape (B 32, T 576, H 12,
hd 64, bf16) device memory would allow each about 34-51 µs, but a
kernel that stages 64 x 64 tiles and multiplies them is held by how fast
it feeds its products. For bfloat16 all three therefore run on the
tensor cores (``mma.sync`` m16n8k16, bf16 operands by ``ldmatrix``,
float32 sums in registers), with tiles filled by double-buffered 16-byte
``cp.async`` and P and dS kept in registers as the second product's A
operand; the forward also runs its online softmax in registers and keeps
Q's fragments there for the whole key loop. Their tensors must start
16-byte aligned, which the wrappers check. For float32 the kernels stay
on the CUDA cores in full float32: the tensor cores would round to TF32
and miss the float32 parity.

At hd 256 (gpt-j-6B's heads) two changes keep each kernel on one block
of the card's 227 KB of shared memory and under its 255 registers a
thread: the bf16 kernels run 8 warps, a pair of warps per 16 query (or
key) rows, each of the pair keeping the float32 accumulators of half the
head dim (both form the rows' whole scores, so both hold the same
softmax statistics); the float32 kernels own 32 rows a block instead of
64 (:func:`fma_rows`).

A CUDA tensor goes to the kernel, or the call raises; only a CPU tensor
goes to the plain version beside it (``*_reference``), which repeats the
same math densely. The kernels skip key tiles wholly above the diagonal,
so a left-pad query row (which sees only masked keys) comes out as a
different finite average than the dense math gives; real rows agree.
:func:`flash_attention_reference` is the dense oracle
(``causal_mask_bias`` + ``attention_scores``) the tests and the chip
smoke hold the kernels against.

:class:`FlashAttention` wires the three into autograd; under
``torch.no_grad`` (the frozen trunk, the reference branch, rollout
scoring) :func:`flash_attention` calls the forward alone and saves
nothing. :func:`make_flash_attention_fn` is the trunk's ``attention_fn``
seam (``make_pallas_attention_fn``); given a mesh it runs the kernels on
each process's rows and heads (:func:`_on_mesh`).
"""

import ctypes

import torch

from trlx_tpu_torch.models.transformer import (
    NEG_INF,
    attention_scores,
    causal_mask_bias,
)
from trlx_tpu_torch.ops import count_launch

#: below this sequence length the seam runs dense attention, as the JAX
#: package's forced runs do (tests set it to 0 on both sides)
_MIN_FUSED_T = 128
#: query rows / keys per tile of the kernels
TILE = 64
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_scale(hd: int) -> float:
    """The kernels' softmax scale, 1 / sqrt(hd) as the TPU wrapper takes
    it (a Python float rounded once to float32 in the kernel)."""
    return 1.0 / (hd ** 0.5)


def fma_rows(hd: int) -> int:
    """Rows of a float32 kernel block's own tile (query rows in the
    forward and dq, key rows in dk/dv): 64, or 32 at hd 256, where four
    [64][hd + 1] float tiles would not fit one block."""
    return 64 if hd <= 128 else 32


def shared_memory_bytes(hd: int, dtype=torch.bfloat16) -> dict:
    """Dynamic shared memory per block of each kernel for inputs of
    ``dtype`` (``*_smem`` in csrc/flash_attention.cu). For float32 each
    kernel holds [hd + 1]-float rows of its own tiles (:func:`fma_rows`
    rows: Q in the forward, Q and dO in dq, K and V in dk/dv) and of the
    streamed 64-row tiles (K and V, or Q and dO), a [rows][65] score
    tile (two in dk/dv) and the row vectors. For bfloat16 the forward
    holds five [64][hd + 8] bf16 tiles (Q, then K and V x two stages) and
    two stages of the key mask; the backward six (its own two, two
    streamed tiles x two stages) and two stages of the key mask (dq) or
    of the lse and D rows (dk/dv)."""
    if dtype == torch.float32:
        own, row = fma_rows(hd), hd + 1
        streamed = 2 * TILE * row
        return {
            "flash_fwd": 4 * (own * row + streamed + own * (TILE + 1)
                              + TILE),
            "flash_bwd_dq": 4 * (2 * own * row + streamed
                                 + own * (TILE + 1) + TILE),
            "flash_bwd_dkv": 4 * (2 * own * row + streamed
                                  + 2 * own * (TILE + 1) + 2 * TILE),
        }
    bf16_tile = 2 * TILE * (hd + 8)
    return {"flash_fwd": 5 * bf16_tile + 4 * 2 * TILE,
            "flash_bwd_dq": 6 * bf16_tile + 4 * 2 * TILE,
            "flash_bwd_dkv": 6 * bf16_tile + 4 * 4 * TILE}


# --------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------- #


def _key_bias(mask: torch.Tensor, T: int, causal: bool) -> torch.Tensor:
    """[B, 1, T, T] (causal) or [B, 1, 1, T] additive float32 bias: the
    key mask's 0 / NEG_INF plus NEG_INF above the diagonal."""
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF).float()
    if causal:
        future = torch.triu(torch.ones((T, T), dtype=torch.bool,
                                       device=mask.device), diagonal=1)
        bias = bias + torch.where(future, NEG_INF, 0.0).float()
    return bias


def _probs(q, k, mask, causal, lse=None):
    """Scores with bias [B, H, T, T] and the probabilities, either
    normalised by their own logsumexp (forward) or recomputed from a
    given one (backward); q, k in float32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q * flash_scale(q.shape[-1]), k)
    s = s + _key_bias(mask, q.shape[1], causal)
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
    return torch.exp(s - lse[..., None]), lse


def flash_fwd_reference(q, k, v, mask, causal=True):
    """Plain version of the forward kernel: (O in q's dtype, lse float32
    [B, H, T])."""
    p, lse = _probs(q.float(), k.float(), mask, causal)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


def flash_bwd_dq_reference(q, k, v, g, lse, dD, mask, causal=True):
    """Plain version of the dq kernel: float32 math, [B, T, H, hd] in q's
    dtype."""
    p, _ = _probs(q.float(), k.float(), mask, causal, lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    ds = p * (dp - dD[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) \
        * flash_scale(q.shape[-1])
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, g, lse, dD, mask, causal=True):
    """Plain version of the dk/dv kernel: float32 math, [B, T, H, hd]
    each in q's dtype."""
    qs = q.float() * flash_scale(q.shape[-1])
    p, _ = _probs(q.float(), k.float(), mask, causal, lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    ds = p * (dp - dD[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_reference(q, k, v, mask, causal=True):
    """The dense oracle: ``causal_mask_bias`` (or the padding-only bias)
    plus ``attention_scores`` — what the trunk computes without the
    kernels. Differentiable by autograd; its gradients are the backward
    kernels' oracle."""
    bias = causal_mask_bias(mask) if causal else _key_bias(mask, 0, False)
    return attention_scores(q, k, v, bias)


# --------------------------------------------------------------------- #
# the kernels' wrappers
# --------------------------------------------------------------------- #

_fns = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from trlx_tpu_torch.ops._build import library

        fn = getattr(library("flash_attention"), name)
        n_ptr = {"flash_fwd": 6, "flash_bwd_dq": 8, "flash_bwd_dkv": 9}[name]
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(q, k, v, mask, g=None, lse=None, dD=None):
    """Shapes, dtypes, device and contiguity the kernels take, and in
    bfloat16 the 16-byte alignment the kernels' row copies need; returns
    (B, T, H, hd)."""
    if q.dim() != 4:
        raise ValueError("q, k, v must be [B, T, H, hd]")
    B, T, H, hd = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"no flash kernel for {q.dtype} (float32 or "
                        f"bfloat16)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"no flash kernel for head_dim {hd} "
                         f"(one of {HEAD_DIMS})")
    dev = q.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"q is on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    for name, t in (("q", q), ("k", k), ("v", v), ("dO", g)):
        if t is not None:
            _check(name, t, (B, T, H, hd), q.dtype, dev)
    _check("mask", mask, (B, T), torch.int32, dev)
    for name, t in (("lse", lse), ("D", dD)):
        if t is not None:
            _check(name, t, (B, H, T), torch.float32, dev)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("dO", g)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"{name} must start 16-byte aligned")
    return B, T, H, hd


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    count_launch(name)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, mask, causal=True):
    """Forward: (O [B, T, H, hd] in q's dtype, lse float32 [B, H, T]).
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    B, T, H, hd = _check_inputs(q, k, v, mask)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    rc = _kernel("flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, T, H, hd, int(causal),
        _DTYPE_CODE[q.dtype], flash_scale(hd), _stream(q),
    )
    _launched("flash_fwd", rc)
    return out, lse


def flash_bwd_dq(q, k, v, g, lse, dD, mask, causal=True):
    """dq ([B, T, H, hd] in q's dtype) from dO ``g``, the forward's lse
    and D = rowsum(dO * O). CUDA -> kernel; CPU -> plain version."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, g, lse, dD, mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: unsupported device {q.device}")
    B, T, H, hd = _check_inputs(q, k, v, mask, g, lse, dD)
    dq = torch.empty_like(q)
    rc = _kernel("flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dD.data_ptr(), mask.data_ptr(), dq.data_ptr(),
        B, T, H, hd, int(causal), _DTYPE_CODE[q.dtype], flash_scale(hd),
        _stream(q),
    )
    _launched("flash_bwd_dq", rc)
    return dq


def flash_bwd_dkv(q, k, v, g, lse, dD, mask, causal=True):
    """(dk, dv), [B, T, H, hd] each in q's dtype. CUDA -> kernel; CPU ->
    plain version."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, g, lse, dD, mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: unsupported device {q.device}")
    B, T, H, hd = _check_inputs(q, k, v, mask, g, lse, dD)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    rc = _kernel("flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dD.data_ptr(), mask.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, T, H, hd, int(causal), _DTYPE_CODE[q.dtype],
        flash_scale(hd), _stream(q),
    )
    _launched("flash_bwd_dkv", rc)
    return dk, dv


def softmax_jacobian_diag(g, out):
    """D = rowsum(dO * O) in float32, [B, H, T] (outside the kernels, as
    the TPU wrapper computes it)."""
    return (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


class FlashAttention(torch.autograd.Function):
    """Autograd over the three kernels: saves q, k, v, O, lse and the
    mask; the backward recomputes the probabilities from lse."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        out, lse = flash_fwd(q, k, v, mask, causal)
        ctx.save_for_backward(q, k, v, out, lse, mask)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, mask = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        dD = softmax_jacobian_diag(g, out)
        dq = flash_bwd_dq(q, k, v, g, lse, dD, mask, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, dD, mask, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, mask, causal=True):
    """Fused attention over [B, T, H, hd] q/k/v and the raw [B, T] int32
    mask; [B, T, H, hd] in q's dtype. Records a backward only when grad
    mode is on and an input needs a gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, mask, causal)
    return flash_fwd(q, k, v, mask, causal)[0]


def _on_mesh(fn, mesh, q, k, v, mask, tp_heads=False):
    """``fn`` (the kernels, or their dense plain version) on each
    process's shard, as trlx_tpu's ``shard_map`` around the Pallas
    kernels: batch over (dp, fsdp) where dp * fsdp divides it, heads over
    tp where tp divides them, else replicated. DTensor inputs are global
    tensors; plain inputs are this process's rows of a batch sharded over
    (dp, fsdp) (the trainers' forward) holding every head, or with
    ``tp_heads`` this process's heads of a tp-sharded model, and come
    back as such. Through ``local_map``: a ctypes launch takes no
    DTensor, so the kernels see the local shards, and autograd carries
    the gradients back through the redistributions (none when the
    inputs already hold their shards)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from trlx_tpu_torch.parallel import AXES, mesh_sizes
    from trlx_tpu_torch.parallel.sharding import batch_sharding, is_dtensor

    sizes = mesh_sizes(mesh)
    rows_local = not is_dtensor(q)
    if rows_local:
        rows = batch_sharding(mesh)
        heads = [Shard(2) if ax == "tp" and tp_heads else pl
                 for ax, pl in zip(AXES, rows)]
        q, k, v = (DTensor.from_local(x, mesh, heads, run_check=False)
                   for x in (q, k, v))
        mask = DTensor.from_local(mask, mesh, rows, run_check=False)
    batch_ok = q.shape[0] % (sizes["dp"] * sizes["fsdp"]) == 0
    head_ok = q.shape[2] % sizes["tp"] == 0

    def placements(split_heads):
        return [Shard(0) if ax in ("dp", "fsdp") and batch_ok
                else Shard(2) if ax == "tp" and split_heads and head_ok
                else Replicate() for ax in AXES]

    qkv, m = placements(True), placements(False)
    out = local_map(fn, out_placements=qkv, in_placements=(qkv, qkv, qkv, m),
                    device_mesh=mesh, redistribute_inputs=True)(q, k, v, mask)
    if rows_local:
        return out.redistribute(mesh, heads).to_local()
    return out


def make_flash_attention_fn(min_fused_t: int = None, causal: bool = True,
                            mesh=None, tp_heads: bool = False):
    """An ``attention_fn`` for the trunk running the flash kernels. It
    takes the raw [B, T] mask (``takes_raw_mask``) and the compact
    Hkv-wide K/V: a GQA K/V is repeated to H heads before the kernels,
    as the JAX trunk does (``jnp.repeat`` on the head axis), so autograd
    sums dk/dv over each group. Sequences shorter than ``min_fused_t``
    (default :data:`_MIN_FUSED_T`) take the dense path. With a ``mesh``
    (trlx_tpu_torch.parallel) either runs on each process's shard
    (:func:`_on_mesh`; ``tp_heads``: the trainer's forward already holds
    this process's heads)."""
    min_t = _MIN_FUSED_T if min_fused_t is None else min_fused_t

    def kernels(q, k, v, mask):
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), mask.contiguous(), causal)

    def dense(q, k, v, mask):
        return flash_attention_reference(q, k, v, mask, causal)

    def flash_attention_fn(q, k, v, attention_mask):
        fused = q.shape[1] >= min_t
        if mesh is None and not fused:
            return dense(q, k, v, attention_mask)
        H, Hkv = q.shape[2], k.shape[2]
        if Hkv != H:
            k = k.repeat_interleave(H // Hkv, dim=2)
            v = v.repeat_interleave(H // Hkv, dim=2)
        mask = attention_mask.to(torch.int32)
        if mesh is None:
            return kernels(q, k, v, mask)
        return _on_mesh(kernels if fused else dense, mesh, q, k, v, mask,
                        tp_heads)

    flash_attention_fn.takes_raw_mask = True
    return flash_attention_fn
