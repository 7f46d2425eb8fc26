"""Flash attention for training: the hand-written Hopper kernels, their
plain versions and the autograd seam (port of
trlx_tpu.ops.pallas_attention).

Three kernels, built at first use:

- :func:`flash_fwd` — O and the float32 logsumexp; replaces
  ``_flash_fwd_kernel`` (launched by ``_flash_forward``). For bfloat16
  ``csrc/flash_forward.cu`` (wgmma tiles fed by TMA); for float32
  ``csrc/flash_attention.cu`` (CUDA-core FMA);
- :func:`flash_bwd_dq` — dq and D = rowsum(dO * O) from O, dO and the
  saved logsumexp; replaces ``_flash_bwd_dq_kernel`` and the jnp line
  that computes D before it;
- :func:`flash_bwd_dkv` — dk and dv, reading that D; replaces
  ``_flash_bwd_dkv_kernel`` (both launched by ``_flash_backward``).
  For bfloat16 both are ``csrc/flash_backward.cu`` (wgmma tiles fed by
  TMA); for float32 ``csrc/flash_attention.cu`` (CUDA-core FMA).

Each takes q, k, v (and dO, O) as [B, T, H, hd] in float32 or bfloat16,
the raw key mask [B, T] int32 (1 = real), ``causal``; lse and D are
float32 [B, H, T]; O and the gradients come back in q's dtype, rounded
once from float32 sums. The bias is the TPU kernels': 0 / ``NEG_INF``
from the mask plus ``NEG_INF`` above the diagonal, scale 1 / sqrt(hd).

What bounds them on an H100: at the training shape (B 32, T 576, H 12,
hd 64, bf16) device memory would allow each about 34-51 µs, but a
kernel that stages 64 x 64 tiles and multiplies them is held by how fast
it feeds its products. The bf16 kernels run ``wgmma`` on tiles brought
by TMA from a producer warpgroup through a ring of mbarrier-guarded
stages (:func:`tma_maps`). The forward's consumer warpgroups own 64
query rows each (one a block to hd 64, three blocks an SM; two a block
from hd 128, sharing every K and V tile); a round takes one key tile:
its S = Q K^T, then its softmax, then its P V, each waited for before
the next (:func:`forward_geometry`).
The backward forms S and dP from shared memory and runs its second
products on P and dS from registers, a bf16 hi + lo pair each
(:func:`backward_geometry`). Their tensors must start 16-byte aligned,
which the wrappers check. For float32 the kernels stay on the CUDA cores
in full float32: the tensor cores would round to TF32 and miss the
float32 parity.

At hd 256 (gpt-j-6B's heads) each kernel stays on one block of the
card's 227 KB of shared memory and under its 255 registers a thread: a
forward consumer keeps all 256 output columns of its 64 rows (128
float32 registers a thread), so S is formed once; the bf16 backward's
two consumer warpgroups share one 64-row slice and split the output
columns (dk/dv from hd 128); the float32 kernels own 32 rows a block
instead of 64 (:func:`fma_rows`).

A CUDA tensor goes to the kernel, or the call raises; only a CPU tensor
goes to the plain version beside it (``*_reference``), which repeats the
same math densely. The kernels skip key tiles wholly above the diagonal,
so a left-pad query row (which sees only masked keys) comes out as a
different finite average than the dense math gives; real rows agree.
:func:`flash_attention_reference` is the dense oracle
(``causal_mask_bias`` + ``attention_scores``) the tests and the chip
smoke hold the kernels against.

:class:`FlashAttention` wires the kernels into autograd: its backward
launches exactly two, dq (which computes D) then dk/dv. Under
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
_DTYPES = (torch.float32, torch.bfloat16)


def flash_scale(hd: int) -> float:
    """The kernels' softmax scale, 1 / sqrt(hd) as the TPU wrapper takes
    it (a Python float rounded once to float32 in the kernel)."""
    return 1.0 / (hd ** 0.5)


def fma_rows(hd: int) -> int:
    """Rows of a float32 kernel block's own tile (query rows in the
    forward and dq, key rows in dk/dv): 64, or 32 at hd 256, where four
    [64][hd + 1] float tiles would not fit one block."""
    return 64 if hd <= 128 else 32


def forward_geometry(hd: int) -> dict:
    """The bf16 forward kernel's plan at head dim ``hd`` (``Box`` in
    csrc/hopper.cuh, ``FwdPlan`` in csrc/flash_forward.cu): a block owns
    ``rows`` query rows, ``consumers`` warpgroups of 64 each (one to hd
    64, with ``blocks`` 3 an SM; two from hd 128, sharing each K and V
    tile, one block an SM) and a producer warpgroup that hands them its
    registers, every consumer keeping all ``out_cols`` output columns of
    its rows (S formed once), K and V through rings of ``stages`` (four
    to hd 128, two at 256); a 64-row tile is ``boxes`` TMA boxes of
    ``box_cols`` columns, each 64 rows of ``row_bytes`` (the swizzle
    width); ``registers`` a thread at launch (the register file over the
    SM's threads, rounded down to 8) and the producer's and each
    consumer's after ``setmaxnreg`` (the consumers take all but 24 of
    the producer's, in multiples of 8), which ``flash_fwd_plan`` reports
    from the built kernel."""
    box_cols = min(hd, 64)
    consumers, blocks = (1, 3) if hd <= 64 else (2, 1)
    threads = 128 * (consumers + 1)
    launch = 65536 // (threads * blocks) // 8 * 8
    consumer = ((consumers + 1) * launch - 24) // consumers // 8 * 8
    producer = (consumers + 1) * launch - consumers * consumer
    return {"box_cols": box_cols, "boxes": hd // box_cols,
            "row_bytes": 2 * box_cols, "tile_bytes": TILE * 2 * hd,
            "consumers": consumers, "blocks": blocks,
            "rows": TILE * consumers, "threads": threads, "out_cols": hd,
            "stages": 4 if hd <= 128 else 2,
            "registers": {"launch": launch, "producer": producer,
                          "consumer": consumer}}


def backward_stages(hd: int) -> int:
    """Stages of the bf16 backward kernels' ring of streamed tiles
    (``stages`` in csrc/flash_backward.cu): four while the tiles are
    small, two from hd 128."""
    return 4 if hd <= 64 else 2


def backward_geometry(hd: int) -> dict:
    """The bf16 backward kernels' tiles at head dim ``hd`` (``Box`` and
    ``Plan`` in csrc/flash_backward.cu): a block owns one 64-row slice
    (query rows in dq, key rows in dk/dv), whose tile is ``boxes`` TMA
    boxes of ``box_cols`` columns, each 64 rows of ``row_bytes`` (the
    swizzle width). Each kernel's ``split`` is its consumer warpgroups:
    1 while one warpgroup's float32 accumulators fit (dq to hd 128, dk/dv
    to hd 64), else 2 sharing the slice, half the output columns each."""
    box_cols = min(hd, 64)
    return {"box_cols": box_cols, "boxes": hd // box_cols,
            "row_bytes": 2 * box_cols, "tile_bytes": TILE * 2 * hd,
            "split": {"flash_bwd_dq": 2 if hd > 128 else 1,
                      "flash_bwd_dkv": 2 if hd > 64 else 1}}


def tma_maps(B: int, T: int, H: int, hd: int) -> dict:
    """The tensor maps the bf16 forward and backward encode per call
    (``map_rows`` in csrc/hopper.cuh): name -> element bytes, dims
    (innermost first), byte strides of dims 1.., box and swizzle bytes.
    q, k, v, dO and O are 4-D over [B, T, H, hd]. The key mask, lse and
    D rows have none: a row of T 4-byte values starts 16-byte aligned
    only when T is a multiple of 4, so the producer warp copies them
    by 4-byte ``cp.async``."""
    box_cols = min(hd, 64)
    return {"q/k/v/dO/O": {"elem": 2, "dims": (hd, H, T, B),
                           "strides": (2 * hd, 2 * hd * H, 2 * hd * H * T),
                           "box": (box_cols, 1, TILE, 1),
                           "swizzle": 2 * box_cols}}


def shared_memory_bytes(hd: int, dtype=torch.bfloat16) -> dict:
    """Dynamic shared memory per block of each kernel for inputs of
    ``dtype``. For float32 each kernel holds [hd + 1]-float rows of its
    own tiles (:func:`fma_rows` rows: Q in the forward, Q and dO in dq,
    K and V in dk/dv) and of the streamed 64-row tiles (K and V, or Q
    and dO), a [rows][65] score tile (two in dk/dv) and the row vectors
    (dq's D among them). For bfloat16 the forward (``fwd_smem`` in
    csrc/flash_forward.cu, which ``flash_fwd_plan`` reports) holds 1 KB
    to align the swizzled tiles, the consumers' Q tiles, the stages of
    K, V and the key mask (:func:`forward_geometry`), and the mbarriers
    (full and empty of K and of V a stage, Q's own); the backward
    (``dq_smem`` / ``dkv_smem`` in csrc/flash_backward.cu, which
    ``flash_bwd_smem_bytes`` reports) 1 KB to align the swizzled tiles,
    the block's own swizzled tiles (Q and dO; K and V), the stages
    (:func:`backward_stages`) of the streamed ones (K and V; Q and dO)
    and of their rows (the key mask; lse and D), dq's D and the
    mbarriers."""
    if dtype == torch.float32:
        own, row = fma_rows(hd), hd + 1
        streamed = 2 * TILE * row
        return {
            "flash_fwd": 4 * (own * row + streamed + own * (TILE + 1)
                              + TILE),
            "flash_bwd_dq": 4 * (2 * own * row + streamed
                                 + own * (TILE + 1) + TILE + own),
            "flash_bwd_dkv": 4 * (2 * own * row + streamed
                                  + 2 * own * (TILE + 1) + 2 * TILE),
        }
    fwd = forward_geometry(hd)
    tile, ns = fwd["tile_bytes"], fwd["stages"]
    stages = backward_stages(hd)
    bars = 8 * (2 * stages + 1)
    return {"flash_fwd": 1024 + fwd["consumers"] * tile + 2 * ns * tile
            + ns * TILE * 4 + 8 * (4 * ns + 1),
            "flash_bwd_dq": 1024 + 2 * tile + 2 * stages * tile
            + stages * TILE * 4 + TILE * 4 + bars,
            "flash_bwd_dkv": 1024 + 2 * tile + 2 * stages * tile
            + 2 * stages * TILE * 4 + bars}


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


def softmax_jacobian_diag(g, out):
    """D = rowsum(dO * O) in float32, [B, H, T]: the plain form of what
    the dq kernel computes in its prologue (the TPU wrapper computes it
    outside its kernels)."""
    return (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_bwd_dq_reference(q, k, v, g, out, lse, mask, causal=True):
    """Plain version of the dq kernel: float32 math; (dq [B, T, H, hd] in
    q's dtype, D = rowsum(dO * O) float32 [B, H, T], as
    :func:`softmax_jacobian_diag` gives it)."""
    dD = softmax_jacobian_diag(g, out)
    p, _ = _probs(q.float(), k.float(), mask, causal, lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    ds = p * (dp - dD[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) \
        * flash_scale(q.shape[-1])
    return dq.to(q.dtype), dD


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
#: pointer arguments of each C entry point (five ints, a float scale and
#: the stream follow)
_POINTERS = {"flash_fwd_f32": 6, "flash_fwd_bf16": 6, "flash_bwd_dq_f32": 9,
             "flash_bwd_dkv_f32": 9, "flash_bwd_dq_bf16": 9,
             "flash_bwd_dkv_bf16": 9}


def _kernel(source: str, name: str):
    """C entry point ``name`` of csrc/``source``.cu, bound once."""
    fn = _fns.get(name)
    if fn is None:
        from trlx_tpu_torch.ops._build import library

        fn = getattr(library(source), name)
        fn.argtypes = [ctypes.c_void_p] * _POINTERS[name] + \
            [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def forward_plan(hd: int) -> dict:
    """The built bf16 forward kernel's plan at head dim ``hd``
    (``flash_fwd_plan``), to hold :func:`forward_geometry` and
    :func:`shared_memory_bytes` to on the card."""
    from trlx_tpu_torch.ops._build import library

    fn = library("flash_forward").flash_fwd_plan
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    if fn(hd, out) != 0:
        raise ValueError(f"no bf16 flash forward for head_dim {hd}")
    return {"consumers": out[0], "blocks": out[1], "stages": out[2],
            "registers": {"launch": out[3], "producer": out[4],
                          "consumer": out[5]},
            "smem": out[6]}


def backward_smem_bytes(hd: int) -> dict:
    """The dynamic shared memory the built bf16 backward kernels ask for
    at head dim ``hd`` (``flash_bwd_smem_bytes``), to hold
    :func:`shared_memory_bytes` to on the card."""
    from trlx_tpu_torch.ops._build import library

    fn = library("flash_backward").flash_bwd_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return {"flash_bwd_dq": fn(hd, 0), "flash_bwd_dkv": fn(hd, 1)}


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


def _check_inputs(q, k, v, mask, g=None, lse=None, dD=None, out=None):
    """Shapes, dtypes, device and contiguity the kernels take, and in
    bfloat16 the 16-byte alignment the kernels' TMA copies and the
    forward's 16-byte stores of O need; returns (B, T, H, hd)."""
    if q.dim() != 4:
        raise ValueError("q, k, v must be [B, T, H, hd]")
    B, T, H, hd = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"no flash kernel for {q.dtype} (float32 or "
                        f"bfloat16)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"no flash kernel for head_dim {hd} "
                         f"(one of {HEAD_DIMS})")
    dev = q.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"q is on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    rows = (("q", q), ("k", k), ("v", v), ("dO", g), ("O", out))
    for name, t in rows:
        if t is not None:
            _check(name, t, (B, T, H, hd), q.dtype, dev)
    _check("mask", mask, (B, T), torch.int32, dev)
    for name, t in (("lse", lse), ("D", dD)):
        if t is not None:
            _check(name, t, (B, H, T), torch.float32, dev)
    if q.dtype == torch.bfloat16:
        for name, t in rows:
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
    out = torch.empty_like(q)
    B, T, H, hd = _check_inputs(q, k, v, mask, out=out)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    rc = _kernel(*_entry("fwd", q.dtype))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, T, H, hd, int(causal),
        flash_scale(hd), _stream(q),
    )
    _launched("flash_fwd", rc)
    return out, lse


def _entry(kind, dtype):
    """(source, C entry point) of kernel ``kind`` (fwd, bwd_dq, bwd_dkv)
    for ``dtype``: bfloat16 on wgmma, float32 on the CUDA cores."""
    if dtype == torch.bfloat16:
        source = "flash_forward" if kind == "fwd" else "flash_backward"
        return source, f"flash_{kind}_bf16"
    return "flash_attention", f"flash_{kind}_f32"


def flash_bwd_dq(q, k, v, g, out, lse, mask, causal=True):
    """(dq [B, T, H, hd] in q's dtype, D = rowsum(dO * O) float32
    [B, H, T]) from dO ``g``, the forward's O ``out`` and lse: the
    kernel computes D for its own rows first and writes it for
    :func:`flash_bwd_dkv`. CUDA -> kernel; CPU -> plain version."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, g, out, lse, mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: unsupported device {q.device}")
    B, T, H, hd = _check_inputs(q, k, v, mask, g, lse, out=out)
    dq = torch.empty_like(q)
    dD = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    rc = _kernel(*_entry("bwd_dq", q.dtype))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        out.data_ptr(), lse.data_ptr(), mask.data_ptr(), dq.data_ptr(),
        dD.data_ptr(), B, T, H, hd, int(causal), flash_scale(hd),
        _stream(q),
    )
    _launched("flash_bwd_dq", rc)
    return dq, dD


def flash_bwd_dkv(q, k, v, g, lse, dD, mask, causal=True):
    """(dk, dv), [B, T, H, hd] each in q's dtype, from the D that
    :func:`flash_bwd_dq` returned. CUDA -> kernel; CPU -> plain
    version."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, g, lse, dD, mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: unsupported device {q.device}")
    B, T, H, hd = _check_inputs(q, k, v, mask, g, lse, dD)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    rc = _kernel(*_entry("bwd_dkv", q.dtype))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dD.data_ptr(), mask.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, T, H, hd, int(causal), flash_scale(hd),
        _stream(q),
    )
    _launched("flash_bwd_dkv", rc)
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Autograd over the kernels: saves q, k, v, O, lse and the mask; the
    backward launches dq (which computes D from dO and O) then dk/dv,
    recomputing the probabilities from lse, and runs no torch
    arithmetic of its own (the conversion below returns dO itself when
    it is already q's dtype and contiguous)."""

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
        dq, dD = flash_bwd_dq(q, k, v, g, out, lse, mask, ctx.causal)
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
