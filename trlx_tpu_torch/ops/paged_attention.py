"""Paged-attention DECODE: the hand-written Hopper kernel and its plain
version (port of trlx_tpu.ops.paged_attention).

:func:`paged_decode_attention` computes one decode step of paged
attention — the fresh query row of every slot against the slot's pages
of the global KV pool — with the exact contract of the TPU kernel's
wrapper: ``q`` [S, H, hd]; one layer's pool [num_pages, page_size, Hkv,
hd] (bf16, f32, or the int8 tier's ``(codes, scales [num_pages,
page_size, Hkv])`` pair); ``page_table`` [S, max_pages] int32 whose
entries >= num_pages are sentinels; ``bias`` [S, max_pages * page_size]
float32, 0 (attend) or ``NEG_INF`` (masked). Returns [S, H, hd] in q's
dtype. Query heads [h*G, (h+1)*G) share kv-head h (GQA).

It replaces ``trlx_tpu/ops/paged_attention.py::_decode_kernel``, which
walks a slot's pages as a sequential grid axis. On an H100 the step is
bound by the bytes of K/V it must read, and reaching that bound takes
loads in flight on every SM. So the CUDA kernel (``csrc/paged_decode.cu``,
built at first use) is split-K flash-decoding: the context is cut into
:func:`decode_partitions` parts of whole pages, one block per (slot,
kv-head, part), warps splitting a part's tokens and lanes reading K/V
rows as 16-byte vectors; the parts' float32 (max, sum, accumulator)
partials merge in a second small kernel in a fixed order. At the serving
shape there is one part and one launch.

A CUDA tensor goes to the kernel, or the call raises; only a CPU tensor
goes to the plain version :func:`paged_decode_attention_reference` — the
clamp-gather to logical order plus ``attention_scores`` that
block_apply's jnp path runs. There is no fallback between the two.
"""

import ctypes

import torch

from trlx_tpu_torch.models.transformer import (
    _rsqrt_scale,
    attention_scores,
    dequantize_kv,
)
from trlx_tpu_torch.ops import count_launch

#: one Hopper block's shared-memory ceiling (bytes)
_SMEM_LIMIT = 232448
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: (q dtype, pool dtype) pairs the kernel is compiled for
_SUPPORTED = {
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float32, torch.int8),
}
#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: streaming multiprocessors of an H100 SXM
_SMS = 132
#: blocks per SM the partition count aims for once the context is long
_BLOCKS_PER_SM = 4
#: fewest tokens a partition holds (below, one block reads the context)
_MIN_PART_TOKENS = 128


def decode_partitions(S: int, Hkv: int, max_pages: int,
                      page_size: int) -> tuple:
    """(P, pages per partition) of the split-K grid (slot, kv-head,
    partition): enough partitions for about ``_BLOCKS_PER_SM`` blocks on
    each of the card's SMs, none shorter than ``_MIN_PART_TOKENS`` tokens
    and each a whole number of pages, with no empty one. P is 1 when the
    slots and heads alone fill the card or the context is short."""
    want = -(-_BLOCKS_PER_SM * _SMS // (S * Hkv))
    longest = max(1, max_pages * page_size // _MIN_PART_TOKENS)
    P = max(1, min(want, longest, max_pages))
    per = -(-max_pages // P)
    return -(-max_pages // per), per


def shared_memory_bytes(H: int, Hkv: int, hd: int, pages_per: int) -> int:
    """Dynamic shared memory one kernel block takes (``launch`` in
    csrc/paged_decode.cu): q rows of its head group (4, 2 or 1 of the
    G = H / Hkv query heads of a kv-head) in float32, each of the 4
    warps' (max, sum, accumulator) per head for the merge, and a clamped
    page id and a live flag for each of the partition's pages."""
    G = H // Hkv
    gt = 4 if G % 4 == 0 else (2 if G % 2 == 0 else 1)
    return 4 * (gt * hd + 4 * gt * (hd + 2)) + 4 * 2 * pages_per


def _split(pages):
    if isinstance(pages, (tuple, list)):
        codes, scales = pages
        return codes, scales
    return pages, None


def paged_decode_attention_reference(q, k_pages, v_pages, page_table, bias):
    """The plain PyTorch version: clamp-gather each slot's pages back into
    logical order, then ``attention_scores`` (exactly block_apply's
    non-kernel paged path)."""
    k_codes, k_scales = _split(k_pages)
    v_codes, v_scales = _split(v_pages)
    S, H, hd = q.shape
    num_pages, page_size, Hkv, _ = k_codes.shape
    max_pages = page_table.shape[1]
    ctx = page_table.long().clamp(0, num_pages - 1)
    if k_scales is not None:
        k_ctx = dequantize_kv(k_codes[ctx], k_scales[ctx], q.dtype)
        v_ctx = dequantize_kv(v_codes[ctx], v_scales[ctx], q.dtype)
    else:
        k_ctx = k_codes[ctx].to(q.dtype)
        v_ctx = v_codes[ctx].to(q.dtype)
    T = max_pages * page_size
    k_ctx = k_ctx.reshape(S, T, Hkv, hd)
    v_ctx = v_ctx.reshape(S, T, Hkv, hd)
    out = attention_scores(q[:, None], k_ctx, v_ctx,
                           bias.float()[:, None, None, :])
    return out[:, 0]


def _bind(lib: ctypes.CDLL):
    fn = lib.paged_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


_kernel_fn = None


def _kernel():
    global _kernel_fn
    if _kernel_fn is None:
        from trlx_tpu_torch.ops._build import library

        _kernel_fn = _bind(library("paged_decode"))
    return _kernel_fn


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


def _launch(q, k_pages, v_pages, page_table, bias, partitions=None):
    """Checks and launches; ``partitions`` overrides
    :func:`decode_partitions` (the chip smoke's sweep)."""
    k_codes, k_scales = _split(k_pages)
    v_codes, v_scales = _split(v_pages)
    if q.dim() != 3 or k_codes.dim() != 4:
        raise ValueError("q must be [S, H, hd] and the pools "
                         "[num_pages, page_size, Hkv, hd]")
    S, H, hd = q.shape
    num_pages, page_size, Hkv, hd_k = k_codes.shape
    max_pages = page_table.shape[1] if page_table.dim() == 2 else -1
    if hd_k != hd or Hkv <= 0 or H % Hkv:
        raise ValueError(f"pool heads/dims ({Hkv}, {hd_k}) do not fit q "
                         f"({H}, {hd})")
    if hd not in HEAD_DIMS:
        raise ValueError(f"no paged-decode kernel for head_dim {hd} (one "
                         f"of {HEAD_DIMS})")
    if (q.dtype, k_codes.dtype) not in _SUPPORTED:
        raise TypeError(f"no kernel for q {q.dtype} with a {k_codes.dtype} "
                        f"pool")
    if (k_codes.dtype == torch.int8) != (k_scales is not None):
        raise TypeError("an int8 pool comes as (codes, scales); other "
                        "pools as one tensor")
    dev = q.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"q is on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    _check("q", q, (S, H, hd), q.dtype, dev)
    pool_shape = (num_pages, page_size, Hkv, hd)
    _check("k_pages", k_codes, pool_shape, k_codes.dtype, dev)
    _check("v_pages", v_codes, pool_shape, k_codes.dtype, dev)
    if k_scales is not None:
        _check("k_scales", k_scales, pool_shape[:3], torch.float32, dev)
        _check("v_scales", v_scales, pool_shape[:3], torch.float32, dev)
    _check("page_table", page_table, (S, max_pages), torch.int32, dev)
    _check("bias", bias, (S, max_pages * page_size), torch.float32, dev)
    for name, t in (("q", q), ("k_pages", k_codes), ("v_pages", v_codes)):
        if t.data_ptr() % 16:  # the kernel reads 16-byte vectors
            raise ValueError(f"{name} must start 16-byte aligned")
    if partitions is None:
        partitions, per = decode_partitions(S, Hkv, max_pages, page_size)
    else:
        per = -(-max_pages // partitions)
    smem = shared_memory_bytes(H, Hkv, hd, per)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"shape needs {smem} B of shared memory per block "
                         f"(limit {_SMEM_LIMIT})")
    out = torch.empty_like(q)
    partials = (torch.empty((S, H, partitions, hd + 2), dtype=torch.float32,
                            device=dev) if partitions > 1 else None)
    rc = _kernel()(
        q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
        k_scales.data_ptr() if k_scales is not None else None,
        v_scales.data_ptr() if v_scales is not None else None,
        page_table.data_ptr(), bias.data_ptr(), out.data_ptr(),
        partials.data_ptr() if partials is not None else None,
        S, H, Hkv, hd, num_pages, page_size, max_pages, partitions,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_codes.dtype],
        _rsqrt_scale(hd), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{rc}")
    count_launch("paged_decode")
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table, bias):
    """One decode step of paged attention (module docstring). CUDA tensors
    launch the Hopper kernel; CPU tensors run the plain version."""
    if q.device.type == "cuda":
        return _launch(q, k_pages, v_pages, page_table, bias)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pages, v_pages,
                                                 page_table, bias)
    raise ValueError(f"paged_decode_attention: unsupported device {q.device}")


def make_paged_decode_fn():
    """The ``block_apply(paged_decode_fn=...)`` seam: ``fn(q1, k_pages,
    v_pages, page_table, bias_row)``.

    On a tp serve mesh each process calls it with its own heads: q [S,
    H/tp, hd] against its pool's Hkv/tp heads when tp divides both, the
    whole width otherwise (trlx_tpu_torch.serve.layouts, the placements
    of trlx_tpu's ``shard_map`` in_specs), with the page table and the
    bias row the same on every process. The tensors a process holds are
    already its shard, so the seam is the kernel itself, with no mesh
    argument: nothing here gathers or splits."""
    return paged_decode_attention
