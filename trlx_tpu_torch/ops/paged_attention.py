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
bound by the bytes of K/V it must read and, at serving contexts, by the
latency of the first ones. So the CUDA kernel (``csrc/paged_decode.cu``,
built at first use) cuts the context into :func:`decode_partitions`
parts of whole pages (at most 8), one block per (slot, kv-head, part),
the parts of one slot and head a thread-block cluster: a producer warp
streams the pages by TMA through an mbarrier ring in shared memory
(its depth the kernel's own choice, every page of a serving context at
once), four consumer warps fold each page into float32 running (max,
sum, accumulator) as it lands, and the parts merge through the
cluster's shared memory in a fixed order: one launch at every shape.

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
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
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
#: blocks an SM holds at once (80-odd registers a thread of 160), which
#: the partition count keeps the grid within once the context is long
_BLOCKS_PER_SM = 4
#: fewest tokens a partition holds (below, one block reads the context)
_MIN_PART_TOKENS = 128
#: most partitions: the blocks of one cluster (the portable cluster size)
_MAX_PARTITIONS = 8
#: largest page the kernel streams (a TMA box side)
_MAX_PAGE_SIZE = 256


def decode_partitions(S: int, Hkv: int, max_pages: int,
                      page_size: int) -> tuple:
    """(P, pages per partition) of the split-K grid (slot, kv-head,
    partition): as many partitions as keep the grid within
    ``_BLOCKS_PER_SM`` blocks on each of the card's SMs (one wave), none
    shorter than ``_MIN_PART_TOKENS`` tokens, at most ``_MAX_PARTITIONS``
    (longer partitions instead), each a whole number of pages, with no
    empty one. P is 1 when the slots and heads alone fill the card or
    the context is short."""
    want = _BLOCKS_PER_SM * _SMS // (S * Hkv)
    longest = max(1, max_pages * page_size // _MIN_PART_TOKENS)
    P = max(1, min(want, longest, max_pages, _MAX_PARTITIONS))
    per = -(-max_pages // P)
    return -(-max_pages // per), per


def _head_group(H: int, Hkv: int) -> int:
    """Query heads of a kv-head one block serves (4, 2 or 1)."""
    G = H // Hkv
    return 4 if G % 4 == 0 else (2 if G % 2 == 0 else 1)


def _up(x: int, n: int) -> int:
    return -(-x // n) * n


def shared_memory_bytes(H: int, Hkv: int, hd: int, page_size: int,
                        pages_per: int, kv_dtype=torch.bfloat16) -> int:
    """The least dynamic shared memory one kernel block takes, with a
    ring of one stage (``layout`` in csrc/paged_decode.cu, which deepens
    the ring as far as the card's shared memory allows): a full and an
    empty mbarrier, the partition's live flag and used-page count, two
    words a page, the partition's bias words (the compact ring keeps
    them there), each of the 4 consumer warps' (max, sum, accumulator)
    per head of the block's head group and the block's merged row per
    head, then from the next 128-byte boundary (128 bytes left for it)
    one stage: a page's K rows and V rows of one kv-head, each a 128-byte
    aligned TMA box, its bias words (the direct ring carries them there)
    and, for the int8 tier, its rows' float32 scales. The wrapper refuses a shape above one block's
    ceiling before it launches."""
    gt = _head_group(H, Hkv)
    red = _up(16 + 16 + 8 * pages_per + 4 * pages_per * page_size, 16)
    ring = _up(red + 16 * gt * (hd + 2) + 4 * gt * (hd + 2), 16)
    rows = _up(page_size * hd * _ELEM_BYTES[kv_dtype], 128)
    words = 4 * page_size * (3 if kv_dtype == torch.int8 else 1)
    return ring + _up(2 * rows + words, 128) + 128


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
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [
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
    :func:`decode_partitions` (the chip smoke's sweep, 1 to 8)."""
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
    if not 1 <= page_size <= _MAX_PAGE_SIZE:
        raise ValueError(f"page_size {page_size} is not 1 to "
                         f"{_MAX_PAGE_SIZE} (a TMA box side)")
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
        if not 1 <= partitions <= _MAX_PARTITIONS or \
                (partitions - 1) * per >= max_pages:
            raise ValueError(f"{partitions} partitions of {max_pages} pages")
    smem = shared_memory_bytes(H, Hkv, hd, page_size, per, k_codes.dtype)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"shape needs {smem} B of shared memory per block "
                         f"with a ring of one page (limit {_SMEM_LIMIT})")
    out = torch.empty_like(q)
    rc = _kernel()(
        q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
        k_scales.data_ptr() if k_scales is not None else None,
        v_scales.data_ptr() if v_scales is not None else None,
        page_table.data_ptr(), bias.data_ptr(), out.data_ptr(),
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
