"""Functional GPT-family transformer trunk (port of trlx_tpu.models.transformer).

Parameters are plain dicts of tensors with per-layer tensors STACKED
along a leading layer axis, exactly trlx_tpu's pytree layout, so a
numpy tree from ``jax.device_get`` maps over leaf for leaf
(trlx_tpu_torch.models.params). Compute runs in the caller's dtype;
layernorm and softmax accumulate in float32; masks are the finite
additive ``NEG_INF`` bias (a fully masked row stays finite).

Where torch and JAX part ways, this module makes the JAX semantics
explicit:

- JAX gathers clamp out-of-range indices; here every gather clamps
  (page ids, positions, token ids) by hand.
- JAX ``mode="drop"`` scatters silently drop out-of-range rows; torch
  raises. A paged KV pool therefore carries ONE TRAILING DROP PAGE
  (:func:`init_paged_kv_cache` allocates ``num_pages + 1``): scatters
  aimed at a sentinel or past-the-table page land there, and nothing
  ever reads it (gathers clamp to ``[0, num_pages)``; the decode kernel
  sees ``pool[:num_pages]``). This keeps the scatter a single
  ``index_put_`` with no host sync.
- Cache and pool updates are IN PLACE (the functions still return the
  updated buffers, mirroring the JAX signatures).
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from trlx_tpu_torch.data.configs import ModelSpec

Params = Dict[str, Any]

NEG_INF = -1e9  # additive mask value; avoids -inf NaN propagation in softmax


@dataclass(frozen=True)
class ArchFlags:
    """Derived per-arch structural switches."""

    parallel_block: bool
    use_rotary: bool
    attn_bias: bool
    separate_mlp_ln: bool  # gpt2/neox: ln_2 feeds the MLP; gptj: shared ln_1
    rotary_interleaved: bool = False  # gptj rotates every-two; neox rotates halves
    rmsnorm: bool = False  # llama: RMSNorm (scale only, no mean/bias)
    swiglu: bool = False  # llama: silu(gate) * up MLP instead of gelu

    @classmethod
    def for_spec(cls, spec: ModelSpec) -> "ArchFlags":
        arch = spec.arch.lower()
        if arch == "gpt2":
            return cls(False, False, True, True)
        if arch == "gptj":
            return cls(True, True, False, False, rotary_interleaved=True)
        if arch == "gptneox":
            return cls(True, True, True, True)
        if arch == "llama":
            return cls(False, True, False, True, rmsnorm=True, swiglu=True)
        raise ValueError(f"unknown arch '{spec.arch}'")


def tree_map(fn, tree):
    """Map ``fn`` over the tensor leaves of nested dicts/tuples/lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def layer_params(blocks: Params, i: int) -> Params:
    """Layer ``i`` of a stacked block tree (views, no copies)."""
    return tree_map(lambda x: x[i], blocks)


def num_layers(blocks: Params) -> int:
    leaf = blocks
    while isinstance(leaf, (dict, tuple, list)):
        # an int8 serve weight is a (codes, scale) pair, both [L, ...]
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) \
            else leaf[0]
    return leaf.shape[0]


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def layer_norm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm (or RMSNorm when ``p`` has no bias) in float32."""
    dtype = x.dtype
    x32 = x.float()
    if "bias" not in p:  # RMSNorm
        y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
        return (y * p["scale"].float()).to(dtype)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rotary(
    x: torch.Tensor,
    positions: torch.Tensor,
    rotary_dim: int,
    interleaved: bool = False,
    theta: float = 10000.0,
) -> torch.Tensor:
    """Rotary embedding on the first `rotary_dim` dims of each head.

    x: [B, T, H, hd]; positions: [B, T]. `interleaved=True` is the GPT-J
    rotate-every-two convention; False the GPT-NeoX/llama half-rotation.
    """
    hd = x.shape[-1]
    rot_dim = rotary_dim if rotary_dim > 0 else hd
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    exponent = torch.arange(
        0, rot_dim, 2, dtype=torch.float32, device=x.device
    ) / rot_dim
    inv_freq = 1.0 / torch.pow(
        torch.full((), theta, dtype=torch.float32, device=x.device), exponent
    )
    freqs = positions[..., None].float() * inv_freq  # [B, T, rot_dim/2]
    if interleaved:
        emb = freqs.repeat_interleave(2, dim=-1)[:, :, None, :]
        rotate = _rotate_every_two
    else:
        emb = torch.cat([freqs, freqs], dim=-1)[:, :, None, :]
        rotate = _rotate_half
    cos, sin = torch.cos(emb), torch.sin(emb)
    x32 = x_rot.float()
    out = x32 * cos + rotate(x32) * sin
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def _rsqrt_scale(hd: int) -> float:
    """rsqrt(hd) rounded to float32, as ``jax.lax.rsqrt(jnp.float32(hd))``."""
    return float(torch.rsqrt(torch.tensor(float(hd), dtype=torch.float32)))


def attention_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_bias: torch.Tensor,
) -> torch.Tensor:
    """Plain attention: softmax in f32, matmuls in the input dtype.

    q: [B, Tq, H, hd]; k, v: [B, Tk, Hkv, hd] with Hkv dividing H
    (grouped-query attention against the compact KV); mask_bias:
    [B, 1, Tq, Tk] additive.
    """
    B, Tq, H, hd = q.shape
    Hkv = k.shape[2]
    scale = _rsqrt_scale(hd)
    if Hkv != H:  # GQA: group query heads over each shared KV head
        g = H // Hkv
        qg = q.reshape(B, Tq, Hkv, g, hd)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
        scores = scores * scale + mask_bias[:, :, None]
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
        return out.reshape(B, Tq, H, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * scale + mask_bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)



def _project(x, w, b=None):
    if isinstance(w, (tuple, list)):
        # serve-only int8 weights (serve.weights_dtype: int8): (codes
        # int8 [in, out], per-output-channel scale f32 [1, out]); the
        # scale factors out of the contraction. Unlike XLA, which fuses
        # the convert into the dot, torch writes codes.to(x.dtype) as a
        # full-size temporary on every call.
        codes, scale = w
        y = (x @ codes.to(x.dtype)) * scale.to(x.dtype)
    else:
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximation GELU of GPT-2/GPT-J/NeoX, written out."""
    x3 = x * x * x
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x3)))


def _paged_write(k_cache, v_cache, k, v, page_table, page_size,
                 cache_row_offsets):
    """Scatter fresh K/V [B, T, Hkv, hd] to logical positions
    ``cache_row_offsets[b] + j`` through the page table. Entries whose
    page is a sentinel (>= num_pages) or past the table extent are
    redirected to the trailing drop page — JAX's ``mode="drop"``."""
    B, T = k.shape[:2]
    num_pages = k_cache[0].shape[0] - 1 if isinstance(k_cache, tuple) \
        else k_cache.shape[0] - 1
    max_pages = page_table.shape[1]
    pos_buf = cache_row_offsets.long()[:, None] + torch.arange(
        T, device=k.device
    )[None, :]
    page_idx = pos_buf // page_size
    in_off = pos_buf % page_size
    pids = torch.gather(
        page_table.long(), 1, page_idx.clamp(0, max_pages - 1)
    )
    live = (page_idx < max_pages) & (pids >= 0) & (pids < num_pages)
    pids = torch.where(live, pids, torch.full_like(pids, num_pages))
    if isinstance(k_cache, tuple):
        (k_codes, k_sc), (v_codes, v_sc) = k_cache, v_cache
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        k_codes[pids, in_off] = kq
        k_sc[pids, in_off] = ks
        v_codes[pids, in_off] = vq
        v_sc[pids, in_off] = vs
    else:
        k_cache[pids, in_off] = k.to(k_cache.dtype)
        v_cache[pids, in_off] = v.to(v_cache.dtype)
    return num_pages


def block_apply(
    spec: ModelSpec,
    flags: ArchFlags,
    p: Params,
    h: torch.Tensor,
    mask_bias: torch.Tensor,
    positions: torch.Tensor,
    kv_cache=None,
    cache_offset=None,
    attention_fn=attention_scores,
    cache_row_offsets: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,
    page_size: Optional[int] = None,
    paged_decode_fn=None,
    cache_page_table: Optional[torch.Tensor] = None,
    tp=None,
):
    """One transformer block on hidden states `h` [B, T, D].

    Modes (as trlx_tpu's ``block_apply``):

    - dense: no ``kv_cache``;
    - dense-with-cache: ``kv_cache`` = (k_cache, v_cache) [B, Tbuf, Hkv,
      hd]; fresh K/V is written at ``cache_offset`` (in place; an int,
      or a 0-d device tensor read on the device) and q attends over the
      whole buffer;
    - contiguous slot pool: ``kv_cache`` as above plus
      ``cache_row_offsets`` [B] and T == 1: row b's fresh K/V lands at
      ``cache_row_offsets[b]``; the pool carries a drop row and a drop
      position past the ``mask_bias.shape[-1]`` logical ones
      (trlx_tpu_torch.models.generation ``init_slot_pool``), where an
      offset out of range writes instead of JAX's dropped scatter;
    - paged: ``page_table`` [B, max_pages] int32 and
      ``cache_row_offsets`` [B]; ``kv_cache`` is one layer's global pool
      WITH its trailing drop page ([num_pages + 1, page_size, Hkv, hd],
      or the int8 tier's ((codes, scales), (codes, scales))). Fresh K/V
      of token j of row b lands at logical position
      ``cache_row_offsets[b] + j``; attention gathers each row's pages
      back into logical order AFTER the scatter (a same-batch prefix
      sharer reads what its owner row just wrote), so ``mask_bias`` is
      [B, 1, T, max_pages * page_size].

    ``attention_fn`` takes the compact Hkv-wide K/V, as
    :func:`attention_scores` does (GQA is grouped inside it).
    ``paged_decode_fn`` (trlx_tpu_torch.ops.paged_attention
    ``make_paged_decode_fn``) replaces the paged gather + attention when
    T == 1 with ``fn(q[:, 0], k_pages, v_pages, page_table, bias_row)``
    over the post-scatter pool without its drop page. In the
    dense-with-cache mode, given ``cache_page_table`` [B, Tbuf / ps]
    int32 too, it replaces ``attention_fn`` when T == 1: the cache, after
    the fresh K/V's write, is read in place as a pool [B * Tbuf / ps,
    ps, Hkv, hd] whose pages the table hands each row, with
    ``mask_bias`` [B, 1, 1, Tbuf] as the bias row.

    ``tp`` (trlx_tpu_torch.parallel.sharding ``TensorParallel``, in
    every mode): Megatron's tensor parallelism. ``p`` then holds this
    process's column shards of wq / wk / wv / w_in / w_gate and their
    biases (whole heads, so q / k / v carry this process's heads) and
    row shards of wo / w_out; the input of each column-parallel
    projection goes through ``tp.enter`` (its gradient summed over the
    tp group) and each row-parallel product through ``tp.reduce`` (the
    sum over the group) before its bias. The caches and pools then hold
    this process's KV heads, which is what each process writes and
    reads. A ``tp`` whose ``attn`` (or ``mlp``) is False runs that
    sublayer whole width with whole weights (the serve mesh's
    trlx_tpu_torch.serve.layouts ``DecodeParallel``, where tp does not
    divide the heads or the MLP width).

    Returns (h_out, new_cache) — the cache objects are updated in place.
    """
    B, T, D = h.shape
    H, hd = spec.n_head, spec.head_dim
    Hkv = spec.kv_heads
    eps = spec.layer_norm_epsilon

    x = layer_norm(p["ln_1"], h, eps)
    attn = p["attn"]
    tp_attn = tp if tp is not None and tp.attn else None
    tp_mlp = tp if tp is not None and tp.mlp else None
    if tp_attn is not None:  # this process's heads
        H, Hkv = H // tp.size, Hkv // tp.size
    x_in = x if tp_attn is None else tp_attn.enter(x)
    q = _project(x_in, attn["wq"], attn.get("bq")).reshape(B, T, H, hd)
    k = _project(x_in, attn["wk"], attn.get("bk")).reshape(B, T, Hkv, hd)
    v = _project(x_in, attn["wv"], attn.get("bv")).reshape(B, T, Hkv, hd)
    if flags.use_rotary:
        q = apply_rotary(q, positions, spec.rotary_dim,
                         flags.rotary_interleaved, spec.rope_theta)
        k = apply_rotary(k, positions, spec.rotary_dim,
                         flags.rotary_interleaved, spec.rope_theta)

    new_cache = None
    if kv_cache is not None and page_table is not None:
        if cache_row_offsets is None:
            raise ValueError(
                "paged cache writes need cache_row_offsets (per-row "
                "logical start positions)"
            )
        if page_size is None or page_size <= 0:
            raise ValueError(f"page_table given but page_size={page_size}")
        k_entry, v_entry = kv_cache
        quantized = isinstance(k_entry, (tuple, list))
        if quantized:
            k_entry, v_entry = tuple(k_entry), tuple(v_entry)
        num_pages = _paged_write(k_entry, v_entry, k, v, page_table,
                                 page_size, cache_row_offsets)
        new_cache = kv_cache
        max_pages = page_table.shape[1]
        if paged_decode_fn is not None and T == 1:
            # the kernel reads the post-scatter pool without the drop
            # page; the bias collapses to the per-row validity lane
            if quantized:
                k_pages = (k_entry[0][:num_pages], k_entry[1][:num_pages])
                v_pages = (v_entry[0][:num_pages], v_entry[1][:num_pages])
            else:
                k_pages, v_pages = k_entry[:num_pages], v_entry[:num_pages]
            a = paged_decode_fn(
                q[:, 0].contiguous(), k_pages, v_pages,
                page_table.to(torch.int32).contiguous(),
                mask_bias.reshape(B, -1).float().contiguous(),
            )[:, None]
        else:
            ctx_pt = page_table.long().clamp(0, num_pages - 1)
            if quantized:
                k_ctx = dequantize_kv(k_entry[0][ctx_pt], k_entry[1][ctx_pt],
                                      q.dtype)
                v_ctx = dequantize_kv(v_entry[0][ctx_pt], v_entry[1][ctx_pt],
                                      q.dtype)
            else:
                k_ctx = k_entry[ctx_pt].to(q.dtype)
                v_ctx = v_entry[ctx_pt].to(q.dtype)
            k_ctx = k_ctx.reshape(B, max_pages * page_size, Hkv, hd)
            v_ctx = v_ctx.reshape(B, max_pages * page_size, Hkv, hd)
            a = attention_fn(q, k_ctx, v_ctx, mask_bias)
    elif kv_cache is not None and cache_row_offsets is not None:
        # the contiguous slot pool: one fresh token per row, written at
        # its own offset. JAX drops an out-of-range write (mode="drop");
        # here it goes to the pool's trailing drop position (and a row
        # past the slots to its drop row), which attention never reads
        if T != 1:
            raise ValueError(
                f"cache_row_offsets (per-row cache writes) requires a "
                f"single fresh token per row, got T={T}"
            )
        k_cache, v_cache = kv_cache
        tlog = mask_bias.shape[-1]
        if k_cache.shape[1] != tlog + 1 or k_cache.shape[0] < B:
            raise ValueError(
                f"per-row writes need the contiguous slot pool's drop "
                f"row and position (init_slot_pool): cache "
                f"{tuple(k_cache.shape[:2])} for {B} rows of {tlog}")
        rows = torch.arange(B, device=k.device)
        off = cache_row_offsets.long()
        off = torch.where((off >= 0) & (off < tlog), off,
                          torch.full_like(off, tlog))
        k_cache[rows, off] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, off] = v[:, 0].to(v_cache.dtype)
        new_cache = kv_cache
        a = attention_fn(q, k_cache[:B, :tlog].to(q.dtype),
                         v_cache[:B, :tlog].to(q.dtype), mask_bias)
    elif kv_cache is not None:
        k_cache, v_cache = kv_cache
        tbuf = k_cache.shape[1]
        # dynamic_update_slice clamps the start so the update fits
        if torch.is_tensor(cache_offset):  # a device offset: no host read
            idx = cache_offset.long().clamp(0, tbuf - T) + torch.arange(
                T, device=k.device)
            k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
            v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
        else:
            off = min(max(int(cache_offset or 0), 0), tbuf - T)
            k_cache[:, off:off + T] = k.to(k_cache.dtype)
            v_cache[:, off:off + T] = v.to(v_cache.dtype)
        new_cache = (k_cache, v_cache)
        if paged_decode_fn is not None and cache_page_table is not None \
                and T == 1:
            ps = tbuf // cache_page_table.shape[1]
            pages = (-1, ps) + tuple(k_cache.shape[2:])
            a = paged_decode_fn(
                q[:, 0].contiguous(), k_cache.view(pages),
                v_cache.view(pages), cache_page_table,
                mask_bias.reshape(B, -1).float().contiguous(),
            )[:, None]
        else:
            a = attention_fn(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                             mask_bias)
    else:
        a = attention_fn(q, k, v, mask_bias)

    def row_parallel(y, w, b=None, group=None):
        if group is None:
            return _project(y, w, b)
        y = group.reduce(_project(y, w))
        return y if b is None else y + b.to(y.dtype)

    a = row_parallel(a.reshape(B, T, H * hd), attn["wo"], attn.get("bo"),
                     tp_attn)

    def mlp(mlp_in):
        mp = p["mlp"]
        if tp_mlp is not None:
            mlp_in = tp_mlp.enter(mlp_in)
        if flags.swiglu:
            gate = F.silu(_project(mlp_in, mp["w_gate"]))
            return row_parallel(gate * _project(mlp_in, mp["w_in"]),
                                mp["w_out"], group=tp_mlp)
        return row_parallel(
            gelu_new(_project(mlp_in, mp["w_in"], mp["b_in"])),
            mp["w_out"],
            mp["b_out"],
            tp_mlp,
        )

    if flags.parallel_block:
        mlp_in = layer_norm(p["ln_2"], h, eps) if flags.separate_mlp_ln else x
        return h + a + mlp(mlp_in), new_cache

    h = h + a
    return h + mlp(layer_norm(p["ln_2"], h, eps)), new_cache


# ---------------------------------------------------------------------------
# Trunk application
# ---------------------------------------------------------------------------


def causal_mask_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """Additive [B, 1, T, T] float32 bias combining causality and padding
    (attention_mask: [B, T], 1 = real token)."""
    B, T = attention_mask.shape
    causal = torch.tril(
        torch.ones((T, T), dtype=torch.bool, device=attention_mask.device)
    )
    allowed = causal[None, :, :] & (attention_mask[:, None, :] > 0)
    return torch.where(allowed, 0.0, NEG_INF).float()[:, None, :, :]


def positions_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """Position ids starting at 0 on the first *real* token (left-padding
    safe)."""
    pos = torch.cumsum(attention_mask.long(), dim=-1) - 1
    return pos.clamp(min=0)


def mask_arg_for(attention_fn, attention_mask: torch.Tensor) -> torch.Tensor:
    """The mask argument an attention_fn expects: the raw [B, T] mask for
    one that declares ``takes_raw_mask`` (the flash kernels build their
    bias per tile), else the additive causal + padding bias."""
    if getattr(attention_fn, "takes_raw_mask", False):
        return attention_mask
    return causal_mask_bias(attention_mask)


def apply_blocks(blocks, spec, h, mask_bias, positions,
                 attention_fn=attention_scores, remat: bool = False,
                 tp=None):
    """Run stacked blocks over `h` (dense, no cache). ``remat``
    recomputes each block in the backward instead of keeping its
    activations (``torch.utils.checkpoint``; only while grad is on).
    ``tp``: :func:`block_apply`'s tensor parallelism."""
    flags = ArchFlags.for_spec(spec)
    for i in range(num_layers(blocks)):
        p_i = layer_params(blocks, i)
        if remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            h = checkpoint(
                lambda x, p=p_i: block_apply(spec, flags, p, x, mask_bias,
                                             positions,
                                             attention_fn=attention_fn,
                                             tp=tp)[0],
                h, use_reentrant=False,
            )
        else:
            h, _ = block_apply(spec, flags, p_i, h, mask_bias, positions,
                               attention_fn=attention_fn, tp=tp)
    return h


def init_kv_cache(spec: ModelSpec, n_layers: int, batch: int,
                  buffer_len: int, dtype=torch.bfloat16, device=None,
                  kv_heads: Optional[int] = None):
    """(k, v) buffers [L, B, buffer_len, Hkv, hd] (compact KV heads;
    ``kv_heads`` the heads one process of a tp mesh holds)."""
    shape = (n_layers, batch, buffer_len, kv_heads or spec.kv_heads,
             spec.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


#: floor added to int8 KV scales so all-zero rows quantize to codes 0
KV_QUANT_EPS = 1e-8


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over head_dim: (codes int8 [..., hd],
    scale f32 [...]) — one scale per (token, kv-head)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1) / 127.0 + KV_QUANT_EPS
    codes = torch.clamp(
        torch.round(x32 / scale[..., None]), -127, 127
    ).to(torch.int8)
    return codes, scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype):
    """Inverse of :func:`quantize_kv` (error <= scale/2 per element)."""
    return (codes.float() * scale[..., None]).to(dtype)


def init_paged_kv_cache(spec: ModelSpec, n_layers: int, num_pages: int,
                        page_size: int, dtype=torch.bfloat16, device=None,
                        kv_heads: Optional[int] = None):
    """(k, v) page pools [L, num_pages + 1, page_size, Hkv, hd]: the global
    pool of fixed-size KV pages shared by every slot, plus one trailing
    DROP page that absorbs sentinel writes (module docstring). Under tp
    each process's pool holds its ``kv_heads``.

    ``dtype=torch.int8`` selects the quantized tier: each of k/v becomes
    a ``(codes int8 [...], scales f32 [L, num_pages + 1, page_size,
    Hkv])`` pair.
    """
    shape = (n_layers, num_pages + 1, page_size, kv_heads or spec.kv_heads,
             spec.head_dim)

    def zeros(s, dt):
        return torch.zeros(s, dtype=dt, device=device)

    if dtype == torch.int8:
        sshape = shape[:-1]
        return ((zeros(shape, torch.int8), zeros(sshape, torch.float32)),
                (zeros(shape, torch.int8), zeros(sshape, torch.float32)))
    return zeros(shape, dtype), zeros(shape, dtype)


def apply_blocks_with_cache(blocks, cache, spec, h, mask_bias, positions,
                            cache_offset: int = 0,
                            attention_fn=attention_scores, tp=None,
                            segment: int = 0):
    """Run stacked blocks writing/reading a dense KV cache (prefill):
    cache = ([L, B, S, Hkv, hd], ...), updated in place. ``tp``: a serve
    mesh's ``DecodeParallel`` (trlx_tpu_torch.serve.layouts), whose
    ``layer`` gathers block segment ``segment``'s layers on use."""
    flags = ArchFlags.for_spec(spec)
    k_all, v_all = cache
    for i in range(num_layers(blocks)):
        p_i = layer_params(blocks, i)
        if tp is not None:
            p_i = tp.layer(segment, p_i)
        h, _ = block_apply(
            spec, flags, p_i, h, mask_bias, positions,
            kv_cache=(k_all[i], v_all[i]), cache_offset=cache_offset,
            attention_fn=attention_fn, tp=tp,
        )
    return h, cache


def embed_tokens(embed: Params, spec: ModelSpec, tokens: torch.Tensor,
                 positions: torch.Tensor,
                 compute_dtype=torch.bfloat16, tp=None) -> torch.Tensor:
    """Token (+ learned position) embeddings. Indices are clamped into
    range, as JAX's gathers clamp. ``tp`` (a serve mesh's
    ``DecodeParallel``): ``wte`` may be this process's vocabulary shard,
    looked up masked and summed over the tp group."""
    if tokens.shape[-1] > spec.n_positions:
        raise ValueError(
            f"sequence length {tokens.shape[-1]} exceeds n_positions "
            f"{spec.n_positions}"
        )
    wte = embed["wte"]
    if tp is not None:
        h = tp.embed_rows(wte, tokens).to(compute_dtype)
    else:
        h = wte[tokens.long().clamp(0, wte.shape[0] - 1)].to(compute_dtype)
    if "wpe" in embed:
        wpe = embed["wpe"]
        h = h + wpe[positions.long().clamp(0, wpe.shape[0] - 1)].to(
            compute_dtype
        )
    return h


def project_logits(embed: Params, spec: ModelSpec,
                   h_normed: torch.Tensor, tp=None) -> torch.Tensor:
    """(Tied or untied) LM head on layernormed hidden; float32 logits.
    ``tp`` (a serve mesh's ``DecodeParallel``): the head may be this
    process's vocabulary shard, whose logits are gathered whole."""
    if spec.tie_lm_head:
        logits = h_normed @ embed["wte"].t().to(h_normed.dtype)
    else:
        head = embed["lm_head"]
        logits = h_normed @ head["w"].to(h_normed.dtype) \
            + head["b"].to(h_normed.dtype)
    if tp is not None:
        logits = tp.whole_vocab(logits)
    return logits.float()


def lm_logits(embed: Params, ln_f: Params, spec: ModelSpec,
              h: torch.Tensor) -> torch.Tensor:
    """Final layernorm + LM head; float32 logits."""
    return project_logits(embed, spec,
                          layer_norm(ln_f, h, spec.layer_norm_epsilon))
