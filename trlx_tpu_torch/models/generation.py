"""Slot-pool serving primitives over a paged or a contiguous KV pool
(port of trlx_tpu.models.generation ``:588-1244``).

- :func:`prefill_into_slots` writes a prompt bucket's KV into the pool
  and leaves each slot's first-step logits in its lanes: through per-row
  page tables (the paged pool; with ``prefix_context=True`` the
  unmatched suffix attends to committed prefix pages — the radix-cache
  path), or into one region per slot (the contiguous pool,
  :func:`init_slot_pool`).
- :func:`decode_step` emits ONE token for every slot: free and finished
  slots ride along (static shapes) but emit nothing, and their writes go
  to the pool's drop page (paged) or land in their own row (contiguous).
- :func:`verify_step` scores K proposed tokens per slot and the free
  token in one pass (speculative decoding, paged pool only, greedy).

Under greedy decode a row's tokens are identical to decoding it alone:
masked positions contribute exactly zero probability.

:func:`generate` is the trainer's rollout decoder (``:196-587``): a
static-shape dense KV cache over left-padded prompts, request to
completion, one captured step per token (:class:`RolloutDecoder`),
whose attention reads the dense cache in place as pages through the
paged-decode kernel wherever :func:`rollout_page_size` finds a page
size for the shape.

All of them keep the CUDA-graph contract of trlx_tpu_torch.utils.aotjit
(static shapes, no host read), and the serve runtime and the trainers
replay them as graphs on the card. Torch vs JAX, made explicit here:
JAX's ``mode="drop"`` scatters become a one-hot select (filler rows at
``slot_id >= num_slots`` match no slot), masked writes (``offset == T``
on finished slots), the pools' drop page, drop row and drop position,
and a gather-and-select for the verify pass's ``valid`` lanes; the
pool and the per-slot lanes (:class:`SlotState`) are updated IN PLACE,
where JAX returns new arrays.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.configs import ModelSpec
from trlx_tpu_torch.models.transformer import (
    NEG_INF,
    ArchFlags,
    apply_blocks_with_cache,
    attention_scores,
    block_apply,
    causal_mask_bias,
    embed_tokens,
    init_kv_cache,
    init_paged_kv_cache,
    layer_norm,
    layer_params,
    num_layers,
    positions_from_mask,
    project_logits,
    quantize_kv,
    tree_map,
)
from trlx_tpu_torch.ops.paged_attention import (
    _SMEM_LIMIT,
    _SUPPORTED,
    HEAD_DIMS,
    decode_partitions,
    paged_decode_attention,
    shared_memory_bytes,
)
from trlx_tpu_torch.ops.sampling import SamplingParams, sample_token
from trlx_tpu_torch.utils.aotjit import aot_jit


class GenerationConfig(NamedTuple):
    """Decode settings: ``gen_size`` new tokens for :func:`generate` (the
    slot primitives cap per request through ``max_new`` instead),
    sampling, eos handling."""

    gen_size: int
    sampling: SamplingParams = SamplingParams()
    eos_token_id: int = -1  # -1 disables eos termination
    pad_token_id: int = 0
    min_new_tokens: int = 0  # eos suppressed before this many tokens

    @classmethod
    def from_gen_kwargs(cls, gen_size: int, gen_kwargs: dict,
                        eos_token_id=-1, pad_token_id=0,
                        prompt_len: int = 0) -> "GenerationConfig":
        """Translate HF-style gen_kwargs (max_length / min_length /
        top_k / top_p / do_sample / temperature / max_new_tokens), as
        trlx_tpu does: ``min_length`` counts prompt + generated tokens,
        and ``min_length >= max_length`` means fixed-length generation
        (eos fully suppressed); an explicit ``max_new_tokens`` overrides
        ``gen_size``, which is then a ceiling it may not exceed."""
        max_new = gen_kwargs.get("max_new_tokens")
        if max_new is not None:
            max_new = int(max_new)
            if max_new <= 0:
                raise ValueError(
                    f"gen_kwargs max_new_tokens={max_new} must be >= 1")
            if max_new > gen_size:
                raise ValueError(
                    f"gen_kwargs max_new_tokens={max_new} exceeds the "
                    f"generation length ceiling (gen_size) of {gen_size}")
            gen_size = max_new
        min_len = int(gen_kwargs.get("min_length", 0) or 0)
        max_len = int(gen_kwargs.get("max_length", 0) or 0)
        if min_len and min_len >= max_len:
            min_new = gen_size
        else:
            min_new = max(0, min(min_len - prompt_len, gen_size))
        return cls(
            gen_size=gen_size,
            sampling=SamplingParams(
                temperature=float(gen_kwargs.get("temperature", 1.0)),
                top_k=int(gen_kwargs.get("top_k", 0) or 0),
                top_p=float(gen_kwargs.get("top_p", 1.0)),
                do_sample=bool(gen_kwargs.get("do_sample", True)),
            ),
            eos_token_id=eos_token_id,
            pad_token_id=pad_token_id,
            min_new_tokens=min_new,
        )


class GenerationOutput(NamedTuple):
    sequences: torch.Tensor  # [B, P+G] prompt ++ generated (pads after eos)
    gen_tokens: torch.Tensor  # [B, G]
    gen_logprobs: torch.Tensor  # [B, G] logprob of the emitted token
    gen_mask: torch.Tensor  # [B, G] 1 while not finished (eos included)
    attention_mask: torch.Tensor  # [B, P+G] prompt mask ++ ones


#: stop decoding once every row has finished (tests A/B it)
_EOS_EARLY_EXIT = True

#: decode steps between two reads of "has every row finished?" (one
#: device-to-host copy each, through pinned memory on the card); tests
#: A/B it
_EXIT_CHECK_EVERY = 8

#: the page the rollout decoder views its dense cache in. At B 32, 576
#: keys, 16 heads of 256, bf16 (the PPO TL;DR rollout; chip_smoke.py's
#: rollout row on an H100) pages of 16, 32 and 64 took 102.8, 103.2 and
#: 113.2 us a layer with every key live and 78.0, 83.6 and 93.3 us over
#: left-padded prompts; 16 also divides whatever 32 or 64 does
ROLLOUT_PAGE_SIZE = 16


def rollout_page_size(B: int, S: int, H: int, Hkv: int, hd: int, q_dtype,
                      cache_dtype, device) -> Optional[int]:
    """The page size at which the rollout decoder's step reads its dense
    [B, S, Hkv, hd] cache through the paged-decode kernel
    (trlx_tpu_torch.ops.paged_attention), or None for the plain
    ``attention_scores`` path: :data:`ROLLOUT_PAGE_SIZE` where it
    divides S, the kernel is built for ``hd`` and for the (query, cache)
    dtype pair, and its block fits the card's shared memory. The same
    rule on the CPU, where the kernel's plain version runs."""
    ps = ROLLOUT_PAGE_SIZE
    if torch.device(device).type not in ("cuda", "cpu") or S % ps \
            or hd not in HEAD_DIMS \
            or (q_dtype, cache_dtype) not in _SUPPORTED:
        return None
    per = decode_partitions(B, Hkv, S // ps, ps)[1]
    if shared_memory_bytes(H, Hkv, hd, ps, per, cache_dtype) > _SMEM_LIMIT:
        return None
    return ps


class DecodeBuffers(NamedTuple):
    """The rollout decoder's state between steps, updated in place so a
    captured step reads and writes the same memory on every replay."""

    caches: tuple  # per segment (k, v) [L_seg, B, P + G, Hkv, hd]
    buffer_mask: torch.Tensor  # [B, P + G] int32: prompt mask ++ ones
    real_len: torch.Tensor  # [B] int64 real prompt tokens
    step: torch.Tensor  # [] int64 tokens emitted so far
    prev_tok: torch.Tensor  # [B] int64 the last token (or prompt token)
    h_normed: torch.Tensor  # [B, D] post-ln_f hidden of the last token
    logits: torch.Tensor  # [B, V] float32 the next token's logits
    finished: torch.Tensor  # [B] bool
    gen_tokens: torch.Tensor  # [B, G] int64
    gen_logprobs: torch.Tensor  # [B, G] float32
    gen_mask: torch.Tensor  # [B, G] int32
    all_finished: torch.Tensor  # [1] bool on the host (pinned on the card)
    # [B, S / ps] int32: row b's pages b * S / ps .. (b + 1) * S / ps - 1
    # of a layer's cache viewed as [B * S / ps, ps, Hkv, hd]; None where
    # the step attends through the plain path (rollout_page_size)
    page_table: Optional[torch.Tensor] = None


def _new_buffers(spec, seg_sizes, B, P, G, compute_dtype, cache_dtype,
                 dev, kv_heads=None) -> DecodeBuffers:
    S = P + G
    kv_heads = kv_heads or spec.kv_heads
    heads = spec.n_head // spec.kv_heads * kv_heads  # this process's
    ps = rollout_page_size(B, S, heads, kv_heads, spec.head_dim,
                           compute_dtype, cache_dtype, dev)
    page_table = None if ps is None else torch.arange(
        B * (S // ps), dtype=torch.int32, device=dev).reshape(B, S // ps)

    def empty(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    return DecodeBuffers(
        caches=tuple(init_kv_cache(spec, size, B, S, cache_dtype, dev,
                                   kv_heads)
                     for size in seg_sizes),
        buffer_mask=empty(B, S, dtype=torch.int32),
        real_len=empty(B, dtype=torch.long),
        step=empty(dtype=torch.long),
        prev_tok=empty(B, dtype=torch.long),
        h_normed=empty(B, spec.d_model, dtype=compute_dtype),
        logits=empty(B, spec.vocab_size, dtype=torch.float32),
        finished=empty(B, dtype=torch.bool),
        gen_tokens=empty(B, G, dtype=torch.long),
        gen_logprobs=empty(B, G, dtype=torch.float32),
        gen_mask=empty(B, G, dtype=torch.int32),
        all_finished=torch.empty(1, dtype=torch.bool,
                                 pin_memory=dev.type == "cuda"),
        page_table=page_table,
    )


class RolloutDecoder:
    """What :func:`generate` keeps between calls: its per-token step
    behind :func:`~trlx_tpu_torch.utils.aotjit.aot_jit` (one CUDA graph
    per signature on the card) and, per shape, the
    :class:`DecodeBuffers` those graphs read. A trainer holds one for its
    life; ``generate`` without one makes a fresh decoder."""

    def __init__(self):
        self.step = aot_jit(_decode_token)
        self._buffers = {}

    def buffers(self, spec, seg_sizes, B, P, G, compute_dtype, cache_dtype,
                dev, kv_heads=None) -> DecodeBuffers:
        kv_heads = kv_heads or spec.kv_heads
        key = (spec.vocab_size, spec.d_model, kv_heads, spec.head_dim,
               tuple(seg_sizes), B, P, G, compute_dtype, cache_dtype,
               str(dev))
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = _new_buffers(
                spec, seg_sizes, B, P, G, compute_dtype, cache_dtype, dev,
                kv_heads)
        return buf


def _decode_token(spec, segments, embed, ln_f, buf: DecodeBuffers,
                  generator, config, compute_dtype, attention_fn,
                  logit_mask, extras_fn, rows=None, tp=None) -> None:
    """One decode step of :func:`generate`, in place on ``buf``: emit the
    token of column ``buf.step`` from the carried logits, then forward it
    against the cache. Static shapes and no host read, so it replays as
    one CUDA graph; the last step's forward feeds nothing but keeps every
    step the same program. ``rows``: :func:`sample_token`'s (start,
    total) on a training mesh, whose step runs no collective. ``tp``: a
    serve mesh's ``DecodeParallel`` (the draft model of speculation),
    whose collectives the step captures: every process of the mesh
    replays it in the same order."""
    B, S = buf.buffer_mask.shape
    G = config.gen_size
    P = S - G
    dev = buf.logits.device
    step = buf.step
    step_logits = buf.logits
    if extras_fn is not None:
        step_logits = extras_fn(buf.h_normed, step_logits, buf.prev_tok)
    if logit_mask is not None:
        step_logits = torch.where(logit_mask, step_logits, NEG_INF)
    eos = config.eos_token_id
    if eos >= 0 and config.min_new_tokens > 0:
        eos_col = torch.arange(step_logits.shape[-1], device=dev) == eos
        step_logits = torch.where(eos_col & (step < config.min_new_tokens),
                                  NEG_INF, step_logits)
    logz = torch.logsumexp(step_logits, dim=-1)
    tok = sample_token(generator, step_logits, config.sampling, rows)
    logprob = torch.gather(step_logits, 1, tok[:, None])[:, 0] - logz
    finished = buf.finished.clone()
    tok = torch.where(finished, config.pad_token_id, tok)
    logprob = torch.where(finished, 0.0, logprob)
    col = step.view(1, 1).expand(B, 1)
    buf.gen_tokens.scatter_(1, col, tok[:, None])
    buf.gen_logprobs.scatter_(1, col, logprob[:, None])
    buf.gen_mask.scatter_(1, col, (~finished).int()[:, None])
    if eos >= 0:
        buf.finished.copy_(finished | (tok == eos))
    buf.prev_tok.copy_(tok)

    flags = ArchFlags.for_spec(spec)
    offset = P + step
    pos = (buf.real_len + step)[:, None]
    embed, ln_f = _head(tp, embed, ln_f)
    h = embed_tokens(embed, spec, tok[:, None], pos, compute_dtype, tp)
    key_valid = (torch.arange(S, device=dev)[None, :] <= offset) \
        & (buf.buffer_mask > 0)
    bias = torch.where(key_valid, 0.0, NEG_INF).float()[:, None, None, :]
    for s, (seg, (k_c, v_c)) in enumerate(zip(segments, buf.caches)):
        for i in range(num_layers(seg)):
            h, _ = block_apply(
                spec, flags, _layer(tp, s, seg, i), h, bias, pos,
                kv_cache=(k_c[i], v_c[i]), cache_offset=offset,
                attention_fn=attention_fn,
                paged_decode_fn=paged_decode_attention,
                cache_page_table=buf.page_table, tp=tp,
            )
    h_normed = layer_norm(ln_f, h[:, 0], spec.layer_norm_epsilon)
    buf.h_normed.copy_(h_normed)
    buf.logits.copy_(project_logits(embed, spec, h_normed, tp))
    buf.step.add_(1)


def _all_finished(buf: DecodeBuffers, mesh=None) -> bool:
    """Whether every row has finished: one small device-to-host read
    (non-blocking into pinned memory on the card, then a wait on it). On
    a mesh, every row of every process (one all-reduce), so all of them
    stop at the same step and their generators stay in step."""
    flag = buf.finished.all().reshape(1)
    if mesh is not None:
        import torch.distributed as dist

        flag = flag.int()
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        flag = flag.bool()
    if flag.device.type != "cuda":
        return bool(flag)
    buf.all_finished.copy_(flag, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return bool(buf.all_finished[0])


def _phase(name: str, args: Optional[dict]):
    """The telemetry device phase ``name`` with ``args``; none without
    them."""
    if args is None:
        return telemetry.NULL_SPAN
    return telemetry.device_phase(name, **args)


@torch.no_grad()
def generate(
    spec: ModelSpec,
    blocks,
    embed,
    ln_f,
    prompt_tokens: torch.Tensor,
    prompt_mask: torch.Tensor,
    generator: Optional[torch.Generator],
    config: GenerationConfig,
    compute_dtype=torch.bfloat16,
    cache_dtype=torch.bfloat16,
    attention_fn=attention_scores,
    logit_mask: Optional[torch.Tensor] = None,
    extras_fn: Optional[Callable] = None,
    decoder: Optional[RolloutDecoder] = None,
    mesh=None,
    tp=None,
    phase_args: Optional[dict] = None,
) -> GenerationOutput:
    """Decode ``config.gen_size`` tokens per row from LEFT-padded prompts
    (the rollout decoder; port of trlx_tpu.models.generation.generate).

    One prefill over the prompt fills a static-shape dense KV cache
    [B, P + G] per layer (``blocks`` is one stacked tree or the (frozen
    bottom, trainable top) segments, run in order), then one token per
    step against the cache. Each step's distribution is the previous
    logits with ``logit_mask`` applied and eos suppressed for the first
    ``min_new_tokens`` steps; the recorded logprob is that distribution's
    (unwarped) logprob of the drawn token. After a row emits eos it emits
    ``pad_token_id`` with ``gen_mask`` 0 and logprob 0.

    The prefill runs eagerly into ``decoder``'s buffers; each token is
    one call of the decoder's step (a CUDA-graph replay on the card), so
    ``extras_fn`` and ``logit_mask`` must keep its contract
    (trlx_tpu_torch.utils.aotjit). When eos can end rows early, every
    :data:`_EXIT_CHECK_EVERY` steps one read tells whether every row has
    finished, and decoding then stops (the remaining steps would emit
    only pads). The CPU runs the same chunked loop, so the generator
    ends in the same state with graphs on or off.

    The prefill attends with ``attention_fn``. A step's attention (one
    query row a sequence against its cache) runs the paged-decode
    kernel (trlx_tpu_torch.ops.paged_attention, its plain version on the
    CPU) over the dense cache read in place as pages, where
    :func:`rollout_page_size` takes the shape and dtypes; elsewhere
    ``attention_fn`` over the whole cache, as the prefill.

    With a ``mesh`` (trlx_tpu_torch.parallel) the prompts are DTensors
    whose rows shard over (dp, fsdp) and the parameters whole plain
    tensors: each process decodes its rows, draws as one process would
    (``sample_token``'s ``rows``), stops when every process's rows have
    finished, and the outputs come back whole on every process.

    ``tp`` (a serve mesh's ``DecodeParallel``, trlx_tpu_torch.serve.
    layouts) runs the parameters as each process's shards instead: every
    process decodes every row with its heads, the same tokens.

    With ``phase_args`` (a PPO rollout chunk's ``chunk`` and ``rows``)
    the prefill and the decode loop, early-exit reads included, run as
    the telemetry phases ``rollout/prefill`` and ``rollout/decode`` with
    those arguments, and the steps count into the telemetry counters
    ``rollout/decode_kernel_steps`` or ``rollout/decode_plain_steps``
    by the path their attention took; without, as no phase.
    """
    rows = None
    if mesh is not None:
        from trlx_tpu_torch.parallel.sharding import (
            gather_rows,
            local_rows,
            row_range,
        )

        total = prompt_tokens.shape[0]
        rows = (row_range(mesh, total)[0], total)
        prompt_tokens = local_rows(prompt_tokens)
        prompt_mask = local_rows(prompt_mask)
    B, P = prompt_tokens.shape
    G = config.gen_size
    S = P + G
    if S > spec.n_positions:
        raise ValueError(
            f"prompt ({P}) + gen_size ({G}) = {S} exceeds the model's "
            f"n_positions ({spec.n_positions})"
        )
    decoder = decoder or RolloutDecoder()
    dev = prompt_tokens.device
    segments, seg_sizes = _segments_of(blocks)
    prompt_tokens = prompt_tokens.long()
    prompt_mask = prompt_mask.to(torch.int32)
    buf = decoder.buffers(spec, seg_sizes, B, P, G, compute_dtype,
                          cache_dtype, dev, _kv_heads(tp, spec))
    with _phase("rollout/prefill", phase_args):
        real_len = prompt_mask.long().sum(-1)  # [B]
        positions = positions_from_mask(prompt_mask)
        embed_g, ln_f_g = _head(tp, embed, ln_f)
        h = embed_tokens(embed_g, spec, prompt_tokens, positions,
                         compute_dtype, tp)
        prefill_bias = torch.cat([
            causal_mask_bias(prompt_mask),
            torch.full((B, 1, P, G), NEG_INF, dtype=torch.float32,
                       device=dev),
        ], dim=-1)
        for s, (seg, cache) in enumerate(zip(segments, buf.caches)):
            for c in cache:
                c.zero_()
            h, _ = apply_blocks_with_cache(seg, cache, spec, h,
                                           prefill_bias, positions, 0,
                                           attention_fn, tp, s)
        h_normed = layer_norm(ln_f_g, h[:, -1], spec.layer_norm_epsilon)
        buf.h_normed.copy_(h_normed)
        buf.logits.copy_(project_logits(embed_g, spec, h_normed, tp))
        last = (real_len - 1).clamp(min=0)[:, None]
        buf.prev_tok.copy_(torch.gather(prompt_tokens, 1, last)[:, 0])
        buf.buffer_mask[:, :P].copy_(prompt_mask)
        buf.buffer_mask[:, P:].fill_(1)
        buf.real_len.copy_(real_len)
        buf.step.zero_()
        buf.finished.zero_()
        buf.gen_tokens.fill_(config.pad_token_id)
        buf.gen_logprobs.zero_()
        buf.gen_mask.zero_()

    early_exit = (_EOS_EARLY_EXIT and config.eos_token_id >= 0
                  and config.min_new_tokens < G)
    with _phase("rollout/decode", phase_args):
        done = 0
        while done < G:
            chunk = min(_EXIT_CHECK_EVERY, G - done)
            for _ in range(chunk):
                decoder.step(spec, segments, embed, ln_f, buf, generator,
                             config, compute_dtype, attention_fn, logit_mask,
                             extras_fn, rows, tp)
            done += chunk
            if phase_args is not None:
                kernel = buf.page_table is not None
                telemetry.inc("rollout/decode_kernel_steps",
                              chunk if kernel else 0)
                telemetry.inc("rollout/decode_plain_steps",
                              0 if kernel else chunk)
            if early_exit and done < G and done > config.min_new_tokens \
                    and _all_finished(buf, mesh):
                break  # every later step emits pads only

    gen_tokens = buf.gen_tokens.clone()
    out = GenerationOutput(
        sequences=torch.cat([prompt_tokens, gen_tokens], dim=1),
        gen_tokens=gen_tokens,
        gen_logprobs=buf.gen_logprobs.clone(),
        gen_mask=buf.gen_mask.clone(),
        attention_mask=buf.buffer_mask.clone(),
    )
    if mesh is not None:
        out = GenerationOutput(*(gather_rows(x, mesh) for x in out))
    return out


class SlotState(NamedTuple):
    """Per-slot decode lanes riding next to the KV pool (all leading-S).

    ``valid`` [S, T] int32 marks pool positions holding real keys;
    ``offset`` the next write position, ``pos`` the next logical
    position, ``generated`` the emitted count against ``max_new``;
    ``active`` host occupancy, ``finished`` terminal-for-decode;
    ``logits`` [S, V] float32 each slot's next-token distribution;
    ``pages`` [S, max_pages] int32 the per-slot page table
    (unallocated entries at :data:`PAGE_SENTINEL`) under the paged
    layout, ``None`` under the contiguous one.
    """

    valid: torch.Tensor
    offset: torch.Tensor
    pos: torch.Tensor
    generated: torch.Tensor
    max_new: torch.Tensor
    active: torch.Tensor
    finished: torch.Tensor
    logits: torch.Tensor
    pages: Optional[torch.Tensor] = None


#: page-table entry meaning "no page here": past any real pool's page
#: count, so writes through it go to the drop page and reads clamp into
#: masked garbage
PAGE_SENTINEL = 2**30


def init_slot_state(num_slots: int, buffer_len: int, vocab_size: int,
                    max_pages: Optional[int] = None,
                    device=None) -> SlotState:
    """An all-free pool state: nothing active, everything finished.
    ``max_pages`` builds the paged variant (every page-table entry at
    the sentinel); ``None`` the contiguous one."""
    S = num_slots

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SlotState(
        valid=zeros(S, buffer_len),
        offset=zeros(S),
        pos=zeros(S),
        generated=zeros(S),
        max_new=zeros(S),
        active=zeros(S, dtype=torch.bool),
        finished=torch.ones((S,), dtype=torch.bool, device=device),
        logits=zeros(S, vocab_size, dtype=torch.float32),
        pages=None if max_pages is None else torch.full(
            (S, max_pages), PAGE_SENTINEL, dtype=torch.int32,
            device=device),
    )


def init_slot_pool(spec: ModelSpec, seg_sizes, num_slots: int,
                   buffer_len: int, cache_dtype=torch.bfloat16, device=None,
                   kv_heads: Optional[int] = None):
    """Per-segment (k, v) contiguous pools [L_seg, num_slots + 1,
    buffer_len + 1, Hkv, hd]: one region per slot. The last row is the
    drop row (a prefill filler row writes there) and the last position
    of each row the drop position (a write at ``offset == buffer_len``
    lands there); attention reads ``[:num_slots, :buffer_len]`` only.
    ``kv_heads``: the heads one process of a tp mesh holds."""
    return tuple(
        init_kv_cache(spec, size, num_slots + 1, buffer_len + 1,
                      cache_dtype, device, kv_heads)
        for size in seg_sizes
    )


def init_page_pool(spec: ModelSpec, seg_sizes, num_pages: int,
                   page_size: int, cache_dtype=torch.bfloat16, device=None,
                   kv_heads: Optional[int] = None):
    """Per-segment (k, v) page pools [L_seg, num_pages + 1, page_size,
    Hkv, hd] (the last page is the drop page); ``kv_heads`` as
    :func:`init_slot_pool`'s."""
    return tuple(
        init_paged_kv_cache(spec, size, num_pages, page_size, cache_dtype,
                            device, kv_heads)
        for size in seg_sizes
    )


def _segments_of(blocks):
    segments = tuple(blocks) if isinstance(blocks, (list, tuple)) \
        else (blocks,)
    return segments, [num_layers(s) for s in segments]


def _layer(tp, segment: int, seg, i: int):
    """Layer ``i`` of block segment ``segment``; on a serve mesh with its
    shards gathered on use (``DecodeParallel.layer``)."""
    p = layer_params(seg, i)
    return p if tp is None else tp.layer(segment, p)


def _head(tp, embed, ln_f):
    """(embed, ln_f), on a serve mesh with their fsdp shards gathered."""
    return (embed, ln_f) if tp is None else tp.head(embed, ln_f)


def _kv_heads(tp, spec) -> int:
    """The KV heads this process's caches hold."""
    return spec.kv_heads if tp is None else tp.kv_heads(spec)


def _kv_layer(entry, i):
    """Layer ``i`` of one side of a pool entry (tensor or (codes,
    scales)) — views, so writes land in the pool."""
    return tree_map(lambda x: x[i], entry)


def _pool_page_geometry(pool):
    """(num_pages, page_size) of a page pool in either KV tier."""
    k0 = pool[0][0]
    k0 = k0[0] if isinstance(k0, (tuple, list)) else k0
    return k0.shape[1] - 1, k0.shape[2]


def _as(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device).to(dtype)


def prefill_into_slots(
    spec: ModelSpec,
    blocks,
    embed,
    ln_f,
    pool,
    state: SlotState,
    prompt_tokens,  # [Bp, P]: right-padded (paged), left (contiguous)
    prompt_mask,  # [Bp, P]
    slot_ids,  # [Bp] host ints; == num_slots -> dropped filler row
    max_new,  # [Bp] per-request cap
    compute_dtype=torch.bfloat16,
    attention_fn=attention_scores,
    page_tables=None,  # [Bp, max_pages] int32
    page_size: Optional[int] = None,
    start=None,  # [Bp] page-aligned committed prefix length
    prefix_context: bool = False,
    tp=None,
):
    """Write a prompt bucket's KV + first-step logits into pool slots.

    Tokens are RIGHT-padded: a slot's buffer position equals its logical
    position, so requests sharing a token prefix share identical page
    content (what makes radix prefix caching content-addressable).
    ``start`` is each row's committed prefix length; the tokens passed
    are only the unmatched suffix, written at logical positions
    ``start + j``. ``prefix_context=True`` makes the suffix attend to the
    committed prefix pages gathered from the pool; ``False`` (all-zero
    ``start``) keeps attention local to the prompt — a local causal
    prefill whose cache takes the POOL's dtype, then one block-scatter.
    First-step logits come from each row's last REAL suffix token.

    Without ``page_tables`` the pool is the contiguous one
    (:func:`init_slot_pool`) and the prompts are LEFT-padded: the exact
    prefill :func:`generate` runs, on a local [Bp, P] cache, whose rows
    then land in positions ``[0, P)`` of their slots (a filler row in
    the pool's drop row).

    Shapes are static and nothing is read back to the host, so a bucket
    replays as one CUDA graph once its inputs are device tensors.

    ``tp``: a serve mesh's ``DecodeParallel`` (trlx_tpu_torch.serve.
    layouts): the parameters are this process's shards and the pool holds
    its KV heads.

    Returns ``(pool, state)``, both updated in place.
    """
    embed, ln_f = _head(tp, embed, ln_f)
    if page_tables is None:
        return _prefill_into_rows(
            spec, blocks, embed, ln_f, pool, state, prompt_tokens,
            prompt_mask, slot_ids, max_new, compute_dtype, attention_fn, tp)
    dev = state.valid.device
    tokens = _as(prompt_tokens, dev, torch.long)
    mask = _as(prompt_mask, dev, torch.int32)
    B, P = tokens.shape
    S, T = state.valid.shape
    if P > T:
        raise ValueError(
            f"prefill prompt_len {P} exceeds the slot buffer length {T}"
        )
    if page_size is None or page_size <= 0:
        raise ValueError(f"paged prefill needs page_size, got {page_size}")
    pt = _as(page_tables, dev, torch.int32)
    max_pages = pt.shape[1]
    if max_pages * page_size != T:
        raise ValueError(
            f"page table extent {max_pages} x {page_size} != slot buffer "
            f"length {T}"
        )
    segments, seg_sizes = _segments_of(blocks)
    flags = ArchFlags.for_spec(spec)
    suffix_len = mask.long().sum(-1)
    start = torch.zeros(B, dtype=torch.long, device=dev) if start is None \
        else _as(start, dev, torch.long)
    real_len = start + suffix_len
    positions = start[:, None] + torch.arange(P, device=dev)[None, :]
    h = embed_tokens(embed, spec, tokens, positions, compute_dtype, tp)

    num_pages, _ = _pool_page_geometry(pool)
    quantized = isinstance(pool[0][0], (tuple, list))
    if not prefix_context:
        # local causal prefill, then one block-scatter into the pages;
        # the int8 tier quantizes once at the scatter from the compute
        # dtype, as decode does (page content stays a function of tokens)
        cache_dtype = compute_dtype if quantized else pool[0][0].dtype
        bias = causal_mask_bias(mask)
        pos_buf = torch.arange(P, device=dev)
        pids = pt.long()[:, pos_buf // page_size]  # [Bp, P]
        pids = torch.where((pids >= 0) & (pids < num_pages), pids,
                           torch.full_like(pids, num_pages))
        ioff = pos_buf % page_size
        for s, (seg, size, (k_pool, v_pool)) in enumerate(
                zip(segments, seg_sizes, pool)):
            if size == 0:
                continue
            cache = init_kv_cache(spec, size, B, P, cache_dtype, dev,
                                  _kv_heads(tp, spec))
            h, (k_new, v_new) = apply_blocks_with_cache(
                seg, cache, spec, h, bias, positions, 0, attention_fn, tp, s,
            )
            if quantized:
                (k_codes, k_sc), (v_codes, v_sc) = k_pool, v_pool
                kq, ks = quantize_kv(k_new)
                vq, vs = quantize_kv(v_new)
                k_codes[:, pids, ioff] = kq
                k_sc[:, pids, ioff] = ks
                v_codes[:, pids, ioff] = vq
                v_sc[:, pids, ioff] = vs
            else:
                k_pool[:, pids, ioff] = k_new
                v_pool[:, pids, ioff] = v_new
    else:
        # key position p is visible to suffix token j of row b iff
        # p <= start[b] + j (causality over LOGICAL positions)
        allowed = torch.arange(T, device=dev)[None, None, :] \
            <= positions[:, :, None]
        bias = torch.where(allowed, 0.0, NEG_INF).float()[:, None]
        # bias: [Bp, 1, P, T]
        for s, (seg, size, (k_c, v_c)) in enumerate(
                zip(segments, seg_sizes, pool)):
            for i in range(size):
                h, _ = block_apply(
                    spec, flags, _layer(tp, s, seg, i), h, bias, positions,
                    kv_cache=(_kv_layer(k_c, i), _kv_layer(v_c, i)),
                    cache_row_offsets=start, page_table=pt,
                    page_size=page_size, attention_fn=attention_fn, tp=tp,
                )

    last_idx = (suffix_len - 1).clamp(min=0)
    h_last = h[torch.arange(B, device=dev), last_idx]  # [Bp, D]
    logits0 = project_logits(
        embed, spec, layer_norm(ln_f, h_last, spec.layer_norm_epsilon), tp
    )

    landed, src = _slot_rows(slot_ids, S, dev)
    real = real_len[src]
    caps = torch.minimum(_as(max_new, dev, torch.long)[src].clamp(min=0),
                         T - real)
    _land_rows(state, landed, {
        "valid": torch.arange(T, device=dev)[None, :] < real[:, None],
        "offset": real, "pos": real, "generated": torch.zeros_like(real),
        "max_new": caps, "active": torch.ones_like(landed),
        "finished": torch.zeros_like(landed), "logits": logits0[src],
        "pages": pt[src],
    })
    return pool, state


def _slot_rows(slot_ids, S, dev):
    """(landed [S], src [S]: the row each landed slot takes) of a
    bucket's slot ids: rows land in their slots by a one-hot select, so
    a filler row (slot id outside [0, S)) matches no slot and is
    dropped, as JAX's mode="drop" scatter drops it, with no host read of
    the ids."""
    slot_ids = _as(slot_ids, dev, torch.long)
    hit = slot_ids[None, :] == torch.arange(S, device=dev)[:, None]
    return hit.any(1), hit.int().argmax(1)


def _land_rows(state: SlotState, landed, rows) -> None:
    """Write each landed slot's new lane values in place."""
    S = landed.shape[0]
    for name, new in rows.items():
        lane = getattr(state, name)
        keep = landed.view(S, *([1] * (lane.dim() - 1)))
        lane.copy_(torch.where(keep, new.to(lane.dtype), lane))


def _prefill_into_rows(spec, blocks, embed, ln_f, pool, state,
                       prompt_tokens, prompt_mask, slot_ids, max_new,
                       compute_dtype, attention_fn, tp=None):
    """Contiguous half of :func:`prefill_into_slots`: generate()'s
    prefill over LEFT-padded prompts, then each row's [0, P) block into
    its slot's region (a filler row into the drop row)."""
    dev = state.valid.device
    tokens = _as(prompt_tokens, dev, torch.long)
    mask = _as(prompt_mask, dev, torch.int32)
    B, P = tokens.shape
    S, T = state.valid.shape
    if P > T:
        raise ValueError(
            f"prefill prompt_len {P} exceeds the slot buffer length {T}"
        )
    segments, seg_sizes = _segments_of(blocks)
    real_len = mask.long().sum(-1)
    positions = positions_from_mask(mask)
    h = embed_tokens(embed, spec, tokens, positions, compute_dtype, tp)
    bias = causal_mask_bias(mask)
    sid = _as(slot_ids, dev, torch.long)
    rows = torch.where((sid >= 0) & (sid < S), sid, torch.full_like(sid, S))
    for s, (seg, size, (k_pool, v_pool)) in enumerate(
            zip(segments, seg_sizes, pool)):
        if size == 0:
            continue
        cache = init_kv_cache(spec, size, B, P, k_pool.dtype, dev,
                              _kv_heads(tp, spec))
        h, (k_new, v_new) = apply_blocks_with_cache(
            seg, cache, spec, h, bias, positions, 0, attention_fn, tp, s)
        k_pool[:, rows, :P] = k_new
        v_pool[:, rows, :P] = v_new
    h_last = layer_norm(ln_f, h[:, -1], spec.layer_norm_epsilon)
    logits0 = project_logits(embed, spec, h_last, tp)  # [Bp, V]

    landed, src = _slot_rows(slot_ids, S, dev)
    caps = _as(max_new, dev, torch.long)[src].clamp(0, T - P)
    valid = torch.cat([mask, torch.zeros((B, T - P), dtype=torch.int32,
                                         device=dev)], dim=1)
    _land_rows(state, landed, {
        "valid": valid[src], "offset": torch.full_like(caps, P),
        "pos": real_len[src], "generated": torch.zeros_like(caps),
        "max_new": caps, "active": torch.ones_like(landed),
        "finished": torch.zeros_like(landed), "logits": logits0[src],
    })
    return pool, state


def decode_step(
    spec: ModelSpec,
    blocks,
    embed,
    ln_f,
    pool,
    state: SlotState,
    generator: Optional[torch.Generator],
    config: GenerationConfig,
    compute_dtype=torch.bfloat16,
    attention_fn=attention_scores,
    paged_decode_fn=None,
    tp=None,
):
    """One decode step for every pool slot: sample from each slot's
    carried logits, forward the sampled tokens against the pool at
    per-slot offsets/positions, advance the lanes.

    Paged pool: non-emitting slots (free, finished,
    harvested-awaiting-reuse) aim their page table at the sentinel so
    their writes vanish — a harvested slot's pages may already belong to
    another slot. Contiguous pool (``state.pages`` is None): every slot
    writes into its own row, an ``offset == T`` write into the drop
    position. ``paged_decode_fn`` (``serve.attention: pallas``, paged
    only) is handed to every layer's ``block_apply``; ``None`` keeps the
    plain gather path. ``tp`` as :func:`prefill_into_slots`' (the
    kernel then reads this process's heads).

    Returns ``(pool, state, tokens [S] int32, emitted [S], finished
    [S])`` with the pool and the lanes updated in place.
    """
    S, T = state.valid.shape
    dev = state.valid.device
    segments, seg_sizes = _segments_of(blocks)
    flags = ArchFlags.for_spec(spec)

    step_logits = state.logits
    if config.eos_token_id >= 0 and config.min_new_tokens > 0:
        eos_col = torch.arange(step_logits.shape[-1], device=dev) \
            == config.eos_token_id
        suppress = (state.generated < config.min_new_tokens)[:, None]
        step_logits = torch.where(eos_col & suppress, NEG_INF, step_logits)
    tok = sample_token(generator, step_logits, config.sampling)
    emitted = state.active & ~state.finished
    tok = torch.where(emitted, tok, config.pad_token_id)
    finished = state.finished
    if config.eos_token_id >= 0:
        finished = finished | (emitted & (tok == config.eos_token_id))
    generated = state.generated + emitted.int()
    finished = finished | (state.active & (generated >= state.max_new))

    # mark the fresh token's position valid BEFORE attention (it attends
    # to itself); a finished slot's offset may equal T — that write drops
    rows = torch.arange(S, device=dev)
    off = state.offset.long()
    off_c = off.clamp(max=T - 1)
    state.valid[rows, off_c] = torch.where(off < T, emitted.int(),
                                           state.valid[rows, off_c])
    bias = torch.where(state.valid > 0, 0.0, NEG_INF).float()[
        :, None, None, :]
    pos = state.pos.long()[:, None]
    embed, ln_f = _head(tp, embed, ln_f)
    h = embed_tokens(embed, spec, tok[:, None], pos, compute_dtype, tp)
    paged = state.pages is not None
    pt_step = page_size = None
    if paged:
        num_pages, page_size = _pool_page_geometry(pool)
        pt_step = torch.where(emitted[:, None], state.pages,
                              num_pages).to(torch.int32).contiguous()
    for s, (seg, size, (k_c, v_c)) in enumerate(
            zip(segments, seg_sizes, pool)):
        for i in range(size):
            h, _ = block_apply(
                spec, flags, _layer(tp, s, seg, i), h, bias, pos,
                kv_cache=(_kv_layer(k_c, i), _kv_layer(v_c, i)),
                cache_row_offsets=state.offset, page_table=pt_step,
                page_size=page_size, attention_fn=attention_fn,
                paged_decode_fn=paged_decode_fn if paged else None, tp=tp,
            )
    h_normed = layer_norm(ln_f, h, spec.layer_norm_epsilon)
    next_logits = project_logits(embed, spec, h_normed, tp)[:, 0]

    adv = emitted.int()
    state.offset.add_(adv)
    state.pos.add_(adv)
    state.generated.copy_(generated)
    state.finished.copy_(finished)
    state.logits.copy_(next_logits)
    return pool, state, tok.int(), emitted, finished


def verify_step(
    spec: ModelSpec,
    blocks,
    embed,
    ln_f,
    pool,
    state: SlotState,
    generator: Optional[torch.Generator],
    proposals: torch.Tensor,  # [S, K] speculated continuation tokens
    n_proposed: torch.Tensor,  # [S] how many of each row are real
    config: GenerationConfig,
    compute_dtype=torch.bfloat16,
    attention_fn=attention_scores,
    tp=None,
):
    """Speculative-decoding verification (port of trlx_tpu's
    ``verify_step``): score K proposed tokens per slot in ONE batched
    pass and emit the longest greedy-matching prefix plus the free token.

    Per slot the candidate row is ``[t0, proposals...]``, ``t0`` the
    token the slot's carried logits emit (what :func:`decode_step` would
    emit this step). All K + 1 candidates go forward together at logical
    positions ``pos + j``, attending over the committed positions
    (``state.valid``) plus the candidates before them. Proposal ``j`` is
    accepted iff it equals the argmax of the distribution after
    candidate ``j - 1`` and every earlier proposal was accepted; the
    emitted run is ``cand[:count]`` (eos truncates it and finishes the
    slot, as does the slot's ``max_new`` budget).

    Rejected candidates need no copy-back: they were written through the
    slot's own reserved pages, and the ``valid`` lanes come out marking
    exactly the accepted positions. The window may run past a row's
    buffer near its budget's end, so the page table is extended with
    sentinel entries: such writes go to the drop page (JAX's
    ``mode="drop"``) and the extra key columns are masked; the ``valid``
    update takes only in-range columns, by a gather and a select where
    JAX scatters with drop.

    Paged pool only; greedy only (the engine refuses speculation under
    sampling); the plain gather attention path (the paged-decode kernel
    takes one query row). Static shapes and no host read: one CUDA
    graph beside the step's.

    Returns ``(pool, state, cand [S, K+1] int32, counts [S] int32,
    finished [S])`` with the pool and the lanes updated in place.
    """
    if state.pages is None:
        raise ValueError(
            "verify_step requires the paged pool layout (state.pages); "
            "serve.speculation is gated on serve.kv_layout: paged"
        )
    S, K = proposals.shape
    Tc = K + 1
    T = state.valid.shape[1]
    dev = state.valid.device
    segments, seg_sizes = _segments_of(blocks)
    flags = ArchFlags.for_spec(spec)
    proposals = proposals.long()

    emitting = state.active & ~state.finished
    # at most remaining - 1 proposals can be accepted (t0 spends one)
    remaining = (state.max_new - state.generated).clamp(min=0)
    n = torch.minimum(n_proposed.long().clamp(0, K),
                      (remaining - 1).clamp(min=0).long())
    n = torch.where(emitting, n, 0)

    vocab = torch.arange(state.logits.shape[-1], device=dev)
    eos = config.eos_token_id
    suppress_eos = eos >= 0 and config.min_new_tokens > 0
    step_logits = state.logits
    if suppress_eos:
        suppress = (state.generated < config.min_new_tokens)[:, None]
        step_logits = torch.where((vocab == eos) & suppress, NEG_INF,
                                  step_logits)
    t0 = sample_token(generator, step_logits, config.sampling)
    cand = torch.cat([t0[:, None], proposals], dim=1)  # [S, Tc]
    cand = torch.where(emitting[:, None], cand, config.pad_token_id)

    # candidate j of row s sees the committed positions plus candidates
    # 0..j (the prefix-suffix prefill's logical causality)
    buf = torch.arange(T, device=dev)[None, None, :]
    j_idx = torch.arange(Tc, device=dev)[None, :, None]
    off = state.offset.long()[:, None, None]
    cand_vis = (buf >= off) & (buf <= off + j_idx) \
        & emitting[:, None, None]
    allowed = (state.valid[:, None, :] > 0) | cand_vis
    num_pages, page_size = _pool_page_geometry(pool)
    extra = -(-Tc // page_size)
    pt_step = torch.where(emitting[:, None], state.pages, num_pages)
    pt_v = torch.cat([pt_step, torch.full((S, extra), num_pages,
                                          dtype=pt_step.dtype, device=dev)],
                     dim=1).to(torch.int32).contiguous()
    bias = torch.cat([
        torch.where(allowed, 0.0, NEG_INF).float(),
        torch.full((S, Tc, extra * page_size), NEG_INF, dtype=torch.float32,
                   device=dev),
    ], dim=-1)[:, None]  # [S, 1, Tc, T + extra * page_size]

    positions = state.pos.long()[:, None] \
        + torch.arange(Tc, device=dev)[None, :]
    embed, ln_f = _head(tp, embed, ln_f)
    h = embed_tokens(embed, spec, cand, positions, compute_dtype, tp)
    for s, (seg, size, (k_c, v_c)) in enumerate(
            zip(segments, seg_sizes, pool)):
        for i in range(size):
            h, _ = block_apply(
                spec, flags, _layer(tp, s, seg, i), h, bias, positions,
                kv_cache=(_kv_layer(k_c, i), _kv_layer(v_c, i)),
                cache_row_offsets=state.offset, page_table=pt_v,
                page_size=page_size, attention_fn=attention_fn, tp=tp,
            )
    h_normed = layer_norm(ln_f, h, spec.layer_norm_epsilon)
    L = project_logits(embed, spec, h_normed, tp)  # [S, Tc, V]

    # proposal j (1-based emitted index) survives iff it is the greedy
    # token after candidate j - 1 and every earlier proposal survived
    jpos = torch.arange(1, K + 1, device=dev)[None, :]
    Lm = L[:, :K]
    if suppress_eos:
        sup = (state.generated[:, None] + jpos) < config.min_new_tokens
        Lm = torch.where((vocab == eos)[None, None, :] & sup[:, :, None],
                         NEG_INF, Lm)
    greedy = torch.argmax(Lm, dim=-1)  # [S, K]
    match = (proposals == greedy) & (jpos <= n[:, None])
    m = torch.cumprod(match.long(), dim=1).sum(dim=1)  # [S]

    # the emitted run cand_0..cand_m, cut after the first eos in it
    i_idx = torch.arange(Tc, device=dev)[None, :]
    within = i_idx <= m[:, None]
    if eos >= 0:
        is_eos = (cand == eos) & within
    else:
        is_eos = torch.zeros_like(within)
    eos_before = torch.cumsum(is_eos.long(), dim=1) - is_eos.long()
    emit_mask = within & (eos_before == 0) & emitting[:, None]
    counts = emit_mask.sum(dim=1)  # [S] in 0..K+1

    finished = state.finished
    if eos >= 0:
        finished = finished | (emitting & (is_eos & emit_mask).any(dim=1))
    generated = state.generated + counts.int()
    finished = finished | (state.active & (generated >= state.max_new))

    # exactly the accepted candidate positions become valid: column c of
    # row s takes emit_mask[s, c - offset[s]] inside the window; columns
    # past T belong to no lane (JAX drops those writes)
    rel = torch.arange(T, device=dev)[None, :] - state.offset.long()[:, None]
    in_win = (rel >= 0) & (rel < Tc)
    landed = torch.gather(emit_mask.int(), 1, rel.clamp(0, Tc - 1))
    state.valid.copy_(torch.where(in_win, landed, state.valid))

    # carried logits advance to the distribution after the LAST emitted
    # token, so the next step resumes on exactly the greedy prefix
    last = (counts - 1).clamp(min=0)
    next_logits = L[torch.arange(S, device=dev), last]
    state.logits.copy_(torch.where(emitting[:, None], next_logits,
                                   state.logits))
    state.offset.add_(counts.int())
    state.pos.add_(counts.int())
    state.generated.copy_(generated)
    state.finished.copy_(finished)
    return pool, state, cand.int(), counts.int(), finished
