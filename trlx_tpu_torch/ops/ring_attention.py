"""Ring attention: exact sequence-parallel attention over the ``sp`` mesh
axis (port of trlx_tpu.ops.ring_attention).

Each rank of the sp group holds one query chunk [B, T/sp, H, hd] and
one key / value chunk with its key mask. The K/V chunks travel the ring
(sp - 1 hops, :mod:`trlx_tpu_torch.parallel.exchange`), so every rank
meets every block; block pairs run through the flash kernels
(trlx_tpu_torch.ops.flash_attention):

- a diagonal pair (the rank's own chunk) with ``causal=True``;
- a pair below the diagonal with ``causal=False`` and the key mask;
- a pair above the diagonal is skipped (its hop still runs: every rank
  takes part in every exchange).

Each pair gives its O and float32 logsumexp; the rank merges them by
their lse (plain torch, as trlx_tpu's online softmax is jnp outside any
kernel). The backward (:class:`_RingAttention`) sends the K/V chunks
around the ring again with float32 dK/dV accumulators riding beside
them, which come home after one more hop; dq accumulates where it is.
Every backward pair runs on the MERGED lse and D = rowsum(dO * O) of the
merged O, so each block's probabilities are the whole row's; D comes
from each rank's first dq call (its diagonal pair), which computes it
from dO and the merged O.

On CUDA tensors the pairs launch the kernels (chunks shorter than the
flash seam's ``_MIN_FUSED_T`` floor take their plain versions, as the
seam does for short sequences); on CPU tensors the plain versions run.
The ring carries the compact Hkv-wide K/V and repeats it to H heads per
pair (dK/dV summed over each group), as ``make_flash_attention_fn``
does.

Rows whose visible keys are all padding: the kernels' key mask is a
finite ``NEG_INF`` bias, so such a row's block lse rounds to -1e9
whatever the key count and the merge weighs those blocks alike.
trlx_tpu's streamed softmax gives these rows a different, equally
meaningless mix; real rows agree, and a pad row's upstream gradient is 0.

Entry points: :func:`ring_attention` (this process's chunk on a mesh,
through :class:`~trlx_tpu_torch.parallel.exchange.P2PExchange`),
:func:`ring_attention_loopback` (a whole sequence, every rank in this
process), :func:`make_sp_attention_fn` (the trunk's ``attention_fn``,
``takes_raw_mask``), and :class:`SequenceSplit` (a rank's chunk of
positions and the gather of per-token results back to whole sequences).
"""

from typing import List, Optional

import torch

from trlx_tpu_torch.parallel.exchange import LoopbackExchange, P2PExchange


def check_sub_block(sub_block: int) -> None:
    """trlx_tpu streams each hop's K/V in ``sub_block``-wide pieces; the
    flash kernels already tile the K/V chunk, so the value is only
    checked (a positive int, as trlx_tpu's power-of-two rounding
    needs)."""
    if int(sub_block) < 1:
        raise ValueError(f"sub_block must be a positive int, got {sub_block}")


def _pair_ops(Tc: int, min_fused_t: Optional[int]):
    """The three block functions: the kernels' wrappers (which run their
    plain versions on CPU tensors), or their plain versions for chunks
    below the floor (``min_fused_t``, by default the seam's)."""
    from trlx_tpu_torch.ops import flash_attention as fa

    floor = fa._MIN_FUSED_T if min_fused_t is None else min_fused_t
    if Tc >= floor:
        return fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv
    return (fa.flash_fwd_reference, fa.flash_bwd_dq_reference,
            fa.flash_bwd_dkv_reference)


def _pair(r: int, j: int, causal: bool) -> Optional[bool]:
    """The ``causal`` flag of query chunk r against key chunk j, or None
    for a pair above the diagonal."""
    if not causal:
        return False
    if j == r:
        return True
    return False if j < r else None


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    """A compact [B, Tc, Hkv, hd] K or V repeated to H heads."""
    Hkv = x.shape[2]
    if Hkv == H:
        return x
    return x.repeat_interleave(H // Hkv, dim=2).contiguous()


def _group_sum(dx: torch.Tensor, Hkv: int) -> torch.Tensor:
    """An H-wide dK or dV summed over each group of query heads to the
    compact Hkv-wide K/V's gradient, in float32."""
    B, Tc, H, hd = dx.shape
    dx = dx.float()
    if Hkv == H:
        return dx
    return dx.reshape(B, Tc, Hkv, H // Hkv, hd).sum(3)


def _merge(acc, lse_acc, o, lse):
    """Merge one pair's (O, lse) into the running (float32 O, lse)."""
    if acc is None:
        return o.float(), lse
    new = torch.logaddexp(lse_acc, lse)
    w_acc = torch.exp(lse_acc - new).permute(0, 2, 1)[..., None]
    w = torch.exp(lse - new).permute(0, 2, 1)[..., None]
    return acc * w_acc + o.float() * w, new


def _ring_forward(ex, qs, ks, vs, masks, causal, ops):
    """Every local rank's (O in q's dtype, merged float32 lse)."""
    fwd = ops[0]
    n, H = ex.n, qs[0].shape[2]
    acc = [None] * len(qs)
    lse = [None] * len(qs)
    kv = [[k, v, m] for k, v, m in zip(ks, vs, masks)]
    for step in range(n):
        for i, r in enumerate(ex.ranks):
            flag = _pair(r, (r - step) % n, causal)
            if flag is None:
                continue
            k, v, m = kv[i]
            o, l_ = fwd(qs[i], _heads(k, H), _heads(v, H), m, flag)
            acc[i], lse[i] = _merge(acc[i], lse[i], o, l_)
        if step < n - 1:
            kv = ex.shift(kv, kv, wrap=True)
    return [a.to(q.dtype) for a, q in zip(acc, qs)], lse


def _ring_backward(ex, qs, ks, vs, masks, outs, lses, gs, causal, ops):
    """(dq, dk, dv) of every local rank, each in its input's dtype. D =
    rowsum(dO * O) comes from each rank's step-0 dq call: step 0 is the
    rank's diagonal pair, which is never skipped."""
    _, bwd_dq, bwd_dkv = ops
    n, H, Hkv = ex.n, qs[0].shape[2], ks[0].shape[2]
    dD = [None] * len(qs)
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in qs]
    travel = [[k, v, m,
               torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
              for k, v, m in zip(ks, vs, masks)]
    for step in range(n):
        for i, r in enumerate(ex.ranks):
            flag = _pair(r, (r - step) % n, causal)
            if flag is None:
                continue
            k, v, m, dk, dv = travel[i]
            kh, vh = _heads(k, H), _heads(v, H)
            dq_p, d_p = bwd_dq(qs[i], kh, vh, gs[i], outs[i], lses[i], m,
                               flag)
            if step == 0:
                dD[i] = d_p
            dq[i] += dq_p.float()
            dk_p, dv_p = bwd_dkv(qs[i], kh, vh, gs[i], lses[i], dD[i], m,
                                 flag)
            dk += _group_sum(dk_p, Hkv)
            dv += _group_sum(dv_p, Hkv)
        if n == 1:
            break
        if step < n - 1:
            travel = ex.shift(travel, travel, wrap=True)
        else:  # one more hop takes each dK/dV home
            home = ex.shift([t[3:] for t in travel], [t[3:] for t in travel],
                            wrap=True)
            travel = [[None, None, None] + h for h in home]
    return ([d.to(q.dtype) for d, q in zip(dq, qs)],
            [t[3].to(k.dtype) for t, k in zip(travel, ks)],
            [t[4].to(v.dtype) for t, v in zip(travel, vs)])


class _RingAttention(torch.autograd.Function):
    """Autograd over the ring: the forward saves every local rank's q,
    k, v, mask, O and merged lse; the backward runs the ring again."""

    @staticmethod
    def forward(ctx, ex, causal, ops, n_local, *tensors):
        qs, ks, vs, masks = (list(tensors[i * n_local:(i + 1) * n_local])
                             for i in range(4))
        outs, lses = _ring_forward(ex, qs, ks, vs, masks, causal, ops)
        ctx.save_for_backward(*qs, *ks, *vs, *masks, *outs, *lses)
        ctx.ex, ctx.causal, ctx.ops, ctx.n_local = ex, causal, ops, n_local
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n_local
        saved = ctx.saved_tensors
        qs, ks, vs, masks, outs, lses = (list(saved[i * n:(i + 1) * n])
                                         for i in range(6))
        gs = [torch.zeros_like(o) if g is None else g.to(o.dtype).contiguous()
              for g, o in zip(gs, outs)]
        dq, dk, dv = _ring_backward(ctx.ex, qs, ks, vs, masks, outs, lses,
                                    gs, ctx.causal, ctx.ops)
        return (None, None, None, None, *dq, *dk, *dv, *([None] * n))


def _ring(ex, qs, ks, vs, masks, causal,
          min_fused_t: Optional[int] = None) -> List[torch.Tensor]:
    """Each local rank's attention output [B, Tc, H, hd] in q's dtype;
    autograd records the ring's backward when grad mode is on and an
    input needs a gradient."""
    Tc = qs[0].shape[1]
    ops = _pair_ops(Tc, min_fused_t)
    qs = [q.contiguous() for q in qs]
    ks = [k.contiguous() for k in ks]
    vs = [v.contiguous() for v in vs]
    masks = [m.to(torch.int32).contiguous() for m in masks]
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in qs + ks + vs):
        return list(_RingAttention.apply(ex, causal, ops, len(qs),
                                         *qs, *ks, *vs, *masks))
    with torch.no_grad():
        return _ring_forward(ex, qs, ks, vs, masks, causal, ops)[0]


def ring_attention(q, k, v, kv_mask, mesh, *, axis: str = "sp",
                   causal: bool = True, sub_block: int = 512) -> torch.Tensor:
    """Sequence-parallel attention over ``mesh`` axis ``axis``, on this
    process's chunk: q [B, T/sp, H, hd], k / v [B, T/sp, Hkv, hd] and the
    key mask [B, T/sp] (1 = real) of its positions, rank r of the axis
    holding positions [r T/sp, (r + 1) T/sp). Returns the chunk's
    output [B, T/sp, H, hd] in q's dtype; every rank of the axis must
    call it together."""
    check_sub_block(sub_block)
    return _ring(P2PExchange(mesh, axis), [q], [k], [v], [kv_mask],
                 causal)[0]


def ring_attention_loopback(q, k, v, kv_mask, sp: int, *,
                            causal: bool = True, sub_block: int = 512,
                            min_fused_t: Optional[int] = None
                            ) -> torch.Tensor:
    """The ring of ``sp`` ranks run in this process on whole sequences:
    q [B, T, H, hd], k / v [B, T, Hkv, hd], kv_mask [B, T] with T
    divisible by ``sp``; [B, T, H, hd] in q's dtype. Chunks shorter than
    ``min_fused_t`` (by default the seam's floor) take the plain versions,
    so a caller can hold the kernels against them."""
    check_sub_block(sub_block)
    T = q.shape[1]
    if T % sp != 0:
        raise ValueError(f"sequence length {T} not divisible by sp={sp}")
    c = T // sp

    def chunks(x):
        return [x[:, r * c:(r + 1) * c] for r in range(sp)]

    outs = _ring(LoopbackExchange(sp), chunks(q), chunks(k), chunks(v),
                 chunks(kv_mask), causal, min_fused_t)
    return torch.cat(outs, dim=1)


def make_sp_attention_fn(mesh, axis: str = "sp", causal: bool = True):
    """An ``attention_fn`` for the trunk (trlx_tpu_torch.models.transformer
    ``block_apply``) that runs :func:`ring_attention` over the mesh's
    ``sp`` axis on this process's chunk of positions. It takes the raw
    [B, T/sp] key mask of the chunk (``takes_raw_mask``), so no [T, T]
    bias is ever built, and the compact Hkv-wide K/V; with Megatron tp
    compute the q / k / v it gets hold this process's heads, and it runs
    on those."""

    def sp_attention(q, k, v, attention_mask):
        return ring_attention(q, k, v, attention_mask, mesh, axis=axis,
                              causal=causal)

    sp_attention.takes_raw_mask = True
    return sp_attention


class SequenceSplit:
    """A rank's chunk of every sequence's positions over the ``sp`` axis
    and the way back: :meth:`chunk` slices positions [r T/sp, (r + 1)
    T/sp) out of a whole-sequence tensor; :meth:`gather` joins the sp
    ranks' chunks of a per-token result into whole sequences, the same
    on every rank, with a backward that hands each rank the gradient of
    its own chunk (right when what follows is computed alike on every
    rank; ``torch.distributed.nn``'s all_gather would sum the ranks'
    gradients instead, scaling them by sp)."""

    def __init__(self, mesh, axis: str = "sp"):
        from trlx_tpu_torch.parallel.mesh import axis_group

        self.group, self.index, self.size, _ = axis_group(mesh, axis)

    def bounds(self, T: int):
        """[start, stop) of this rank's positions of a T-long sequence."""
        if T % self.size != 0:
            raise ValueError(
                f"sequence length {T} not divisible by sp={self.size}")
        c = T // self.size
        return self.index * c, (self.index + 1) * c

    def chunk(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's positions of ``x`` [B, T, ...]."""
        start, stop = self.bounds(x.shape[1])
        return x[:, start:stop]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The sp ranks' chunks [B, T/sp, ...] joined to [B, T, ...]."""
        return _GatherChunks.apply(x, self)


class _GatherChunks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        import torch.distributed as dist

        ctx.split, ctx.width = split, x.shape[1]
        parts = [torch.empty_like(x) for _ in range(split.size)]
        dist.all_gather(parts, x.contiguous(), group=split.group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        start = ctx.split.index * ctx.width
        return g[:, start:start + ctx.width], None
