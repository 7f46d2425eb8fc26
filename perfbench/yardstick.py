"""The yardstick: peaks of the card, the least time of an attention call,
and the model FLOPs a step of each algorithm needs, all from shapes.

Nothing here reads the program. ``flash_bounds`` and ``paged_bound`` are
frozen copies of the byte and FLOP counts that ``chip_smoke.py`` kept
beside the kernels (``flash_bounds`` and ``bound``), so that a later
change to the program cannot move what a roofline share is measured
against.
"""

from typing import Dict, Optional

from perfbench import harness

#: published dense peaks of a card, by ``torch.cuda.get_device_name()``:
#: bf16 tensor-core FLOP/s and HBM bytes/s (NVIDIA's data sheet, SXM part,
#: at its 700 W limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The card's peaks, or None for a card the table does not hold (the
    metrics that need them then stay silent)."""
    return PEAKS.get(device_name)


# --------------------------------------------------------------------- #
# least time of one attention call
# --------------------------------------------------------------------- #

FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def causal_key_macs(lengths_or_mask, T: int, H: int, hd: int,
                    left_padded: bool = False) -> int:
    """Multiply-adds of one product (QK^T or PV) over the (query, key)
    pairs causality leaves with a real key: per row, for each query the
    real keys at or before it. ``lengths_or_mask``: a [B, T] 0/1 mask
    (numpy or torch on the host) or a list of B real lengths (right
    padding: keys 0..n-1 real; ``left_padded``: the last n)."""
    import numpy as np

    mask = lengths_or_mask
    if isinstance(mask, (list, tuple)):
        rows = np.zeros((len(mask), T), np.int64)
        for i, n in enumerate(mask):
            if left_padded:
                rows[i, T - n:] = 1
            else:
                rows[i, :n] = 1
        mask = rows
    mask = np.asarray(mask, np.int64)
    return H * int(mask.cumsum(1).sum()) * hd


def flash_bounds(B: int, T: int, H: int, hd: int, elem: int,
                 causal: bool = True, macs: Optional[int] = None,
                 peak_flops: float = 989e12,
                 hbm_bytes_per_s: float = 3.35e12) -> Dict[str, tuple]:
    """Least time (s), what bounds it, bytes and FLOPs, per kernel: the
    bytes the function must move (q, k, v, dO once each in ``elem``
    bytes, and O for dq, which computes D; the int32 mask and the
    float32 lse / D rows, D written by dq and read by dk/dv; its outputs
    once in the inputs' dtype) over HBM bandwidth, against the FLOPs of
    the (query, key) pairs causality leaves (``macs``: one product's
    multiply-adds, default every causal pair of full-length rows): QK^T
    and PV in the forward, QK^T, dO V^T and dS K for dq, and those two
    plus P^T dO and dS^T Q for dk/dv."""
    n = B * T * H * hd
    row, mask = 4 * B * H * T, 4 * B * T
    if macs is None:
        pairs = T * (T + 1) // 2 if causal else T * T
        macs = B * H * pairs * hd
    work = {
        "flash_fwd": (4 * n * elem + mask + row, 2 * 2 * macs),
        "flash_bwd_dq": (6 * n * elem + mask + 2 * row, 2 * 3 * macs),
        "flash_bwd_dkv": (6 * n * elem + mask + 2 * row, 2 * 4 * macs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        by_bytes = nbytes / hbm_bytes_per_s
        by_ops = flops / peak_flops
        out[name] = (max(by_bytes, by_ops),
                     "bytes" if by_bytes >= by_ops else "operations",
                     nbytes, flops)
    return out


def paged_bound(S: int, H: int, Hkv: int, hd: int, page_size: int,
                max_pages: int, live_pages: int, elem: int = 2,
                peak_flops: float = 989e12,
                hbm_bytes_per_s: float = 3.35e12) -> tuple:
    """Least time (s) of one paged-decode call over ``S`` slots: the K
    and V of the pages holding any unmasked position (``live_pages`` in
    all) read once, q, the output, the page table and the bias row once,
    over HBM bandwidth, against the score and weighted-sum FLOPs of the
    live pages' positions. Returns (seconds, bound, bytes, flops)."""
    kv = 2 * live_pages * page_size * Hkv * hd * elem
    io = 2 * S * H * hd * elem + S * max_pages * 4 \
        + S * max_pages * page_size * 4
    flops = 4 * H * hd * live_pages * page_size
    by_bytes = (kv + io) / hbm_bytes_per_s
    by_ops = flops / peak_flops
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", kv + io, flops)


# --------------------------------------------------------------------- #
# model FLOPs (matmuls and attention; norms, softmax and biases left out),
# summed over layer indices from each layer's count in its architecture's
# module (``arch/<arch>.py``)
# --------------------------------------------------------------------- #


def _layer_sums(spec: dict, layers) -> tuple:
    """Over the layers with these indices: the projections' forward FLOPs
    for one token, and the attention width (H x hd) of those that
    attend; each layer's numbers from its architecture's module."""
    model = harness.arch(spec)
    return (sum(model.layer_flops_per_token(spec, i) for i in layers),
            sum(model.attention_width(spec, i) for i in layers))


def attention_flops(width: int, pairs: int) -> int:
    """Forward FLOPs of attention ``width`` (H x hd, summed over the
    layers that attend) wide over ``pairs`` (query, key) pairs: QK^T and
    PV."""
    return 2 * 2 * width * pairs


def causal_pairs(n: int) -> int:
    """(query, key) pairs of one causal row of ``n`` real tokens."""
    return n * (n + 1) // 2


def forward_flops(spec: dict, layers, lengths) -> int:
    """Forward FLOPs of the layers with these indices (a ``range``) over
    rows of the given real lengths, each row attending causally within
    itself."""
    per_token, width = _layer_sums(spec, layers)
    return sum(per_token * n + attention_flops(width, causal_pairs(n))
               for n in lengths)


def head_flops(d_in: int, d_out: int) -> int:
    """Forward FLOPs of one MLP head (d -> 2d -> out) for one token."""
    return 2 * (d_in * 2 * d_in + 2 * d_in * d_out)


def lm_head_flops(spec: dict) -> int:
    """Forward FLOPs of the LM head for one token."""
    return 2 * spec["d_model"] * spec["vocab_size"]


def decode_flops(spec: dict, layers, prompt_len: int,
                 new_tokens: int) -> int:
    """Forward FLOPs of decoding ``new_tokens`` after a prompt of
    ``prompt_len`` real tokens: the layers with these indices and the LM
    head per token, each token attending to the context before it and
    itself."""
    per_token, width = _layer_sums(spec, layers)
    total = 0
    for i in range(new_tokens):
        ctx = prompt_len + i + 1
        total += per_token + attention_flops(width, ctx) \
            + lm_head_flops(spec)
    return total


def prefill_flops(spec: dict, layers, prompt_len: int,
                  cached: int = 0) -> int:
    """A prompt's forward through the layers with these indices, and the
    LM head at its last position. ``cached``: the first tokens already
    held (a prefix cache's hit), whose forward is not needed: only the
    other tokens run through the layers, each attending to the cached
    tokens and causally to those before it."""
    n = prompt_len - cached
    pairs = n * cached + causal_pairs(n)
    per_token, width = _layer_sums(spec, layers)
    return per_token * n + attention_flops(width, pairs) \
        + lm_head_flops(spec)
