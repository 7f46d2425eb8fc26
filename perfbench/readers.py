"""Arithmetic the per-layer metrics share (each metric's own reader is
``metrics/<metric>.py``). A reader that finds nothing to read returns
None, and the metric is left out of the run's line."""

import statistics

from perfbench import yardstick


def idle_share(r):
    """Per cent of the traced window in which nothing ran on the
    device."""
    t = r.timeline
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(r, key: str = "traced_flops"):
    """Model FLOPs the traced part needed over its length at the card's
    bf16 peak, per cent."""
    flops = r.data.get(key)
    if r.timeline is None or r.peaks is None or not flops:
        return None
    return 100.0 * flops / (r.timeline.window_s * r.peaks["bf16_flops"])


def flash_roofline(r):
    """The least time of the traced part's flash calls over the device
    time of the flash kernels, per cent."""
    calls = r.data.get("flash_calls")
    if r.timeline is None or r.peaks is None or not calls:
        return None
    least = 0.0
    for name, (B, T, H, hd), elem, causal, mask in calls:
        macs = yardstick.causal_key_macs(mask.cpu().numpy(), T, H, hd) \
            if causal else None
        least += yardstick.flash_bounds(
            B, T, H, hd, elem, causal, macs, r.peaks["bf16_flops"],
            r.peaks["hbm_bytes_per_s"])[name][0]
    busy = r.timeline.time_of(lambda n: "flash_fwd" in n or "flash_bwd" in n)
    return 100.0 * least / busy if busy > 0 else None


def median_part_ms(r, part: int):
    """Median over the window's updates of one part of the trainer's own
    CUDA-event split of an update."""
    parts = r.data.get("step_parts_ms")
    if not parts:
        return None
    return statistics.median(p[part] for p in parts)


def span_ms_per_sample(r, span: str, samples_key: str):
    """Total time of benchmark span ``span`` over the samples it covered,
    ms."""
    times = r.ctx.span_times(span)
    samples = r.data.get(samples_key)
    if not times or not samples:
        return None
    return 1e3 * sum(times) / samples


def p95_ms(r, key: str):
    values = r.data.get(key)
    if not values:
        return None
    import numpy as np

    return 1e3 * float(np.percentile(values, 95))


def prefix_hit_rate(r):
    prompt = r.data.get("prompt_tokens")
    if not prompt:
        return None
    return 100.0 * r.data["prefix_saved"] / prompt


def paged_roofline(r):
    """Least time of every paged-decode call of the traced steps (one a
    layer a step, over the pages the step's live slots held) over the
    device time of the paged-decode kernel."""
    steps = r.data.get("paged_steps")
    if r.timeline is None or r.peaks is None or not steps:
        return None
    S, H, Hkv, hd, ps, max_pages, L = r.data["paged_geometry"]
    least = 0.0
    for contexts in steps:
        live = sum(-(-c // ps) for c in contexts)
        least += L * yardstick.paged_bound(
            S, H, Hkv, hd, ps, max_pages, live, 2, r.peaks["bf16_flops"],
            r.peaks["hbm_bytes_per_s"])[0]
    busy = r.timeline.time_of(lambda n: "paged_decode" in n)
    return 100.0 * least / busy if busy > 0 else None
