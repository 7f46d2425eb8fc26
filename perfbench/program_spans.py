"""The program's own spans (``trlx_tpu_torch.telemetry``) inside the
traced part of a run, for the per-layer metrics that read them.

The program's tracer stamps its spans on its own clock and keeps the
Unix-epoch ns read beside that clock's first reading
(``SpanTracer.epoch_ns``): the clock ``torch.profiler`` stamps device
events on, and the one ``Timeline.window_ns`` is on. A program without
that anchor, or a run without a traced part, gives nothing to read: the
readers return None."""

import bisect
import statistics
from typing import List, Optional, Tuple


def in_window(r, name: str) -> Optional[List[Tuple[dict, int, int]]]:
    """(event, start ns, end ns) of each of the program's ``name`` spans
    that lie wholly inside the traced part, with the device time of its
    device phases resolved; None when there is nothing to read."""
    if r.timeline is None:
        return None
    from trlx_tpu_torch import telemetry

    tracer = getattr(telemetry.current(), "tracer", None)
    if tracer is None or not hasattr(tracer, "epoch_ns"):
        return None
    tracer.resolve_device()
    lo, hi = r.timeline.window_ns
    out = []
    for event in list(tracer.events):
        if event.get("ph") != "X" or event["name"] != name:
            continue
        start, end = tracer.epoch_ns(event)
        if lo <= start and end <= hi:
            out.append((event, start, end))
    return out


def device_ms_per_row(r, name: str) -> Optional[float]:
    """Device ms of the traced part's ``name`` device phases over the rows
    they covered (each span's ``rows`` argument)."""
    spans = in_window(r, name) or []
    ms = rows = 0
    for event, _, _ in spans:
        args = event.get("args", {})
        if "device_ms" in args and args.get("rows"):
            ms += args["device_ms"]
            rows += args["rows"]
    return ms / rows if rows else None


def median_self_ms(r, parent: str, child: str) -> Optional[float]:
    """Median over the traced part's ``parent`` spans that hold a
    ``child`` span (on the same thread, ``args.parent``) of the parent's
    length minus its ``child`` spans', ms."""
    outer = in_window(r, parent)
    inner = in_window(r, child)
    if not outer or not inner:
        return None
    inner = sorted(((s, e) for ev, s, e in inner
                    if ev.get("args", {}).get("parent") == parent))
    starts = [s for s, _ in inner]
    own = []
    for _, s, e in outer:
        at = bisect.bisect_left(starts, s)
        held = 0
        while at < len(inner) and inner[at][1] <= e:
            held += inner[at][1] - inner[at][0]
            at += 1
        if held:
            own.append((e - s - held) / 1e6)
    return statistics.median(own) if own else None


def admission_waste(r) -> Optional[float]:
    """Per cent of the traced part's prefill positions that were not
    needed: 100 x (1 - sum of ``needed`` / sum of ``positions``) over its
    ``serve/admit`` spans."""
    spans = in_window(r, "serve/admit") or []
    positions = needed = 0
    for event, _, _ in spans:
        args = event.get("args", {})
        positions += args.get("positions", 0)
        needed += args.get("needed", 0)
    return 100.0 * (1.0 - needed / positions) if positions else None
