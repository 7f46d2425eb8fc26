"""Prometheus text exposition of the metrics registry (copy of
trlx_tpu.telemetry.prometheus, with the same ``trlx_tpu_`` prefix so
dashboards carry over).

- **counters** -> ``<name>_total``, ``# TYPE ... counter`` (predeclared
  counters render as 0);
- **gauges** -> ``<name>``, ``# TYPE ... gauge``;
- **timing histograms** -> a summary (``<name>_seconds`` quantiles over
  the registry's window, ``_sum``, ``_count``) AND a cumulative
  histogram (``<name>_seconds_hist_bucket{le="..."}`` over
  :data:`~trlx_tpu_torch.telemetry.registry.BUCKET_BOUNDS`, closing with
  ``le="+Inf"`` == count), under distinct names since one metric name
  may not carry two types.

Labeled registry keys (``name{k=v,...}``) render as real label sets.
Names pass through :func:`sanitize` (``/`` -> ``_``, the prefix added);
two distinct raw names that sanitize alike are told apart with a
``_dupN`` suffix, in sorted order. The serve endpoint's ``/metrics``
text route is not wired to it yet.
"""

import re
from typing import Dict, Iterable

from trlx_tpu_torch.telemetry.registry import MetricsRegistry, split_label_key

#: the exposition content type scrapers expect (text format 0.0.4)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize(name: str) -> str:
    """One registry key -> a valid Prometheus metric name."""
    out = _INVALID.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return "trlx_tpu_" + out


def sanitized_names(raw_names: Iterable[str]) -> Dict[str, str]:
    """Collision-free raw->sanitized mapping: when two distinct raw
    names sanitize identically, the first in sorted raw order keeps the
    clean name and each later one gets a ``_dupN`` suffix (N = 2, 3, …
    in sorted order — deterministic across renders)."""
    out: Dict[str, str] = {}
    taken: Dict[str, int] = {}
    for raw in sorted(set(raw_names)):
        clean = sanitize(raw)
        seen = taken.get(clean, 0)
        taken[clean] = seen + 1
        out[raw] = clean if seen == 0 else f"{clean}_dup{seen + 1}"
    return out


def _fmt(value: float) -> str:
    return repr(float(value))


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\")
                 .replace('"', '\\"')
                 .replace("\n", "\\n"))


def _labelset(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _grouped(keys):
    """sorted (base, labels, key) triples grouped so that all series of
    one family are contiguous (base-sorted, then by flattened key)."""
    triples = []
    for key in keys:
        base, labels = split_label_key(key)
        triples.append((base, key, labels))
    triples.sort(key=lambda t: (t[0], t[1]))
    return triples


def render(registry: MetricsRegistry) -> str:
    """The full registry in Prometheus text exposition format."""
    lines = []
    with registry._lock:
        counters = dict(registry.counters)
        gauges = dict(registry.gauges)
        hists = dict(registry.hists)

    names = sanitized_names(
        base for key in (*counters, *gauges, *hists)
        for base in (split_label_key(key)[0],)
    )

    typed = set()

    def _type(metric: str, kind: str) -> None:
        if metric not in typed:
            typed.add(metric)
            lines.append(f"# TYPE {metric} {kind}")

    for base, key, labels in _grouped(counters):
        metric = names[base] + "_total"
        _type(metric, "counter")
        lines.append(f"{metric}{_labelset(labels)} {_fmt(counters[key])}")
    for base, key, labels in _grouped(gauges):
        metric = names[base]
        _type(metric, "gauge")
        lines.append(f"{metric}{_labelset(labels)} {_fmt(gauges[key])}")
    for base, key, labels in _grouped(hists):
        hist = hists[key]
        metric = names[base] + "_seconds"
        _type(metric, "summary")
        q50 = _labelset(labels, extra='quantile="0.5"')
        q95 = _labelset(labels, extra='quantile="0.95"')
        lines.append(f"{metric}{q50} {_fmt(hist.quantile(0.5))}")
        lines.append(f"{metric}{q95} {_fmt(hist.quantile(0.95))}")
        lines.append(f"{metric}_sum{_labelset(labels)} {_fmt(hist.total)}")
        lines.append(
            f"{metric}_count{_labelset(labels)} {_fmt(hist.count)}"
        )
        # the aggregatable cumulative-bucket family, distinct name
        hmetric = metric + "_hist"
        _type(hmetric, "histogram")
        for bound, cum in hist.cumulative_buckets():
            le = f'le="{_fmt(bound)}"'
            lines.append(
                f"{hmetric}_bucket{_labelset(labels, extra=le)} {cum}"
            )
        inf = _labelset(labels, extra='le="+Inf"')
        lines.append(f"{hmetric}_bucket{inf} {hist.count}")
        lines.append(f"{hmetric}_sum{_labelset(labels)} {_fmt(hist.total)}")
        lines.append(f"{hmetric}_count{_labelset(labels)} {hist.count}")
    return "\n".join(lines) + "\n"
