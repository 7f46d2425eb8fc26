"""Fleet observability CLI helpers (``python -m trlx_tpu_torch.obs``; the
port of trlx_tpu.obs).

The router's access log (trlx_tpu_torch.router.obs.AccessLog) is a sampled
JSONL stream of stitched fleet traces — router event timeline + the
winning replica's span payload per request. This package is the
operator's read side, stdlib-only like everything on the router path:

- :func:`summarize` — aggregate a log into per-backend p50/p95
  TTFT/ITL, hedge fire/win counts, failover and breaker tallies, error
  and SLO-breach counts (the ``summarize`` subcommand);
- :func:`perfetto_events` — re-export ONE stitched record as a
  Chrome-trace event list (``trace <id> --perfetto``): the router's
  request span + instant events on one track, the replica's
  queue/prefill/decode phases reconstructed on a second, so the fleet
  half and the replica half of a request line up on one timeline next
  to the trainer's ``trace.jsonl``;
- :func:`format_line` — the one-line-per-request rendering ``tail``
  follows the log with, ANSI-highlighting SLO breaches and errors.

Only :mod:`trlx_tpu_torch.obs.__main__` does I/O loops; everything here
is pure data -> data, held against trlx_tpu.obs in
tests/test_torch_fleet_obs.py.
"""

import json
from typing import Any, Dict, Iterable, List, Optional


def read_records(path: str) -> List[Dict[str, Any]]:
    """Parse one access-log file, skipping torn/garbage lines (a
    crash mid-append must not poison the whole log)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(record, dict):
                records.append(record)
    return records


def percentile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(q * len(ordered)))
    return ordered[idx]


def _count_events(record: Dict[str, Any], kind: str) -> int:
    return sum(1 for e in record.get("events", ())
               if e.get("event") == kind)


def summarize(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate stitched records into the ``summarize`` report."""
    records = list(records)
    backends: Dict[str, Dict[str, List[float]]] = {}
    totals = {
        "requests": len(records),
        "errors": 0,
        "slo_breached": 0,
        "hedged": 0,
        "hedge_wins": 0,
        "hedge_losses": 0,
        "failovers": 0,
        "breaker_strikes": 0,
        "breaker_opens": 0,
        "retry_tokens_spent": 0,
    }
    for record in records:
        if record.get("status", 200) != 200:
            totals["errors"] += 1
        if record.get("slo_breached"):
            totals["slo_breached"] += 1
        if record.get("hedged"):
            totals["hedged"] += 1
        totals["hedge_wins"] += _count_events(record, "hedge_win")
        totals["hedge_losses"] += _count_events(record, "hedge_lose")
        totals["failovers"] += _count_events(record, "failover")
        totals["breaker_strikes"] += _count_events(record,
                                                   "breaker_strike")
        totals["breaker_opens"] += _count_events(record, "breaker_open")
        totals["retry_tokens_spent"] += _count_events(
            record, "retry_budget_spend"
        )
        backend = record.get("backend")
        replica = record.get("replica")
        if not backend or not isinstance(replica, dict):
            continue
        samples = backends.setdefault(
            backend, {"ttft_ms": [], "itl_mean_ms": [], "total_ms": []}
        )
        for field in samples:
            value = replica.get(field)
            if isinstance(value, (int, float)):
                samples[field].append(float(value))
    per_backend = {}
    for backend, samples in sorted(backends.items()):
        per_backend[backend] = {
            "requests": len(samples["ttft_ms"]),
            "ttft_p50_ms": round(percentile(samples["ttft_ms"], 0.50), 3),
            "ttft_p95_ms": round(percentile(samples["ttft_ms"], 0.95), 3),
            "itl_p50_ms": round(
                percentile(samples["itl_mean_ms"], 0.50), 3
            ),
            "itl_p95_ms": round(
                percentile(samples["itl_mean_ms"], 0.95), 3
            ),
        }
    totals["hedge_win_rate"] = round(
        totals["hedge_wins"] / totals["hedged"], 4
    ) if totals["hedged"] else 0.0
    return {"totals": totals, "backends": per_backend}


def format_summary(report: Dict[str, Any]) -> str:
    """Human rendering of :func:`summarize` (the default output;
    ``--json`` emits the dict instead)."""
    totals = report["totals"]
    lines = [
        f"requests {totals['requests']}  errors {totals['errors']}  "
        f"slo_breached {totals['slo_breached']}",
        f"hedged {totals['hedged']}  hedge_wins {totals['hedge_wins']}  "
        f"win_rate {totals['hedge_win_rate']:.2%}",
        f"failovers {totals['failovers']}  "
        f"breaker_strikes {totals['breaker_strikes']}  "
        f"breaker_opens {totals['breaker_opens']}  "
        f"retry_tokens_spent {totals['retry_tokens_spent']}",
        "",
        f"{'backend':<28} {'n':>5} {'ttft_p50':>9} {'ttft_p95':>9} "
        f"{'itl_p50':>8} {'itl_p95':>8}",
    ]
    for backend, row in report["backends"].items():
        lines.append(
            f"{backend:<28} {row['requests']:>5} "
            f"{row['ttft_p50_ms']:>9.1f} {row['ttft_p95_ms']:>9.1f} "
            f"{row['itl_p50_ms']:>8.2f} {row['itl_p95_ms']:>8.2f}"
        )
    return "\n".join(lines)


def find_record(records: Iterable[Dict[str, Any]],
                trace_id: str) -> Optional[Dict[str, Any]]:
    """Latest record for ``trace_id`` (re-captures overwrite)."""
    found = None
    for record in records:
        if record.get("trace_id") == trace_id:
            found = record
    return found


def _replica_anchor_ms(record: Dict[str, Any]) -> float:
    """Where the winning replica's span starts on the router timeline:
    the LAST ``attempt`` event against the winning backend (when the
    router actually sent the request), else 0."""
    anchor = 0.0
    for event in record.get("events", ()):
        if event.get("event") == "attempt" \
                and event.get("backend") == record.get("backend"):
            anchor = float(event.get("t_ms", 0.0))
    return anchor


def perfetto_events(record: Dict[str, Any]) -> List[Dict[str, Any]]:
    """ONE stitched record -> Chrome-trace events (µs timestamps):
    track 0 carries the router's request span + its event timeline as
    instant events; track 1 lays the winning replica's
    queue/prefill/decode durations end to end from the winning attempt
    — durations are all the replica payload carries, so the
    reconstruction is phase-accurate, not wall-clock-exact."""
    trace_id = record.get("trace_id", "?")
    pid = 1
    out: List[Dict[str, Any]] = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": "router"}},
        {"name": f"fleet/request {trace_id}", "ph": "X", "ts": 0.0,
         "dur": round(float(record.get("elapsed_ms", 0.0)) * 1000.0, 3),
         "pid": pid, "tid": 0,
         "args": {
             "status": record.get("status"),
             "backend": record.get("backend"),
             "hedged": record.get("hedged", False),
             "failed_over": record.get("failed_over", False),
             "slo_breached": record.get("slo_breached", False),
         }},
    ]
    for event in record.get("events", ()):
        args = {k: v for k, v in event.items()
                if k not in ("t_ms", "event")}
        out.append({
            "name": f"router/{event.get('event', '?')}",
            "ph": "i", "s": "t",
            "ts": round(float(event.get("t_ms", 0.0)) * 1000.0, 3),
            "pid": pid, "tid": 0,
            "args": args,
        })
    replica = record.get("replica")
    if isinstance(replica, dict):
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": 1,
                    "args": {"name": f"replica {record.get('backend')}"}})
        at = _replica_anchor_ms(record) * 1000.0
        for phase in ("queue", "prefill", "decode"):
            dur = float(replica.get(f"{phase}_ms", 0.0) or 0.0) * 1000.0
            if dur <= 0:
                continue
            out.append({
                "name": f"replica/{phase}", "ph": "X",
                "ts": round(at, 3), "dur": round(dur, 3),
                "pid": pid, "tid": 1,
            })
            at += dur
    return out


#: ANSI codes for tail highlighting (``--no-color`` disables)
_RED = "\x1b[31m"
_YELLOW = "\x1b[33m"
_RESET = "\x1b[0m"


def format_line(record: Dict[str, Any], color: bool = True) -> str:
    """One access-log record -> one ``tail`` line; errors red, SLO
    breaches / hedges / failovers yellow."""
    status = record.get("status", 0)
    replica = record.get("replica") or {}
    flags = "".join((
        "S" if record.get("slo_breached") else "-",
        "H" if record.get("hedged") else "-",
        "F" if record.get("failed_over") else "-",
        "B" if record.get("breaker_opened") else "-",
    ))
    line = (
        f"{record.get('trace_id', '?'):<16} {status:>3} {flags} "
        f"{record.get('elapsed_ms', 0.0):>9.1f}ms "
        f"ttft {replica.get('ttft_ms', 0.0):>8.1f}ms "
        f"{record.get('backend') or '-'}"
    )
    if record.get("error"):
        line += f"  {record['error']}"
    if not color:
        return line
    if status != 200:
        return f"{_RED}{line}{_RESET}"
    if record.get("slo_breached") or record.get("hedged") \
            or record.get("failed_over"):
        return f"{_YELLOW}{line}{_RESET}"
    return line
