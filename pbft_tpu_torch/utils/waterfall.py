"""Per-request latency waterfalls: the port's copy of
``pbft_tpu/utils/waterfall.py``. They join the
client's send, first-reply and quorum stamps with the replicas' trace events
into per-request segments, with no change to the wire format:

    client send --(client_queue)--> primary request_rx
               --(batch_wait)-----> batch_sealed          (view, seq)
               --(prepared)-------> consensus_span.prepared
               --(committed)------> consensus_span.committed
               --(execute)--------> consensus_span.executed
               --(reply)----------> client quorum (f+1 matching replies)

All stamps are CLOCK_MONOTONIC, comparable across processes on one host.
Consumers: ``pbft_tpu_torch.scripts.consensus_timeline --waterfall``
(offline, from trace files) and the bench harness (``bench/harness.py``,
which fills ``latency_segments_ms`` when a run has a trace directory) —
one join implementation for both.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Iterable, List, Optional

SEGMENTS = ("client_queue", "batch_wait", "prepared", "committed",
            "execute", "reply")
QUANTILES = (("p50", 0.5), ("p95", 0.95), ("p99", 0.99))


def percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


def load_jsonl(paths: Iterable) -> List[dict]:
    """Best-effort JSONL loader: unparseable lines are skipped."""
    events = []
    for path in paths:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(e, dict):
                    events.append(e)
    return events


def client_records_from_events(events: Iterable[dict]) -> List[dict]:
    """Extract ``client_request`` events (net/client.py write_trace) into
    the record shape build_waterfall takes."""
    out = []
    for e in events:
        if e.get("ev") != "client_request":
            continue
        row = {k: e[k] for k in ("client", "req_ts", "send") if k in e}
        if len(row) < 3:
            continue
        for k in ("first_reply", "quorum"):
            if isinstance(e.get(k), (int, float)):
                row[k] = e[k]
        out.append(row)
    return out


def build_waterfall(
    replica_events: Iterable[dict], client_records: Iterable[dict]
) -> Dict:
    """The join. Returns::

        {"requests": joined count, "clients": client record count,
         "mean_batch": mean sealed-batch occupancy,
         "e2e_ms": {p50, p95, p99, count},
         "segments_ms": {segment: {p50, p95, p99, count}, ...}}

    Requests missing a piece of evidence (an un-traced replica, a span
    evicted mid-run) contribute the segments they do have — partial
    coverage degrades percentile sample counts, never correctness.
    """
    # (client, req_ts) -> earliest request_rx stamp (the primary's first
    # sighting; forwards arrive later and must not win).
    rx: Dict = {}
    # (client, req_ts) -> (view, seq); (view, seq) -> seal info.
    seat: Dict = {}
    seals: Dict = {}
    # (view, seq, replica) -> consensus_span stamps.
    spans: Dict = {}
    batch_sizes: List[int] = []
    for e in replica_events:
        ev = e.get("ev")
        if ev == "request_rx":
            key = (e.get("client"), e.get("req_ts"))
            ts = e.get("ts")
            if None in key or not isinstance(ts, (int, float)):
                continue
            if key not in rx or ts < rx[key]:
                rx[key] = ts
        elif ev == "batch_sealed":
            try:
                view, seq = int(e["view"]), int(e["seq"])
            except (KeyError, TypeError, ValueError):
                continue
            seals[(view, seq)] = e
            if isinstance(e.get("batch"), int):
                batch_sizes.append(e["batch"])
            for pair in e.get("reqs") or ():
                if isinstance(pair, (list, tuple)) and len(pair) == 2:
                    seat[(pair[0], pair[1])] = (view, seq)
        elif ev == "consensus_span":
            try:
                key = (int(e["view"]), int(e["seq"]), int(e["replica"]))
            except (KeyError, TypeError, ValueError):
                continue
            spans[key] = e

    durs: Dict[str, List[float]] = {s: [] for s in SEGMENTS}
    e2e: List[float] = []
    joined = 0
    records = list(client_records)
    for rec in records:
        key = (rec.get("client"), rec.get("req_ts"))
        send = rec.get("send")
        arrived = rx.get(key)
        slot = seat.get(key)
        seal = seals.get(slot) if slot is not None else None
        span = None
        if slot is not None and seal is not None:
            # The sealing replica's span is the authoritative per-phase
            # clock (its "request" stamp IS the seal).
            span = spans.get((slot[0], slot[1], seal.get("replica")))
        if arrived is None and span is None and seal is None:
            continue
        joined += 1

        def seg(name: str, a: Optional[float], b: Optional[float]) -> None:
            if isinstance(a, (int, float)) and isinstance(b, (int, float)):
                durs[name].append(max(0.0, b - a))

        sealed_ts = seal.get("ts") if seal else None
        seg("client_queue", send, arrived)
        seg("batch_wait", arrived, sealed_ts)
        if span is not None:
            seg("prepared", span.get("pre_prepare"), span.get("prepared"))
            seg("committed", span.get("prepared"), span.get("committed"))
            seg("execute", span.get("committed"), span.get("executed"))
            seg("reply", span.get("executed"), rec.get("quorum"))
        if isinstance(send, (int, float)) and isinstance(
            rec.get("quorum"), (int, float)
        ):
            e2e.append(max(0.0, rec["quorum"] - send))

    def stats_ms(vals: List[float]) -> Dict:
        vals = sorted(vals)
        out = {name: round(percentile(vals, q) * 1e3, 3)
               for name, q in QUANTILES}
        out["count"] = len(vals)
        return out

    return {
        "requests": joined,
        "clients": len(records),
        "mean_batch": (
            round(sum(batch_sizes) / len(batch_sizes), 2)
            if batch_sizes
            else 0.0
        ),
        "e2e_ms": stats_ms(e2e),
        "segments_ms": {s: stats_ms(durs[s]) for s in SEGMENTS},
    }


def render(wf: Dict) -> str:
    """Human-readable waterfall table."""
    lines = [
        "per-request latency waterfall: %d requests joined "
        "(%d client records, mean batch %.2f)"
        % (wf["requests"], wf["clients"], wf["mean_batch"])
    ]
    lines.append(
        f"  {'segment':<14}{'p50 ms':>10}{'p95 ms':>10}{'p99 ms':>10}"
        f"{'samples':>10}"
    )
    for name in SEGMENTS + ("e2e",):
        st = wf["e2e_ms"] if name == "e2e" else wf["segments_ms"][name]
        lines.append(
            f"  {name:<14}{st['p50']:>10.2f}{st['p95']:>10.2f}"
            f"{st['p99']:>10.2f}{st['count']:>10}"
        )
    return "\n".join(lines)


def from_trace_dir(paths) -> Dict:
    """Build a waterfall straight from trace files/dirs (client_request
    events mixed in with replica events — the harness writes both)."""
    files = []
    for arg in paths:
        p = pathlib.Path(arg)
        if p.is_dir():
            files.extend(sorted(p.glob("*.jsonl")) + sorted(p.glob("*/*.jsonl")))
        else:
            files.append(p)
    events = load_jsonl(files)
    return build_waterfall(events, client_records_from_events(events))
