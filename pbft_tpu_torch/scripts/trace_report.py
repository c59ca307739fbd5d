"""Summarize JSONL traces (pbftd --trace / the port's server.py --trace,
the verify daemon's --trace): the port's copy of the reference's
``scripts/trace_report.py``.

Reads one or more per-replica trace files and prints, per replica and
cluster-wide: verify-batch count/size/time percentiles, batching-window
efficiency (items per launch — the number the card's batching design
exists to maximize), rejected-signature totals, and view-change events.

Usage: python -m pbft_tpu_torch.scripts.trace_report TRACE_DIR_OR_FILES...
"""

from __future__ import annotations

import json
import pathlib
import sys


def _pct(sorted_vals, q: float):
    if not sorted_vals:
        return 0
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


def load(path: pathlib.Path):
    events = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return events


# The consensus_span phase chain (utils/trace_schema.py): per-transition
# latencies reported as p50/p90 when a trace carries span events.
_SPAN_PHASES = [
    ("request", "pre_prepare"),
    ("pre_prepare", "prepared"),
    ("prepared", "committed"),
    ("committed", "executed"),
]


def _batch_sizes(events) -> dict:
    """{(view, seq) -> sealed batch size} from batch_sealed events."""
    sizes = {}
    for e in events:
        if e.get("ev") != "batch_sealed":
            continue
        try:
            sizes[(int(e["view"]), int(e["seq"]))] = int(e["batch"])
        except (KeyError, TypeError, ValueError):
            continue
    return sizes


def _span_summary(spans, batches=None) -> str:
    """One-line per-phase latency summary for consensus_span events.

    Spans are per (view, seq) — per ROUND — and a batched round carries
    many requests, so segment times must not be read as
    per-request numbers. When batch_sealed data is available the execute
    segment (the only one whose cost scales with occupancy) also reports
    its per-request amortization, and the caller prints the mean batch."""
    batches = batches or {}
    parts = []
    for a, b in _SPAN_PHASES:
        rows = [
            (e[b] - e[a], batches.get((e.get("view"), e.get("seq")), 1))
            for e in spans
            if isinstance(e.get(a), (int, float))
            and isinstance(e.get(b), (int, float))
        ]
        if not rows:
            continue
        durs = sorted(r[0] for r in rows)
        label = (
            f"{b} p50={_pct(durs, 0.5) * 1e3:.2f}ms "
            f"p90={_pct(durs, 0.9) * 1e3:.2f}ms"
        )
        if b == "executed" and batches:
            per_req = sorted(d / max(1, n) for d, n in rows)
            label += f" ({_pct(per_req, 0.5) * 1e3:.2f}ms/req)"
        parts.append(label)
    e2e = sorted(
        e["executed"] - (e.get("request", e.get("pre_prepare")))
        for e in spans
        if isinstance(e.get("executed"), (int, float))
        and isinstance(e.get("request", e.get("pre_prepare")), (int, float))
    )
    if e2e:
        parts.append(
            f"e2e p50={_pct(e2e, 0.5) * 1e3:.2f}ms "
            f"p90={_pct(e2e, 0.9) * 1e3:.2f}ms"
        )
    return ", ".join(parts)


def report(files) -> dict:
    total = {
        "batches": 0,
        "items": 0,
        "rejected": 0,
        "secs": 0.0,
        "vcs": 0,
        "spans": 0,
    }
    for path in files:
        events = load(path)
        vb = [e for e in events if e.get("ev") == "verify_batch"]
        # Failed merged windows (service trace): their per-request retries
        # are the verify_batch events; surface the failure count so a run
        # with backend trouble reads as such.
        failed = [e for e in events if e.get("ev") == "verify_window_failed"]
        if failed:
            print(f"{path.name}: {len(failed)} FAILED merged windows")
        # Both runtimes emit "view_change_start" (core/net.cc
        # trace_view_change, server.py _timer_loop).
        vcs = [e for e in events if e.get("ev") == "view_change_start"]
        spans = [e for e in events if e.get("ev") == "consensus_span"]
        deadline_fired = [
            e for e in events if e.get("ev") == "verify_deadline_fired"
        ]
        if deadline_fired:
            print(
                f"{path.name}: {len(deadline_fired)} verify deadlines fired "
                "(wedged async verifier -> CPU safety net)"
            )
        sizes = sorted(e["size"] for e in vb)
        secs = sorted(e["secs"] for e in vb)
        rejected = sum(e.get("rejected", 0) for e in vb)
        total["batches"] += len(vb)
        total["items"] += sum(sizes)
        total["rejected"] += rejected
        total["secs"] += sum(secs)
        total["vcs"] += len(vcs)
        total["spans"] += len(spans)
        batches = _batch_sizes(events)
        if batches:
            sizes_b = list(batches.values())
            total["sealed_windows"] = total.get("sealed_windows", 0) + len(
                sizes_b
            )
            total["sealed_requests"] = total.get("sealed_requests", 0) + sum(
                sizes_b
            )
            print(
                f"{path.name}: {len(sizes_b)} sealed batches, mean batch "
                f"{sum(sizes_b) / len(sizes_b):.2f}/window "
                f"(spans below are per ROUND, not per request)"
            )
        if spans:
            print(f"{path.name}: {len(spans)} consensus spans: "
                  + _span_summary(spans, batches))
        if vb:
            span = vb[-1]["ts"] - vb[0]["ts"] or 1e-9
            print(
                f"{path.name}: {len(vb)} batches, {sum(sizes)} items "
                f"(size p50={_pct(sizes, 0.5)} p90={_pct(sizes, 0.9)} "
                f"max={sizes[-1]}), verify p50={_pct(secs, 0.5) * 1e3:.2f}ms "
                f"p90={_pct(secs, 0.9) * 1e3:.2f}ms, "
                f"{sum(sizes) / span:.0f} items/s, rejected={rejected}, "
                f"view_changes={len(vcs)}"
            )
        else:
            print(f"{path.name}: no verify_batch events")
    if total["batches"]:
        print(
            f"cluster: {total['items']} verifications in {total['batches']} "
            f"launches = {total['items'] / total['batches']:.1f} items/launch "
            f"(batching-window efficiency), {total['rejected']} rejected, "
            f"{total['vcs']} view changes, "
            f"{total['secs']:.2f}s total verify time"
        )
    if total.get("sealed_windows"):
        print(
            f"cluster: {total['sealed_requests']} requests over "
            f"{total['sealed_windows']} sealed windows = mean batch "
            f"{total['sealed_requests'] / total['sealed_windows']:.2f} "
            "(the round->request attribution factor)"
        )
    if total["spans"]:
        print(
            f"cluster: {total['spans']} consensus spans "
            "(per-(view,seq) breakdowns: scripts/consensus_timeline.py)"
        )
    return total


def expand_trace_args(args) -> list:
    """Directory args expand to their sorted *.jsonl files, including one
    level of subdirectories (the harness's --trace-dir writes per-config
    cfg<i>/ subdirs); file args pass through. Single source of the
    trace-layout rule: trace_report and consensus_timeline aggregate
    freely."""
    files = []
    for arg in args:
        p = pathlib.Path(arg)
        if p.is_dir():
            files.extend(sorted(p.glob("*.jsonl")) + sorted(p.glob("*/*.jsonl")))
        else:
            files.append(p)
    return files


def main() -> None:
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    files = expand_trace_args(sys.argv[1:])
    if not files:
        sys.exit("no trace files found")
    report(files)


if __name__ == "__main__":
    main()
