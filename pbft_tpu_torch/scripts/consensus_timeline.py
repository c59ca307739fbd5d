"""Cross-replica consensus timeline: merge per-replica JSONL traces into
per-(view, seq) phase breakdowns with straggler and gap detection (the
port's copy of the reference's ``scripts/consensus_timeline.py``).

Two event sources, newest first:

- ``consensus_span`` events (this framework's phase spans): absolute
  monotonic stamps for request -> pre-prepare -> prepared -> committed ->
  executed, per replica. Full phase breakdowns.
- Legacy ``verify_batch`` events carrying ``view``/``executed`` (traces
  that predate the spans, e.g. benchmarks/traces_r5_svc_cfg*): when a
  replica's ``executed`` advances from a to b at ts, sequences a+1..b are
  known executed by ts — an upper-bound executed-at estimate per
  (view, seq) per replica. Coarser, but it localizes stragglers in
  pre-span traces without modification.

Straggler detection: within one (view, seq), a replica whose executed
stamp trails the cluster's fastest by more than --straggler-ms. Gap
detection: sequences a replica never reported executing (holes in its
coverage), and wall-clock stalls between consecutive cluster commits
longer than --gap-ms.

Monotonic stamps are comparable across processes on ONE host (CLOCK_MONOTONIC
is per-boot); for multi-host traces the per-replica phase durations stay
valid but cross-replica spreads do not — pass --no-spread to suppress them.

Usage: python -m pbft_tpu_torch.scripts.consensus_timeline TRACE_DIR_OR_FILE...
           [--json] [--straggler-ms 50] [--gap-ms 500] [--limit 20]
"""

from __future__ import annotations

import argparse
import json
import sys

from .trace_report import expand_trace_args, load

PHASE_ORDER = ("request", "pre_prepare", "prepared", "committed", "executed")

# View-change span events: collected per replica for the
# waterfall report and the --check-invariants ordering checks.
VIEW_EVENTS = ("view_timer_fired", "view_change_sent", "new_view_installed")


def _replica_of(e) -> object:
    """Numeric replica id, or None for non-replica emitters ("service")."""
    rid = e.get("replica")
    return rid if isinstance(rid, int) else None


def collect_events(files, names) -> list:
    """Every event with ``ev`` in ``names``, merged across files."""
    out = []
    for path in files:
        for e in load(path):
            if e.get("ev") in names:
                out.append(e)
    return out


def batch_sizes(files) -> dict:
    """{(view, seq) -> sealed batch size} from batch_sealed events —
    the per-slot occupancy that turns per-ROUND segment times into
    per-REQUEST attribution (spans are per (view, seq) since the batched
    agreement PR; a report that labels them as single requests
    overstates per-request cost by the batch factor)."""
    sizes: dict = {}
    for e in collect_events(files, ("batch_sealed",)):
        try:
            sizes[(int(e["view"]), int(e["seq"]))] = int(e["batch"])
        except (KeyError, TypeError, ValueError):
            continue
    return sizes


def build_timeline(files) -> dict:
    """{(view, seq) -> {replica -> {phase -> ts}}} merged across files.

    Span events carry full stamps; legacy verify_batch events contribute
    an "executed" upper bound (span data wins when both exist)."""
    slots: dict = {}

    def slot(view, seq, rid):
        return slots.setdefault((view, seq), {}).setdefault(rid, {})

    for path in files:
        last_executed: dict = {}  # rid -> last seen executed counter
        for e in load(path):
            rid = _replica_of(e)
            if rid is None:
                continue
            ev = e.get("ev")
            if ev == "consensus_span":
                try:
                    key_view, key_seq = int(e["view"]), int(e["seq"])
                except (KeyError, TypeError, ValueError):
                    continue
                entry = slot(key_view, key_seq, rid)
                for phase in PHASE_ORDER:
                    if isinstance(e.get(phase), (int, float)):
                        entry[phase] = float(e[phase])
                entry.pop("estimated", None)  # spans beat estimates
            elif ev == "verify_batch" and isinstance(e.get("executed"), int):
                prev = last_executed.get(rid)
                cur = e["executed"]
                if prev is not None and cur > prev:
                    view = e.get("view", 0)
                    for seq in range(prev + 1, cur + 1):
                        entry = slot(view, seq, rid)
                        if "executed" not in entry:
                            entry["executed"] = float(e["ts"])
                            entry["estimated"] = True
                last_executed[rid] = cur
    return slots


def analyze(
    slots: dict,
    straggler_ms: float,
    gap_ms: float,
    spread: bool,
    batches: dict = None,
) -> dict:
    """Per-slot breakdowns + cluster-level straggler/gap summary.

    ``batches`` ((view, seq) -> sealed size, from batch_sizes) attributes
    each slot to its real request count: slots gain a "batch" field and
    per-request amortized execute time, and the summary reports the mean
    batch per window — a batched round is NOT one request."""
    batches = batches or {}
    replicas = sorted({r for per in slots.values() for r in per})
    breakdown = []
    for (view, seq) in sorted(slots):
        per = slots[(view, seq)]
        entry = {"view": view, "seq": seq, "replicas": {}}
        if (view, seq) in batches:
            entry["batch"] = batches[(view, seq)]
        for rid in sorted(per):
            stamps = per[rid]
            rep = {
                p: round(stamps[p], 6) for p in PHASE_ORDER if p in stamps
            }
            if stamps.get("estimated"):
                rep["estimated"] = True
            durs = {}
            chain = [p for p in PHASE_ORDER if p in stamps]
            for a, b in zip(chain, chain[1:]):
                durs[f"{a}->{b}"] = round(stamps[b] - stamps[a], 6)
            if durs:
                rep["durations"] = durs
            entry["replicas"][str(rid)] = rep
        execed = {
            rid: per[rid]["executed"] for rid in per if "executed" in per[rid]
        }
        if spread and len(execed) > 1:
            first = min(execed.values())
            entry["executed_spread_ms"] = round(
                (max(execed.values()) - first) * 1e3, 3
            )
            lagging = [
                rid
                for rid, ts in execed.items()
                if (ts - first) * 1e3 > straggler_ms
            ]
            if lagging:
                entry["stragglers"] = sorted(lagging)
        missing = [r for r in replicas if r not in per]
        if missing:
            entry["missing_replicas"] = missing
        breakdown.append(entry)

    # Coverage gaps: sequences a replica never reported, within the
    # cluster-wide [min, max] sequence range it was active for.
    gaps = {}
    all_seqs = sorted({seq for _, seq in slots})
    for rid in replicas:
        seen = {seq for (v, seq), per in slots.items() if rid in per}
        holes = [s for s in all_seqs if s not in seen]
        if holes:
            gaps[str(rid)] = _ranges(holes)

    # Commit stalls: wall-clock quiet periods between consecutive slots'
    # earliest executed stamps.
    stalls = []
    commit_ts = []
    for (view, seq) in sorted(slots):
        per = slots[(view, seq)]
        ts = [p["executed"] for p in per.values() if "executed" in p]
        if ts:
            commit_ts.append((view, seq, min(ts)))
    for (v0, s0, t0), (v1, s1, t1) in zip(commit_ts, commit_ts[1:]):
        if (t1 - t0) * 1e3 > gap_ms:
            stalls.append(
                {
                    "after": [v0, s0],
                    "before": [v1, s1],
                    "stall_ms": round((t1 - t0) * 1e3, 3),
                }
            )

    straggler_counts: dict = {}
    for entry in breakdown:
        for rid in entry.get("stragglers", ()):
            straggler_counts[str(rid)] = straggler_counts.get(str(rid), 0) + 1
    sized = [e["batch"] for e in breakdown if "batch" in e]
    return {
        "slots": breakdown,
        "replicas": replicas,
        "coverage_gaps": gaps,
        "commit_stalls": stalls,
        "straggler_counts": straggler_counts,
        "mean_batch": round(sum(sized) / len(sized), 2) if sized else None,
    }


def _ranges(seqs):
    """Compress a sorted int list to [lo, hi] runs."""
    runs = []
    for s in seqs:
        if runs and s == runs[-1][1] + 1:
            runs[-1][1] = s
        else:
            runs.append([s, s])
    return runs


def _fmt_slot(entry) -> str:
    parts = [f"(v={entry['view']}, n={entry['seq']})"]
    if "batch" in entry:
        parts.append(f"batch={entry['batch']}")
    if "executed_spread_ms" in entry:
        parts.append(f"spread={entry['executed_spread_ms']:.1f}ms")
    if entry.get("stragglers"):
        parts.append(f"STRAGGLERS={entry['stragglers']}")
    if entry.get("missing_replicas"):
        parts.append(f"missing={entry['missing_replicas']}")
    segs = []
    for rid, rep in entry["replicas"].items():
        durs = rep.get("durations")
        if durs and not rep.get("estimated"):
            seg = " ".join(
                f"{k.split('->')[1]}+{v * 1e3:.1f}ms" for k, v in durs.items()
            )
            segs.append(f"r{rid}[{seg}]")
    if segs:
        parts.append(" ".join(segs))
    return "  ".join(parts)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("traces", nargs="+", help="trace dirs or .jsonl files")
    parser.add_argument("--json", action="store_true", help="machine output")
    parser.add_argument("--straggler-ms", type=float, default=50.0)
    parser.add_argument("--gap-ms", type=float, default=500.0)
    parser.add_argument(
        "--limit", type=int, default=20, help="slots to print (0 = all)"
    )
    parser.add_argument(
        "--no-spread",
        action="store_true",
        help="multi-host traces: clocks are not comparable across replicas",
    )
    parser.add_argument(
        "--check-invariants",
        action="store_true",
        help="run the protocol-order invariants (consensus/invariants.py "
        "check_spans + check_view_events) over the merged span data: "
        "phase monotonicity, in-order execution, single-execution per "
        "sequence, and view_timer_fired -> view_change_sent -> "
        "new_view_installed ordering",
    )
    parser.add_argument(
        "--waterfall",
        action="store_true",
        help="join client_request traces (net/client.py write_trace) with "
        "replica request_rx/batch_sealed/consensus_span events into "
        "per-request segment breakdowns with p50/p95/p99 per segment "
        "(client queue, batch wait, prepared, committed, execute, reply)",
    )
    args = parser.parse_args(argv)
    files = expand_trace_args(args.traces)
    if not files:
        sys.exit("no trace files found")
    slots = build_timeline(files)
    if not slots:
        sys.exit("no consensus_span or executed-bearing verify_batch events")
    batches = batch_sizes(files)
    view_events = collect_events(files, VIEW_EVENTS)
    result = analyze(
        slots,
        args.straggler_ms,
        args.gap_ms,
        spread=not args.no_spread,
        batches=batches,
    )
    result["view_events"] = len(view_events)
    if args.waterfall:
        from ..utils import waterfall as wf_mod

        events = wf_mod.load_jsonl(files)
        result["waterfall"] = wf_mod.build_waterfall(
            events, wf_mod.client_records_from_events(events)
        )
    if args.check_invariants:
        from ..consensus.invariants import check_spans, check_view_events

        result["invariant_problems"] = check_spans(slots) + check_view_events(
            view_events
        )
    if args.json:
        print(json.dumps(result, indent=1, sort_keys=True))
        return result
    n = len(result["slots"])
    print(
        f"{n} (view, seq) slots from {len(files)} trace files, "
        f"replicas={result['replicas']}"
    )
    if result.get("mean_batch"):
        print(
            f"mean batch per sealed window: {result['mean_batch']} "
            "(segment times below are per ROUND — a batched round "
            "carries that many requests)"
        )
    shown = result["slots"] if args.limit == 0 else result["slots"][: args.limit]
    for entry in shown:
        print("  " + _fmt_slot(entry))
    if n > len(shown):
        print(f"  ... {n - len(shown)} more slots (--limit 0 for all)")
    if args.waterfall:
        from ..utils import waterfall as wf_mod

        print(wf_mod.render(result["waterfall"]))
    if result["straggler_counts"]:
        worst = sorted(
            result["straggler_counts"].items(), key=lambda kv: -kv[1]
        )
        print(
            "stragglers (> %.0fms behind fastest): %s"
            % (
                args.straggler_ms,
                ", ".join(f"replica {r}: {c} slots" for r, c in worst),
            )
        )
    else:
        print(f"no stragglers (> {args.straggler_ms:.0f}ms)")
    for rid, runs in result["coverage_gaps"].items():
        print(f"coverage gap: replica {rid} never executed seqs {runs}")
    for st in result["commit_stalls"]:
        print(
            f"commit stall: {st['stall_ms']:.0f}ms between "
            f"(v={st['after'][0]}, n={st['after'][1]}) and "
            f"(v={st['before'][0]}, n={st['before'][1]})"
        )
    if "invariant_problems" in result:
        problems = result["invariant_problems"]
        if problems:
            print(f"INVARIANT VIOLATIONS ({len(problems)}):")
            for p in problems:
                print(f"  {p}")
        else:
            print("invariants: phase order, execution order, and "
                  "single-execution all hold")
    return result


if __name__ == "__main__":
    result = main()
    sys.exit(1 if result.get("invariant_problems") else 0)
