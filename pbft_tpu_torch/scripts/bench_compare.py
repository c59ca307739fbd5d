"""bench_compare — diff two benchmark runs and gate regressions: the
port's copy of the reference's ``scripts/bench_compare.py``.

It reads two benchmark files, JSONL (one JSON object per run: the rows
that ``pbft_tpu_torch.bench.harness``, ``scripts.chaos_bench``,
``scripts.endurance_soak``, ``scripts.scale_curve`` and
``scripts.window_sweep`` print) or a single JSON object (a one-line bench
result), aggregates each named metric across runs (median by default,
robust to one noisy run), and exits nonzero when any metric regressed by
more than ``--max-regress-pct``.

    python -m pbft_tpu_torch.scripts.bench_compare old.jsonl new.jsonl \
        --max-regress-pct 10
    # per cluster size, for scale_curve rows:
    python -m pbft_tpu_torch.scripts.bench_compare old.jsonl new.jsonl \
        --group-by replicas

Metrics are higher-is-better unless listed in ``--lower-better``.
Defaults compare every known rate metric present in BOTH files.
Exit codes: 0 ok, 1 regression, 2 usage/data error. No difference from
the reference but the docstring and comments.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Dict, List

# Rate metrics the harnesses emit today; --metric overrides.
DEFAULT_METRICS = (
    "rounds_per_sec",
    "requests_per_sec",
    "sig_verifies_per_sec",
    "value",  # bench.py single-line result (verifies/sec)
    "reply_p99_ms",  # client-observed p99 reply latency
)

# Default-gated metrics where SMALLER is the improvement: p99 reply
# latency regresses by going UP even when throughput holds (a batching
# knob can buy requests/sec with tail latency — the gate must see both).
DEFAULT_LOWER_BETTER = frozenset({"reply_p99_ms"})


def load_runs(path: str) -> List[dict]:
    """A JSONL file of run objects, or a single JSON object/array."""
    with open(path) as fh:
        text = fh.read().strip()
    if not text:
        raise ValueError(f"{path}: empty benchmark file")
    try:
        obj = json.loads(text)
        if isinstance(obj, dict):
            return [obj]
        if isinstance(obj, list):
            return [r for r in obj if isinstance(r, dict)]
    except ValueError:
        pass
    runs = []
    for i, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except ValueError as e:
            raise ValueError(f"{path}:{i}: not JSON ({e})") from e
        if isinstance(row, dict):
            runs.append(row)
    if not runs:
        raise ValueError(f"{path}: no run objects found")
    return runs


def collect(runs: List[dict], metric: str) -> List[float]:
    out = []
    for row in runs:
        v = row.get(metric)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out.append(float(v))
    return out


AGGREGATES = {
    "median": statistics.median,
    "mean": statistics.fmean,
    "min": min,
    "max": max,
}


def compare(
    old_runs: List[dict],
    new_runs: List[dict],
    metrics: List[str],
    max_regress_pct: float,
    agg: str = "median",
    lower_better: frozenset = frozenset(),
) -> Dict[str, dict]:
    """Per-metric {old, new, delta_pct, regressed}. ``delta_pct`` is
    signed improvement (positive = better), so the gate is uniform:
    ``regressed = delta_pct < -max_regress_pct``."""
    fn = AGGREGATES[agg]
    report = {}
    for metric in metrics:
        old_vals = collect(old_runs, metric)
        new_vals = collect(new_runs, metric)
        if not old_vals or not new_vals:
            continue
        old, new = fn(old_vals), fn(new_vals)
        if old == 0:
            delta_pct = 0.0 if new == 0 else float("inf")
        else:
            delta_pct = (new - old) / abs(old) * 100.0
        if metric in lower_better:
            delta_pct = -delta_pct
        report[metric] = {
            "old": round(old, 3),
            "new": round(new, 3),
            "runs": (len(old_vals), len(new_vals)),
            "delta_pct": round(delta_pct, 2),
            "regressed": delta_pct < -max_regress_pct,
        }
    return report


def group_runs(runs: List[dict], key: str) -> Dict[str, List[dict]]:
    """Partition runs by a row field (e.g. ``replicas`` for the scale
    curve): rows missing the field land in the "" group."""
    groups: Dict[str, List[dict]] = {}
    for row in runs:
        groups.setdefault(str(row.get(key, "")), []).append(row)
    return groups


def compare_grouped(
    old_runs: List[dict],
    new_runs: List[dict],
    key: str,
    metrics: List[str],
    max_regress_pct: float,
    agg: str = "median",
    lower_better: frozenset = frozenset(),
) -> Dict[str, dict]:
    """compare(), but per group of ``key`` (scripts.scale_curve emits
    one row per cluster size; --group-by replicas gates each n's medians
    and p99 separately instead of blurring the curve into one median).
    Only groups present in BOTH files are compared; report keys are
    ``<key>=<group>:<metric>``."""
    old_groups = group_runs(old_runs, key)
    new_groups = group_runs(new_runs, key)
    report: Dict[str, dict] = {}
    for g in sorted(old_groups.keys() & new_groups.keys()):
        sub = compare(
            old_groups[g], new_groups[g], metrics, max_regress_pct,
            agg=agg, lower_better=lower_better,
        )
        for m, r in sub.items():
            report[f"{key}={g}:{m}"] = r
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("old", help="baseline benchmark file (json/jsonl)")
    parser.add_argument("new", help="candidate benchmark file (json/jsonl)")
    parser.add_argument(
        "--metric",
        action="append",
        default=None,
        help="metric field to gate (repeatable; default: every known "
        "rate metric present in both files)",
    )
    parser.add_argument(
        "--max-regress-pct",
        type=float,
        default=10.0,
        help="fail when a metric drops by more than this percent "
        "(default 10)",
    )
    parser.add_argument(
        "--agg",
        choices=sorted(AGGREGATES),
        default="median",
        help="aggregate across runs in a file (default median)",
    )
    parser.add_argument(
        "--lower-better",
        action="append",
        default=[],
        help="metrics where smaller is an improvement (e.g. latency); "
        "reply_p99_ms is treated as lower-better by default",
    )
    parser.add_argument(
        "--group-by",
        default=None,
        help="partition runs by this row field and gate each group "
        "separately (e.g. --group-by replicas for scale_curve output: "
        "per-n medians and p99 instead of one blurred median)",
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable report"
    )
    args = parser.parse_args(argv)

    try:
        old_runs = load_runs(args.old)
        new_runs = load_runs(args.new)
    except (OSError, ValueError) as e:
        print(f"bench_compare: {e}", file=sys.stderr)
        return 2
    metrics = args.metric or list(DEFAULT_METRICS)
    lower = DEFAULT_LOWER_BETTER | frozenset(args.lower_better)
    if args.group_by:
        report = compare_grouped(
            old_runs, new_runs, args.group_by, metrics,
            args.max_regress_pct, agg=args.agg, lower_better=lower,
        )
    else:
        report = compare(
            old_runs,
            new_runs,
            metrics,
            args.max_regress_pct,
            agg=args.agg,
            lower_better=lower,
        )
    if not report:
        print(
            f"bench_compare: no shared numeric metric among {metrics} "
            f"in {args.old} vs {args.new}",
            file=sys.stderr,
        )
        return 2
    regressed = [m for m, r in report.items() if r["regressed"]]
    if args.json:
        print(
            json.dumps(
                {
                    "ok": not regressed,
                    "max_regress_pct": args.max_regress_pct,
                    "agg": args.agg,
                    "metrics": report,
                }
            )
        )
    else:
        width = max(len(m) for m in report)
        for m, r in report.items():
            mark = "REGRESSED" if r["regressed"] else "ok"
            print(
                f"{m:<{width}}  {r['old']:>12} -> {r['new']:>12}  "
                f"({r['delta_pct']:+.2f}%)  {mark}"
            )
        if regressed:
            print(
                f"bench_compare: {', '.join(regressed)} regressed more "
                f"than {args.max_regress_pct}% ({args.agg} over runs)",
                file=sys.stderr,
            )
    return 1 if regressed else 0


if __name__ == "__main__":
    sys.exit(main())
