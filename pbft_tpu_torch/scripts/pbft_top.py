"""pbft_top — live cluster health console + anomaly gate (the port's
copy of the reference's ``scripts/pbft_top.py``).

Polls every replica's /status endpoint (the versioned health document
both runtimes serve next to /metrics; optionally a gateway's too) on an
interval, renders a one-screen view — view/seq/floor, req/s, RSS, fds,
WAL size, backoff level per replica — and continuously runs the port's
detector library (pbft_tpu_torch/analysis/health.py) over the
accumulated snapshot history.

    # watch a live cluster
    python -m pbft_tpu_torch.scripts.pbft_top --targets 127.0.0.1:9100,...

    # CI gate: sample a window once, exit non-zero on any anomaly with a
    # machine-readable verdict (+ decoded flight black boxes) on stdout
    python -m pbft_tpu_torch.scripts.pbft_top --targets ... --gate --once \
        --flight-dir flight/

In --gate mode (continuous) the first anomaly ends the run: the JSON
verdict carries the tripped detectors, the evidence windows, and every
black box found under --flight-dir. Exit codes: 0 healthy, 1 anomaly,
2 usage/unreachable-cluster.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import urllib.request
from collections import deque

from ..analysis import health
from ..utils.trace_schema import HEALTH_DOC_VERSION


def fetch_status(target: str, timeout: float = 2.0):
    """One health document from host:port/status, or None (down/slow)."""
    try:
        with urllib.request.urlopen(
            f"http://{target}/status", timeout=timeout
        ) as resp:
            return json.loads(resp.read().decode())
    except (OSError, ValueError):
        return None


def take_snapshot(targets, t):
    """{"t": t, "replicas": {rid: doc}} from one poll sweep. Replicas
    that don't answer, or answer with a foreign health_version, are
    absent (the detectors treat absence as no-data, not as zeros)."""
    replicas = {}
    for ix, target in enumerate(targets):
        doc = fetch_status(target)
        if doc is None:
            continue
        if doc.get("health_version") != HEALTH_DOC_VERSION:
            continue
        replicas[doc.get("replica", ix)] = doc
    return {"t": t, "replicas": replicas}


def _rate(history, rid, key, span_snapshots=5):
    """Per-second delta of a counter over the last few snapshots."""
    series = [
        (s["t"], s["replicas"][rid].get(key))
        for s in list(history)[-span_snapshots:]
        if rid in s.get("replicas", {}) and key in s["replicas"][rid]
    ]
    if len(series) < 2:
        return 0.0
    dt = series[-1][0] - series[0][0]
    if dt <= 0:
        return 0.0
    return max(0.0, (series[-1][1] - series[0][1]) / dt)


def render(history, verdicts, gateway_doc=None) -> str:
    latest = history[-1]
    lines = [
        "pbft_top — %d replica(s), %d snapshot(s), span %.0fs"
        % (
            len(latest["replicas"]),
            len(history),
            history[-1]["t"] - history[0]["t"],
        ),
        "%3s %5s %9s %9s %7s %8s %9s %5s %9s %4s %7s"
        % ("id", "view", "executed", "committed", "floor", "req/s",
           "rss", "fds", "wal", "bkff", "stall_s"),
    ]
    for rid in sorted(latest["replicas"]):
        doc = latest["replicas"][rid]
        lines.append(
            "%3s %5d %9d %9d %7d %8.1f %8.1fM %5d %8.1fK %4d %7.1f"
            % (
                rid,
                doc.get("view", 0),
                doc.get("executed_upto", 0),
                doc.get("committed_upto", 0),
                doc.get("low_mark", 0),
                _rate(history, rid, "executed"),
                doc.get("rss_bytes", 0) / 1e6,
                doc.get("open_fds", 0),
                doc.get("wal_disk_bytes", 0) / 1e3,
                doc.get("view_timer_backoff", 1),
                doc.get("last_progress_seconds", 0.0),
            )
        )
    if gateway_doc:
        lines.append(
            "gateway: clients=%d forwarded=%d inflight=%d rss=%.1fM fds=%d"
            % (
                gateway_doc.get("gateway_clients_open", 0),
                gateway_doc.get("gateway_forwarded", 0),
                gateway_doc.get("inflight", 0),
                gateway_doc.get("rss_bytes", 0) / 1e6,
                gateway_doc.get("open_fds", 0),
            )
        )
    if verdicts:
        lines.append("ANOMALIES:")
        for v in verdicts:
            lines.append(
                "  [%s] replica=%s %s" % (v["detector"], v["replica"], v["reason"])
            )
    else:
        lines.append("healthy: no detector tripped")
    return "\n".join(lines)


def collect_blackboxes(flight_dir, tail=40):
    """Decode every *.flight under flight_dir (the dead replicas' last
    moments ride inside the gate verdict)."""
    from ..utils.flight import decode_file

    out = {}
    if not flight_dir:
        return out
    for p in sorted(pathlib.Path(flight_dir).glob("*.flight")):
        try:
            out[str(p)] = decode_file(str(p))[-tail:]
        except (OSError, ValueError) as e:
            out[str(p)] = f"undecodable: {e}"
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "--targets", required=True,
        help="comma-separated replica status endpoints (host:port,...)")
    parser.add_argument(
        "--gateway", default=None,
        help="optional gateway status endpoint (host:port)")
    parser.add_argument(
        "--interval", type=float,
        default=float(health.HEALTH_SNAPSHOT_INTERVAL_S),
        help="seconds between polls (default: the lint-paired "
             "HEALTH_SNAPSHOT_INTERVAL_S)")
    parser.add_argument(
        "--window-s", type=float, default=None,
        help="--once: seconds of history to sample before judging "
             "(default 3x the stall threshold)")
    parser.add_argument(
        "--stall-seconds", type=float,
        default=float(health.HEALTH_STALL_SECONDS),
        help="silent-stall / stuck-view-change threshold")
    parser.add_argument(
        "--once", action="store_true",
        help="sample one window, judge once, print, exit (CI mode)")
    parser.add_argument(
        "--gate", action="store_true",
        help="exit 1 with a JSON verdict on the first anomaly")
    parser.add_argument(
        "--flight-dir", default=None,
        help="collect *.flight black boxes into the gate verdict")
    parser.add_argument(
        "--max-snapshots", type=int, default=600,
        help="history ring size (continuous mode)")
    args = parser.parse_args(argv)

    targets = [t.strip() for t in args.targets.split(",") if t.strip()]
    if not targets:
        print("pbft_top: no targets", file=sys.stderr)
        return 2
    window_s = args.window_s
    if window_s is None:
        window_s = 3 * args.stall_seconds

    history: deque = deque(maxlen=max(2, args.max_snapshots))
    t0 = time.monotonic()
    deadline = t0 + window_s if args.once else None
    is_tty = sys.stdout.isatty()

    while True:
        now = time.monotonic()
        snap = take_snapshot(targets, now - t0)
        history.append(snap)
        gateway_doc = fetch_status(args.gateway) if args.gateway else None
        verdicts = health.run_detectors(
            list(history), stall_seconds=args.stall_seconds
        )
        if not snap["replicas"] and len(history) >= 3 and all(
            not s["replicas"] for s in list(history)[-3:]
        ):
            print("pbft_top: no target answered 3 polls in a row",
                  file=sys.stderr)
            return 2

        judging = (not args.once) or now >= deadline
        if args.gate and judging and verdicts:
            verdict_doc = {
                "ok": False,
                "verdicts": verdicts,
                "snapshots": len(history),
                "span_seconds": round(
                    history[-1]["t"] - history[0]["t"], 3),
                "flight": collect_blackboxes(args.flight_dir),
            }
            print(json.dumps(verdict_doc))
            return 1

        if not args.once:
            if is_tty:
                sys.stdout.write("\x1b[2J\x1b[H")  # one-screen live view
            print(render(list(history), verdicts, gateway_doc))
            sys.stdout.flush()
        elif now >= deadline:
            print(render(list(history), verdicts, gateway_doc))
            if args.gate:
                print(json.dumps({
                    "ok": True,
                    "verdicts": [],
                    "snapshots": len(history),
                    "span_seconds": round(
                        history[-1]["t"] - history[0]["t"], 3),
                }))
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except KeyboardInterrupt:
        sys.exit(0)
