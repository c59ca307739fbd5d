"""endurance_soak — duration-parameterized WAL-on firehose with a
health-flatness gate: the port's copy of the reference's
``scripts/endurance_soak.py``, on the port's ``LocalCluster``, gateway
and (by default) asyncio replicas.

Runs a real localhost cluster (WAL on, scrape ports on) behind one
gateway, drives a sustained client firehose for ``--duration-s``
(minutes in CI, an hour by hand), snapshots every replica's /status
health document every ``--snapshot-every-s``, and at the end gates the
run with the detector library: fd count, RSS, and WAL on-disk bytes
must stay flat (robust Theil-Sen slope under the leak floors), no
silent stalls, no divergence, no stuck view change. One
bench_compare-compatible JSONL row lands in ``--out``.

``--verifier`` and ``--service-backend`` as in chaos_bench: by default
every replica verifies on the port's daemon, warmed on the card (a
failed warm exits 2); on a service the row carries
``verify_accounting`` (the service's items against the replicas'
signature checks).

    # CI-sized: three minutes, gate on
    python -m pbft_tpu_torch.scripts.endurance_soak --duration-s 180 \
        --out endurance.jsonl

    # the hour-scale soak (run by hand), host verify pools
    python -m pbft_tpu_torch.scripts.endurance_soak --duration-s 3600 \
        --clients 8 --verifier cpu

Exit codes: 0 gate green, 1 detector tripped (verdicts inside the row),
2 harness failure.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import pathlib
import sys
import threading
import time

from ..analysis import health
from ..net.launcher import LocalCluster
from .chaos_bench import (
    add_verifier_args,
    open_verifier,
    run_load,
    start_gateway,
    verify_accounting,
)


def _pct(vals, q):
    return vals[min(len(vals) - 1, int(q * len(vals)))] if vals else 0.0


class LoadThread(threading.Thread):
    """Background firehose: rounds of pipelined gateway load until the
    deadline. Round-sized (not one giant request count) so a wedged
    cluster can't hang the soak past the deadline by much."""

    def __init__(self, gw_port, clients, requests_each, window, quorum,
                 deadline):
        super().__init__(daemon=True)
        self.gw_port = gw_port
        self.clients = clients
        self.requests_each = requests_each
        self.window = window
        self.quorum = quorum
        self.deadline = deadline
        self.completed = 0
        self.attempted = 0
        self.latencies_ms: list = []
        self.rounds = 0
        self.error = None

    def run(self):
        try:
            while time.monotonic() < self.deadline:
                done, _, lats, _ = asyncio.run(run_load(
                    "127.0.0.1", [self.gw_port], self.clients,
                    self.requests_each, self.window, self.quorum,
                    deadline_s=max(
                        5.0, min(60.0, self.deadline - time.monotonic())
                    ),
                    token_prefix=f"soak{self.rounds}",
                ))
                self.completed += done
                self.attempted += self.clients * self.requests_each
                self.latencies_ms.extend(lats)
                self.rounds += 1
        except Exception as e:  # surfaced as a harness failure (exit 2)
            self.error = e


def fetch_status(port):
    import urllib.request

    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/status", timeout=2
        ) as resp:
            return json.loads(resp.read().decode())
    except (OSError, ValueError):
        return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--duration-s", type=float, default=180.0)
    parser.add_argument(
        "--snapshot-every-s", type=float,
        default=float(health.HEALTH_SNAPSHOT_INTERVAL_S))
    parser.add_argument("--n", type=int, default=4)
    parser.add_argument("--clients", type=int, default=6)
    parser.add_argument("--requests-each", type=int, default=200,
                        help="requests per client per load round")
    parser.add_argument("--window", type=int, default=8)
    parser.add_argument("--impl", default="py",
                        help='"py" (the port\'s asyncio replicas, default), '
                        '"cxx", or comma list per replica')
    parser.add_argument("--seed", type=int, default=16)
    parser.add_argument("--no-wal", action="store_true")
    parser.add_argument("--no-gate", action="store_true",
                        help="report verdicts but always exit 0")
    parser.add_argument("--out", default=None, help="append JSONL row here")
    add_verifier_args(parser)
    args = parser.parse_args(argv)

    impl = args.impl.split(",") if "," in args.impl else args.impl
    f = (args.n - 1) // 3
    history: list = []
    try:
        verifier, daemon = open_verifier(args)
    except (RuntimeError, TimeoutError) as e:
        print(f"endurance_soak: the verify daemon did not warm: {e}",
              file=sys.stderr)
        return 2
    try:
        return _soak(args, impl, f, history, verifier)
    finally:
        if daemon is not None:
            daemon.stop()


def _soak(args, impl, f, history, verifier) -> int:
    from ..net.verify_service import probe_status_json

    on_service = verifier not in ("cpu", "cuda")
    status0 = probe_status_json(verifier) if on_service else None
    if on_service and status0 is None:
        print(f"endurance_soak: the verify service at {verifier} does not "
              "answer", file=sys.stderr)
        return 2
    accounting = None
    t_start = time.monotonic()

    with LocalCluster(
        n=args.n, impl=impl, wal=not args.no_wal, metrics_ports=True,
        batch_max_items=32, batch_flush_us=2000, verifier=verifier,
    ) as cluster:
        tmp = pathlib.Path(cluster.tmpdir.name)
        gw_proc, gw_port = start_gateway(
            tmp / "network.json", tmp / "gateway.log",
            extra=("--metrics-port", "0"),
        )
        try:
            deadline = time.monotonic() + args.duration_s
            load = LoadThread(
                gw_port, args.clients, args.requests_each, args.window,
                quorum=f + 1, deadline=deadline,
            )
            load.start()
            while time.monotonic() < deadline:
                time.sleep(args.snapshot_every_s)
                snap = {"t": time.monotonic() - t_start, "replicas": {}}
                for i, port in enumerate(cluster.metrics_ports):
                    doc = fetch_status(port)
                    if doc is not None:
                        snap["replicas"][doc.get("replica", i)] = doc
                history.append(snap)
                if len(history) % 15 == 0:
                    print(
                        "t=%5.0fs snapshots=%d completed=%d"
                        % (snap["t"], len(history), load.completed),
                        flush=True,
                    )
            load.join(timeout=90)
            if load.error is not None:
                print(f"endurance_soak: load generator failed: {load.error}",
                      file=sys.stderr)
                return 2
            if on_service:
                def read():
                    docs = [fetch_status(p) for p in cluster.metrics_ports]
                    return [[[d]] if d else [] for d in docs]

                accounting = verify_accounting(
                    cluster, verifier, status0, read=read)
        finally:
            gw_proc.terminate()

    verdicts = health.run_detectors(history)
    seconds = time.monotonic() - t_start
    lats = sorted(load.latencies_ms)
    ok = not verdicts
    first = history[0]["replicas"] if history else {}
    last = history[-1]["replicas"] if history else {}

    def spread(key):
        return {
            str(rid): {
                "first": first.get(rid, {}).get(key, 0),
                "last": last.get(rid, {}).get(key, 0),
            }
            for rid in sorted(last)
        }

    def slopes(key):
        """Per replica, the Theil-Sen slope (per second) the leak detector
        judges: nonzero readings after the 25% warmup prefix."""
        out = {}
        for rid in sorted(last):
            pts = [(s["t"], s["replicas"][rid][key]) for s in history
                   if rid in s["replicas"] and s["replicas"][rid].get(key, 0) > 0]
            pts = pts[int(len(pts) * 0.25):]
            out[str(rid)] = health.theil_sen_slope(pts)
        return out

    row = {
        "config": f"endurance wal={'off' if args.no_wal else 'on'}",
        "arm": "endurance",
        "replicas": args.n,
        "f": f,
        "clients": args.clients,
        "seed": args.seed,
        "requests": load.completed,
        "attempted": load.attempted,
        "seconds": round(seconds, 3),
        "requests_per_sec": round(load.completed / seconds, 1)
        if seconds > 0 else 0.0,
        "reply_p50_ms": round(_pct(lats, 0.50), 3),
        "reply_p99_ms": round(_pct(lats, 0.99), 3),
        "completed_pct": round(100.0 * load.completed / load.attempted, 2)
        if load.attempted else 0.0,
        "window": args.window,
        "gateways": 1,
        "snapshots": len(history),
        "snapshot_every_s": args.snapshot_every_s,
        "rss_bytes": spread("rss_bytes"),
        "open_fds": spread("open_fds"),
        "wal_disk_bytes": spread("wal_disk_bytes"),
        "slopes_per_s": {
            key: slopes(key)
            for key in ("rss_bytes", "open_fds", "wal_disk_bytes")
        },
        "health_verdicts": verdicts,
        "ok": ok,
    }
    if accounting is not None:
        row["verify_accounting"] = accounting
    print(json.dumps(row))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with out.open("a") as fh:
            fh.write(json.dumps(row) + "\n")
    if verdicts:
        for v in verdicts:
            print(
                "VERDICT [%s] replica=%s %s"
                % (v["detector"], v["replica"], v["reason"]),
                file=sys.stderr,
            )
    return 0 if (ok or args.no_gate) else 1


if __name__ == "__main__":
    sys.exit(main())
