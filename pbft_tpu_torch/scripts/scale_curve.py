"""scale_curve — the firehose curve over cluster sizes through the gateway
tier: the port's copy of the reference's ``scripts/scale_curve.py``, on the
port's ``LocalCluster``, gateway and ``ClientRequest``.

Sustained rounds/sec, requests/sec and client-observed reply p50/p99
versus cluster size n ∈ {4, 7, 16, 31} (f ∈ {1, 2, 5, 10}), driven by a
many-identity load generator that reaches the cluster through the
client-gateway tier (``pbft_tpu_torch.net.gateway``): 10k concurrent
client identities cost the cluster ~n·gateways sockets instead of ~n·10k.

Each row is bench_compare-compatible JSONL, one row per n and mode:

    python -m pbft_tpu_torch.scripts.scale_curve --n 4 --clients 8 \
        --requests 25
    python -m pbft_tpu_torch.scripts.scale_curve --n 4,7,16,31 \
        --clients 16 --batch 256 --out scale_curve.jsonl
    # on the CPU (each replica's host verify pool):
    python -m pbft_tpu_torch.scripts.scale_curve --n 4 --verifier cpu
    # gate a candidate against a baseline, per n:
    python -m pbft_tpu_torch.scripts.bench_compare old.jsonl new.jsonl \
        --group-by replicas

Where the signatures are verified (``--verifier``, as in chaos_bench):
``daemon`` (the default) starts the port's verify daemon, warmed on the
card (``--service-backend cuda``; a failed warm exits 2 and nothing falls
back to the host), and dials every replica to it; each row then carries
``verify_accounting``, the daemon's items against the replicas' signature
checks. ``cpu`` is each replica's host verify pool, ``cuda`` the card in
each asyncio replica's process (``--impl py``), ``HOST:PORT`` a running
verify service. The reference always runs its clusters with
``verifier="cpu"``; that is the deliberate difference.

The 10k arm (``--clients 10000 --requests 1 --window 1``) needs file
descriptors: the load generator and the gateway each hold one socket per
identity. The script raises RLIMIT_NOFILE toward its hard limit and
refuses loudly when even that is too small (raise ``ulimit -n`` first).

Exit status: 0 when every point completed at least 99% of its load, 1
otherwise, 2 when the daemon did not warm.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import re
import resource
import subprocess
import sys
import time
from pathlib import Path

from ..consensus.messages import ClientRequest
from ..net.gateway import GATEWAY_CLIENT_PREFIX
from ..net.launcher import LocalCluster
from .chaos_bench import add_verifier_args, open_verifier, start_gateway, verify_accounting

# The BASELINE curve's cluster sizes.
CURVE_NS = (4, 7, 16, 31)


def ensure_fd_headroom(need: int) -> None:
    """Raise the soft RLIMIT_NOFILE toward the hard limit; fail loudly
    when the hard limit cannot cover the run (the fix is ulimit -n)."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < need:
        try:
            resource.setrlimit(
                resource.RLIMIT_NOFILE, (min(need, hard), hard)
            )
        except (ValueError, OSError):
            pass
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < need:
        raise SystemExit(
            f"scale_curve: need ~{need} file descriptors but "
            f"RLIMIT_NOFILE is {soft} (hard {hard}); raise it with "
            f"`ulimit -n {need}` and rerun"
        )


async def drive_identity(
    host: str,
    port: int,
    token: str,
    n_requests: int,
    window: int,
    quorum: int,
    retransmit_s: float,
    deadline_s: float,
    latencies_ms: list,
    tentative_quorum: int = 0,
) -> int:
    """One client identity: pipeline ``window`` requests over its gateway
    connection, count each request complete at ``quorum`` distinct-replica
    matching replies, retransmit overdue requests (the gateway broadcasts
    a retransmission to all replicas). Returns completed count."""
    reader, writer = await asyncio.open_connection(host, port)
    pending: dict = {}  # ts -> state
    done = 0
    next_ts = 0
    buf = b""
    hard_deadline = time.monotonic() + deadline_s
    try:
        while done < n_requests:
            now = time.monotonic()
            if now > hard_deadline:
                break
            while next_ts < n_requests and len(pending) < window:
                next_ts += 1
                req = ClientRequest(
                    operation=f"{token}#{next_ts}",
                    timestamp=next_ts,
                    client=token,
                )
                line = req.canonical() + b"\n"
                writer.write(line)
                pending[next_ts] = {
                    "line": line,
                    "send": now,
                    "retry": now + retransmit_s,
                    "votes": {},
                }
            await writer.drain()
            try:
                chunk = await asyncio.wait_for(reader.read(65536), timeout=0.5)
            except asyncio.TimeoutError:
                chunk = None
            if chunk == b"":
                break  # gateway gone
            if chunk:
                buf += chunk
                while True:
                    nl = buf.find(b"\n")
                    if nl < 0:
                        break
                    line, buf = buf[:nl], buf[nl + 1 :]
                    try:
                        obj = json.loads(line)
                    except ValueError:
                        continue
                    ts = obj.get("timestamp")
                    rid = obj.get("replica")
                    st = pending.get(ts)
                    if st is None or not isinstance(rid, int):
                        continue
                    st["votes"][rid] = (
                        obj.get("result"),
                        obj.get("view"),
                        1 if obj.get("tentative") else 0,
                    )
                    # Committed replies complete at `quorum` (f+1)
                    # matching; tentative ones (the fast path) need
                    # `tentative_quorum` (2f+1) matching in one view.
                    by_result: dict = {}
                    committed: dict = {}
                    for result, view, tent in st["votes"].values():
                        by_result[(result, view)] = (
                            by_result.get((result, view), 0) + 1
                        )
                        if not tent:
                            committed[result] = committed.get(result, 0) + 1
                    ok = (committed and max(committed.values()) >= quorum) or (
                        tentative_quorum > 0
                        and max(by_result.values()) >= tentative_quorum
                    )
                    if ok:
                        latencies_ms.append(
                            (time.monotonic() - st["send"]) * 1e3
                        )
                        del pending[ts]
                        done += 1
            now = time.monotonic()
            for st in pending.values():
                if now > st["retry"]:
                    writer.write(st["line"])
                    st["retry"] = now + retransmit_s
    finally:
        writer.close()
    return done


async def run_load(
    host: str,
    ports: list,
    clients: int,
    requests_each: int,
    window: int,
    quorum: int,
    deadline_s: float,
    token_prefix: str = "lg",
    tentative_quorum: int = 0,
) -> tuple:
    """``clients`` identities split round-robin across the gateway
    ``ports`` (one per gateway process)."""
    latencies_ms: list = []
    tasks = [
        drive_identity(
            host, ports[i % len(ports)],
            f"{GATEWAY_CLIENT_PREFIX}{token_prefix}-{i}", requests_each,
            window, quorum, retransmit_s=3.0, deadline_s=deadline_s,
            latencies_ms=latencies_ms, tentative_quorum=tentative_quorum,
        )
        for i in range(clients)
    ]
    t0 = time.perf_counter()
    done = await asyncio.gather(*tasks)
    return sum(done), time.perf_counter() - t0, sorted(latencies_ms)


def _pct(vals, q):
    return vals[min(len(vals) - 1, int(q * len(vals)))] if vals else 0.0


def run_point(
    n: int,
    clients: int,
    requests_each: int,
    window: int,
    batch: int,
    batch_flush_us: int,
    impl: str,
    gateways: int,
    deadline_s: float,
    net_threads: int = 1,
    mode: str = "sig",
    wal: str = "off",
    verifier: str = "cpu",
) -> dict:
    """One sustained point on the curve: an n-replica cluster, a gateway
    tier in front, ``clients`` concurrent identities through it, every
    replica on ``verifier`` (``cpu``, ``cuda`` or a verify service's
    address; on a service the row carries ``verify_accounting``).

    ``mode`` "mac" runs the fast path: per-link MAC-vector authenticators
    on normal-case frames and tentative execution (reply at PREPARED; the
    load generator then counts the 2f+1 tentative quorum), the A/B axis against
    the signature-mode arm."""
    # THIS process (the load generator) holds one socket per identity
    # plus slack; each gateway is its own process with its own limit
    # (inheriting the raised soft limit) holding clients/gateways
    # downstream + n upstream.
    ensure_fd_headroom(clients + 512)
    service = verifier not in ("cpu", "cuda")
    if service:
        from ..net.verify_service import probe_status_json

        before = probe_status_json(verifier)
        if before is None:
            raise RuntimeError(f"the verify service at {verifier} does not answer")
    with LocalCluster(
        n=n,
        verifier=verifier,
        metrics_every=1,
        impl=impl,
        batch_max_items=batch,
        batch_flush_us=batch_flush_us,
        net_threads=net_threads,
        fastpath=mode,
        tentative=(mode == "mac"),
        # Durability arms: "on" = WAL + group-commit fsync, "nofsync" =
        # WAL writes without fsync (the A/B that makes the fsync cost
        # explicit).
        wal=(wal != "off"),
        wal_fsync=(wal != "nofsync"),
    ) as cluster:
        cfg_path = Path(cluster.tmpdir.name) / "network.json"
        gws = []
        try:
            for gi in range(gateways):
                gws.append(
                    start_gateway(
                        cfg_path,
                        Path(cluster.tmpdir.name) / f"gateway-{gi}.log",
                    )
                )
            quorum = cluster.config.f + 1
            tentative_quorum = (
                2 * cluster.config.f + 1 if mode == "mac" else 0
            )
            ports = [gport for _, gport in gws]
            # One warmup request per gateway (so every tier process has
            # live upstream links) before the timed region.
            asyncio.run(
                run_load("127.0.0.1", ports, len(ports), 1, 1, quorum,
                         120.0, token_prefix="warm",
                         tentative_quorum=tentative_quorum)
            )
            t0 = time.perf_counter()
            done, elapsed, lat = asyncio.run(
                run_load(
                    "127.0.0.1", ports, clients, requests_each, window,
                    quorum, deadline_s,
                    tentative_quorum=tentative_quorum,
                )
            )
            elapsed = time.perf_counter() - t0
        finally:
            for proc, _ in gws:
                proc.terminate()
            for proc, _ in gws:
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
        # Cluster-wide counters from each replica's metrics lines.
        time.sleep(1.2)  # one more metrics tick
        accounting = verify_accounting(cluster, verifier, before) if service else None
        rounds_max = 0
        executed_total = 0
        rounds_total = 0
        for i in range(n):
            log = (Path(cluster.tmpdir.name) / f"replica-{i}.log").read_text(
                errors="ignore"
            )
            rounds = re.findall(r'"rounds_executed":\s*(\d+)', log)
            execd = re.findall(r'"executed":\s*(\d+)', log)
            if rounds:
                rounds_total += int(rounds[-1])
                rounds_max = max(rounds_max, int(rounds[-1]))
            if execd:
                executed_total += int(execd[-1])
    total = done
    # The thread count, the mode and the WAL arm ride in the config field,
    # so that bench_compare --group-by config gates each arm on its own:
    # net-threads 1, sig mode and WAL "on" keep the plain key.
    config_key = f"scale f={(n - 1) // 3}"
    if net_threads > 1:
        config_key += f" t{net_threads}"
    if mode != "sig":
        config_key += f" {mode}"
    if wal == "nofsync":
        config_key += " wal-nofsync"
    row = {
        "config": config_key,
        "mode": mode,
        "wal": wal,
        "replicas": n,
        "f": (n - 1) // 3,
        "clients": clients,
        "requests": total,
        "seconds": round(elapsed, 3),
        "rounds_per_sec": round((rounds_max or total) / elapsed, 1),
        "requests_per_sec": round(total / elapsed, 1),
        "reply_p50_ms": round(_pct(lat, 0.5), 3),
        "reply_p99_ms": round(_pct(lat, 0.99), 3),
        "mean_batch": (
            round(executed_total / rounds_total, 2) if rounds_total else 1.0
        ),
        "batch_max_items": batch,
        "batch_flush_us": batch_flush_us,
        "window": window,
        "net_threads": net_threads,
        "gateways": len(gws),
        "verifier": f"gateway-{impl}",
        "completed_pct": round(
            100.0 * total / max(1, clients * requests_each), 1
        ),
    }
    if accounting is not None:
        row["verify_accounting"] = accounting
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "--n", default="4,7,16,31",
        help="comma-separated cluster sizes (default the BASELINE curve)",
    )
    parser.add_argument("--clients", type=int, default=8,
                        help="concurrent client identities (default 8)")
    parser.add_argument("--requests", type=int, default=50,
                        help="requests per identity (default 50)")
    parser.add_argument("--window", type=int, default=8,
                        help="pipelined requests in flight per identity")
    parser.add_argument("--batch", type=int, default=256,
                        help="batch_max_items (BASELINE's 256-req windows)")
    parser.add_argument("--batch-flush-us", type=int, default=2000)
    parser.add_argument("--impl", default="cxx", choices=("cxx", "py"),
                        help="replica runtime (default the C++ daemon)")
    parser.add_argument("--gateways", type=int, default=1)
    parser.add_argument(
        "--net-threads", type=int, default=1,
        help="pbftd event-loop shard threads per replica; rides into the "
        "JSONL config field so bench_compare --group-by config gates the "
        "per-core curve",
    )
    parser.add_argument(
        "--mode", default="sig",
        help="comma-separated fast-path modes per point: sig (the "
        "signature path) and/or mac (MAC-vector authenticators + "
        "tentative execution; the load generator counts the 2f+1 tentative reply "
        "quorum). Rides into the JSONL config field for bench_compare "
        "--group-by.",
    )
    parser.add_argument(
        "--wal", default="off", choices=("off", "on", "nofsync"),
        help="durability arm: on = write-ahead log with group-commit "
        "fsync; nofsync = WAL writes without fsync (own config group: "
        "the explicit fsync cost)",
    )
    parser.add_argument("--deadline-s", type=float, default=600.0,
                        help="hard per-point wall-clock bound")
    parser.add_argument("--out", default=None, help="append JSONL here")
    add_verifier_args(parser)
    args = parser.parse_args(argv)

    ns = [int(x) for x in args.n.split(",") if x.strip()]
    modes = [m.strip() for m in args.mode.split(",") if m.strip()]
    try:
        verifier, daemon = open_verifier(args)
    except (RuntimeError, TimeoutError) as e:
        print(f"scale_curve: the verify daemon did not warm: {e}", file=sys.stderr)
        return 2
    rows = []
    try:
        for n in ns:
            for mode in modes:
                row = run_point(
                    n, args.clients, args.requests, args.window, args.batch,
                    args.batch_flush_us, args.impl, args.gateways,
                    args.deadline_s, net_threads=args.net_threads, mode=mode,
                    wal=args.wal, verifier=verifier,
                )
                print(json.dumps(row), flush=True)
                rows.append(row)
    finally:
        if daemon is not None:
            daemon.stop()
    if args.out:
        with open(args.out, "a") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
    # Nonzero when any point failed to complete its driven load.
    return 0 if all(r["completed_pct"] >= 99.0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
