"""chaos_bench — perf-under-faults on REAL clusters: the port's copy of the
reference's ``scripts/chaos_bench.py``, on the port's ``LocalCluster``,
gateway and asyncio replicas.

A sustained gateway firehose against a live LocalCluster while a seeded
fault schedule executes — crash-a-backup (then heal), a stuttering/mute
primary forcing view changes, 5% link drop, and a gateway kill mid-run
(clients fail over to the surviving gateway under the same ``gw/``
tokens). Each arm emits one bench_compare-compatible JSONL row:
throughput + reply percentiles (degradation vs the fault-free arm),
the view-change latency distribution (joined from the
``view_timer_fired``/``new_view_installed`` spans across every replica
trace), recovery-after-heal time for the crash arm, and the
admission/failover counters.

Where the signatures are verified (``--verifier``; the reference always
runs each replica's host pool): ``daemon`` (the default) starts the
port's verify daemon, warmed on the card (``--service-backend cuda``; a
failed warm ends the run with exit 2, nothing falls back to the host),
and dials every replica to it; ``cuda`` verifies on the card in each
asyncio replica's process; ``cpu`` is each replica's host verify pool;
``HOST:PORT`` a running verify service. On a service, each row carries
``verify_accounting``: the service's items against the replicas'
signature checks.

    # the acceptance arms on the card (the daemon), asyncio replicas:
    python -m pbft_tpu_torch.scripts.chaos_bench --health-gate \
        --arms fault-free,crash-backup,stutter-primary --out x.jsonl

    # one arm, smaller load, host pools, black boxes on failure:
    python -m pbft_tpu_torch.scripts.chaos_bench --verifier cpu \
        --arms crash-backup --clients 4 --requests 20 --blackbox-dir bbx

Exit status is nonzero when any arm misses its completion bar (100% for
fault-free/crash-backup/gateway-kill; 97% for the lossy arms) — and a
failing arm ships every replica's and gateway's black-box flight dump to
``--blackbox-dir`` (decode with ``pbft_tpu_torch.scripts.flight_dump``).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

from ..analysis import health
from ..consensus.messages import ClientRequest
from ..net.gateway import GATEWAY_CLIENT_PREFIX
from ..net.launcher import LocalCluster

REPO = Path(__file__).resolve().parents[2]

ARMS = (
    "fault-free",
    "crash-backup",
    "stutter-primary",
    "link-drop",
    "gateway-kill",
    # Durable recovery: SIGKILL a backup mid-firehose (no
    # signal handler runs — only what group commit made durable
    # survives), then restart it with --wal-dir: it must replay the log,
    # re-join the SAME view without contradicting a persisted vote, and
    # catch the suffix up via state transfer. The arm reports
    # recovery_after_restart_s and pins recovered_from_wal.
    "kill9-restart",
)

# Completion bar per arm: the crash/HA arms must stay lossless (that is
# the acceptance criterion); the lossy-link and view-change arms tolerate
# a small tail the deadline may cut.
COMPLETION_BAR = {
    "fault-free": 100.0,
    "crash-backup": 100.0,
    "gateway-kill": 100.0,
    "kill9-restart": 100.0,
    "stutter-primary": 97.0,
    "link-drop": 97.0,
}


def start_gateway(cfg_path, log_path, flight_file=None, extra=()):
    """Spawn one gateway process; returns (Popen, port)."""
    import os

    log = open(log_path, "wb")
    cmd = [sys.executable, "-m", "pbft_tpu_torch.net.gateway", "--config",
           str(cfg_path), "--port", "0", *extra]
    if flight_file:
        cmd += ["--flight-file", str(flight_file)]
    proc = subprocess.Popen(
        cmd, stdout=log, stderr=log, close_fds=True,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    deadline = time.monotonic() + 20
    while True:
        text = log_path.read_text(errors="replace") if log_path.exists() else ""
        m = re.search(r"gateway listening on (\d+)", text)
        if m:
            return proc, int(m.group(1))
        if proc.poll() is not None or time.monotonic() > deadline:
            raise TimeoutError(f"gateway never listened:\n{text}")
        time.sleep(0.05)


async def drive_identity(
    host: str,
    ports: list,
    port_ix: int,
    token: str,
    n_requests: int,
    window: int,
    quorum: int,
    retransmit_s: float,
    deadline_s: float,
    latencies_ms: list,
    stats: dict,
    tentative_quorum: int = 0,
) -> int:
    """One client identity with GATEWAY FAILOVER: pipeline ``window``
    requests, count completion at ``quorum`` distinct-replica matching
    replies, retransmit overdue requests — and on a dead gateway socket
    reconnect to the next port in ``ports`` under the SAME token,
    resending every pending line (the GatewayClient HA contract, driven
    at the raw protocol level). Explicit ``overloaded`` lines back the
    identity off with jitter instead of retransmitting harder."""
    import random

    rng = random.Random(hash(token) & 0xFFFFFFFF)
    reader = writer = None

    async def connect():
        nonlocal reader, writer, port_ix
        last = None
        for i in range(len(ports)):
            ix = (port_ix + i) % len(ports)
            try:
                reader, writer = await asyncio.open_connection(
                    host, ports[ix]
                )
                port_ix = ix
                return True
            except OSError as e:
                last = e
        del last
        return False

    if not await connect():
        return 0
    pending: dict = {}  # ts -> state
    done = 0
    submitted = 0
    ts_counter = 0  # may run past n_requests: gap-skip reissues (below)
    max_done_ts = 0
    buf = b""
    hard_deadline = time.monotonic() + deadline_s

    async def failover():
        nonlocal buf, port_ix
        try:
            writer.close()
        except OSError:
            pass
        buf = b""
        port_ix += 1  # start from the NEXT gateway
        if not await connect():
            await asyncio.sleep(0.5)
            if not await connect():
                return False
        stats["failovers"] = stats.get("failovers", 0) + 1
        now = time.monotonic()
        for st in pending.values():  # replay in-flight under the same token
            writer.write(st["line"])
            st["retry"] = now + retransmit_s
        return True

    try:
        while done < n_requests:
            now = time.monotonic()
            if now > hard_deadline:
                break
            while submitted < n_requests and len(pending) < window:
                submitted += 1
                ts_counter += 1
                req = ClientRequest(
                    operation=f"{token}#{submitted}",
                    timestamp=ts_counter,
                    client=token,
                )
                line = req.canonical() + b"\n"
                writer.write(line)
                pending[ts_counter] = {
                    "op": req.operation,
                    "line": line,
                    "send": now,
                    "retry": now + retransmit_s,
                    "votes": {},
                }
            try:
                await writer.drain()
                chunk = await asyncio.wait_for(reader.read(65536), timeout=0.5)
            except asyncio.TimeoutError:
                chunk = None
            except (ConnectionError, OSError):
                chunk = b""
            if chunk == b"":
                if not await failover():
                    break  # every gateway down
                continue
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
                    st = pending.get(ts)
                    if st is None:
                        continue
                    if obj.get("type") == "overloaded":
                        # Admission rejection: back off with jitter, no
                        # harder retransmission.
                        stats["overloaded"] = stats.get("overloaded", 0) + 1
                        st["retry"] = time.monotonic() + retransmit_s * (
                            0.5 + rng.random()
                        )
                        continue
                    rid = obj.get("replica")
                    if not isinstance(rid, int):
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
                            committed[result] = (
                                committed.get(result, 0) + 1
                            )
                    ok = (
                        committed and max(committed.values()) >= quorum
                    ) or (
                        tentative_quorum > 0
                        and max(by_result.values()) >= tentative_quorum
                    )
                    if ok:
                        latencies_ms.append(
                            (time.monotonic() - st["send"]) * 1e3
                        )
                        del pending[ts]
                        done += 1
                        max_done_ts = max(max_done_ts, ts)
            now = time.monotonic()
            for ts in list(pending):
                st = pending[ts]
                if now <= st["retry"]:
                    continue
                if ts < max_done_ts:
                    # Gap-skipped during a failover: per-client execution
                    # is timestamp-ordered, so a LATER ts completing
                    # while this one has no quorum means this ts can
                    # never execute (the dead gateway absorbed it after
                    # a successor was already forwarded). Reissue the
                    # operation under a FRESH timestamp — the lossless
                    # completion guarantee the gateway-kill arm proves.
                    ts_counter += 1
                    req = ClientRequest(
                        operation=st["op"],
                        timestamp=ts_counter,
                        client=token,
                    )
                    line = req.canonical() + b"\n"
                    del pending[ts]
                    pending[ts_counter] = {
                        "op": st["op"],
                        "line": line,
                        "send": st["send"],
                        "retry": now + retransmit_s,
                        "votes": {},
                    }
                    stats["reissued"] = stats.get("reissued", 0) + 1
                    writer.write(line)
                    continue
                writer.write(st["line"])
                st["retry"] = now + retransmit_s
    finally:
        if writer is not None:
            writer.close()
    return done


async def run_load(
    host, ports, clients, requests_each, window, quorum, deadline_s,
    tentative_quorum=0,
    token_prefix="cb", stats=None,
):
    latencies_ms: list = []
    stats = stats if stats is not None else {}
    tasks = [
        drive_identity(
            host, ports, i % len(ports),
            f"{GATEWAY_CLIENT_PREFIX}{token_prefix}-{i}", requests_each,
            window, quorum, retransmit_s=3.0, deadline_s=deadline_s,
            tentative_quorum=tentative_quorum,
            latencies_ms=latencies_ms, stats=stats,
        )
        for i in range(clients)
    ]
    t0 = time.perf_counter()
    done = await asyncio.gather(*tasks)
    return sum(done), time.perf_counter() - t0, sorted(latencies_ms), stats


def _pct(vals, q):
    return vals[min(len(vals) - 1, int(q * len(vals)))] if vals else 0.0


def view_change_latencies_ms(events) -> list:
    """Cross-replica view-change convergence spans: merge every replica's
    ``view_timer_fired``/``new_view_installed`` events by timestamp; the
    FIRST timer fire opens a span, the first install closes it. The
    result is how long the cluster was between suspecting a primary and
    running under the next one — the view-change storm metric."""
    evs = sorted(
        (
            e
            for e in events
            if e.get("ev") in ("view_timer_fired", "new_view_installed")
            and isinstance(e.get("ts"), (int, float))
        ),
        key=lambda e: e["ts"],
    )
    out = []
    open_since = None
    for e in evs:
        if e["ev"] == "view_timer_fired":
            if open_since is None:
                open_since = e["ts"]
        elif open_since is not None:
            out.append((e["ts"] - open_since) * 1000.0)
            open_since = None
    return out


def load_trace_events(trace_dir: Path) -> list:
    events = []
    for p in sorted(trace_dir.glob("replica-*.jsonl")):
        for line in p.read_text(errors="replace").splitlines():
            try:
                events.append(json.loads(line))
            except ValueError:
                continue
    return events


def _last_metric(cluster, rid: int, key: str):
    path = Path(cluster.tmpdir.name) / f"replica-{rid}.log"
    if not path.exists():
        return None
    hits = re.findall(
        rf'"{key}":\s*(-?\d+)', path.read_text(errors="replace")
    )
    return int(hits[-1]) if hits else None


def _sum_metric(cluster, n: int, key: str) -> int:
    total = 0
    for rid in range(n):
        v = _last_metric(cluster, rid, key)
        if v is not None:
            total += v
    return total


class FaultSchedule(threading.Thread):
    """Executes one arm's fault schedule on wall-clock offsets while the
    load runs: kill/revive a backup (measuring recovery-after-heal), or
    kill a gateway. Runs as a daemon thread; ``result`` carries what it
    measured."""

    def __init__(self, cluster, arm, fault_at_s, heal_at_s, gw_procs):
        super().__init__(daemon=True)
        self.cluster = cluster
        self.arm = arm
        self.fault_at_s = fault_at_s
        self.heal_at_s = heal_at_s
        self.gw_procs = gw_procs
        self.result: dict = {}

    def run(self) -> None:
        n = self.cluster.config.n
        victim = n - 1  # a BACKUP in view 0 (primary is 0)
        time.sleep(self.fault_at_s)
        if self.arm == "kill9-restart":
            # Durable recovery: SIGKILL — no handler, no
            # flight dump, nothing beyond what group commit already made
            # durable — then restart FROM DISK. Catch-up is proven the
            # same way as crash-backup, plus the recovered_from_wal pin.
            self.cluster.kill(victim, hard=True)
            self.result["killed_replica"] = victim
            time.sleep(max(0.0, self.heal_at_s - self.fault_at_s))
            log = Path(self.cluster.tmpdir.name) / f"replica-{victim}.log"
            pre_lines = len(
                re.findall(
                    r'"executed_upto"', log.read_text(errors="replace")
                )
            )
            t_heal = time.monotonic()
            self.cluster.revive(victim, from_disk=True)
            interval = self.cluster.config.checkpoint_interval
            deadline = t_heal + 60.0
            while time.monotonic() < deadline:
                text = log.read_text(errors="replace")
                hits = re.findall(r'"executed_upto":\s*(-?\d+)', text)
                mine = int(hits[-1]) if len(hits) > pre_lines else None
                best = max(
                    (
                        _last_metric(self.cluster, r, "executed_upto") or 0
                        for r in range(n)
                        if r != victim
                    ),
                    default=0,
                )
                if mine is not None and mine >= best - interval:
                    self.result["recovery_after_restart_s"] = round(
                        time.monotonic() - t_heal, 3
                    )
                    self.result["recovered_from_wal"] = (
                        '"recovered_from_wal":true' in text
                    )
                    return
                time.sleep(0.25)
            # Never converged within the deadline. NOTE the restart must
            # land while the firehose still runs: catch-up past the
            # recovered checkpoint floor rides peer checkpoints -> state
            # transfer, and an idle cluster produces neither (the victim
            # stays consistently AT its floor until traffic resumes —
            # schedule heal_at_s inside the load window).
            self.result["recovery_after_restart_s"] = -1.0
            self.result["recovered_from_wal"] = (
                '"recovered_from_wal":true'
                in log.read_text(errors="replace")
            )
        elif self.arm == "crash-backup":
            self.cluster.kill(victim)
            self.result["killed_replica"] = victim
            time.sleep(max(0.0, self.heal_at_s - self.fault_at_s))
            # Lines already in the victim's log belong to the DEAD
            # process: recovery is only proven by a metrics line the
            # revived one printed.
            log = Path(self.cluster.tmpdir.name) / f"replica-{victim}.log"
            pre_lines = len(
                re.findall(
                    r'"executed_upto"', log.read_text(errors="replace")
                )
            )
            t_heal = time.monotonic()
            self.cluster.revive(victim)
            # Recovery-after-heal: the revived replica restarts with
            # FRESH state and must catch up via checkpoint/state
            # transfer — recovered when its executed_upto is within one
            # checkpoint interval of the cluster max.
            interval = self.cluster.config.checkpoint_interval
            deadline = t_heal + 60.0
            while time.monotonic() < deadline:
                text = log.read_text(errors="replace")
                hits = re.findall(r'"executed_upto":\s*(-?\d+)', text)
                mine = int(hits[-1]) if len(hits) > pre_lines else None
                best = max(
                    (
                        _last_metric(self.cluster, r, "executed_upto") or 0
                        for r in range(n)
                        if r != victim
                    ),
                    default=0,
                )
                if mine is not None and mine >= best - interval:
                    self.result["recovery_after_heal_s"] = round(
                        time.monotonic() - t_heal, 3
                    )
                    return
                time.sleep(0.25)
            self.result["recovery_after_heal_s"] = -1.0  # never caught up
        elif self.arm == "gateway-kill":
            proc, port = self.gw_procs[0]
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
            self.result["killed_gateway_port"] = port


class HealthSampler(threading.Thread):
    """Polls every replica's /status health document into a
    detector-ready history while the arm runs. Launch-faulted
    replicas are excluded up front: a deliberately muted primary seals
    work it can never execute and would false-trip the silent-stall
    detector on an arm that is SUPPOSED to survive it. Dead replicas
    simply stop answering — the detectors treat absence as no-data."""

    def __init__(self, cluster, skip=(), interval_s=1.0):
        super().__init__(daemon=True)
        self.cluster = cluster
        self.skip = set(skip)
        self.interval_s = interval_s
        self.history: list = []
        self._stop_evt = threading.Event()

    def run(self) -> None:
        import urllib.request

        t0 = time.monotonic()
        while not self._stop_evt.wait(self.interval_s):
            snap = {"t": time.monotonic() - t0, "replicas": {}}
            for i, port in enumerate(self.cluster.metrics_ports):
                if i in self.skip:
                    continue
                try:
                    with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/status", timeout=1
                    ) as resp:
                        snap["replicas"][i] = json.loads(
                            resp.read().decode()
                        )
                except (OSError, ValueError):
                    pass
            self.history.append(snap)

    def stop(self) -> None:
        self._stop_evt.set()


def _process_lines(cluster, rid: int) -> list:
    """The metrics lines of each process replica ``rid`` ran, in order:
    a revived process appends to the dead one's log, and its
    ``uptime_seconds`` starts again from 0."""
    path = Path(cluster.tmpdir.name) / f"replica-{rid}.log"
    lives: list = []
    last_up = None
    for line in path.read_text(errors="replace").splitlines():
        if not line.startswith("{"):
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        up = doc.get("uptime_seconds")
        if not isinstance(up, (int, float)):
            continue
        if last_up is None or up < last_up:
            lives.append([])
        lives[-1].append(doc)
        last_up = up
    return lives


def _accounting_once(lives_by_replica: list, after: dict, before: dict) -> dict:
    checks = fallbacks = 0
    lost_max = 0
    per_replica = []
    for lives in lives_by_replica:
        mine = 0
        for ix, life in enumerate(lives):
            vals = [d.get("sig_verified", 0) + d.get("sig_rejected", 0) for d in life]
            mine += vals[-1]
            fallbacks += life[-1].get("verify_service_fallbacks", 0)
            steps = [b - a for a, b in zip(vals, vals[1:])]
            lost_max = max([lost_max] + steps)
        per_replica.append(mine)
        checks += mine

    def delta(key):
        return after.get(key, 0) - before.get(key, 0)

    out = {
        "service_items": delta("items"),
        "service_windows": delta("launches"),
        "service_rejected": delta("rejected"),
        "service_fallback_items": delta("fallback_items"),
        "service_devices": after.get("devices", 0),
        "replica_sig_checks": checks,
        "replica_checks": per_replica,
        "replica_service_fallbacks": fallbacks,
        "unaccounted_items": delta("items") - checks,
        "lost_max_items": lost_max,
    }
    if "kernel_launches" in after:
        out["kernel_launches"] = {
            k: v - before.get("kernel_launches", {}).get(k, 0)
            for k, v in after["kernel_launches"].items()
        }
    return out


def verify_accounting(cluster, address: str, before: dict,
                      tries: int = 10, read=None) -> dict:
    """Where the arm's signatures were verified, on a verify service: its
    items, windows, fallback items and kernel launches since ``before``
    (its JSON status when the cluster started) against the replicas'
    signature checks (``sig_verified + sig_rejected``, summed over every
    process each replica ran, each at its last metrics line) and the
    batches their ``ServiceVerifier`` sent to a host fallback. Read once
    two reads a metrics tick apart agree (a replica behind the reply
    quorum may still be verifying its last round). ``read`` returns the
    replicas' documents as a list (per replica) of lives (each a list of
    documents); by default each replica's log (``_process_lines``). A
    replica killed mid-run counts its checks up to its last metrics line,
    so ``unaccounted_items`` (service items minus checks) may be above 0
    only on an arm that crashes one, by at most what a replica checks in
    one metrics interval: ``lost_max_items``, the largest growth of any
    replica's checks between two of its consecutive metrics lines."""
    from ..net.verify_service import probe_status_json

    if read is None:
        def read():
            return [_process_lines(cluster, rid) for rid in range(cluster.config.n)]
    last = None
    for _ in range(tries):
        after = probe_status_json(address)
        if after is None:
            raise RuntimeError(f"the verify service at {address} does not answer")
        now = _accounting_once(read(), after, before)
        if now == last:
            break
        last = now
        time.sleep(1.1)  # one metrics tick
    return now


def run_arm_traced(
    arm, n, clients, requests_each, window, batch, batch_flush_us, impl,
    gateways, vc_timeout_ms, admission_inflight, admission_backlog,
    fault_at_s, heal_at_s, deadline_s, seed, blackbox_dir, mode="sig",
    health_gate=False, verifier="cpu", keep_dir=None,
) -> dict:
    """One arm; ``verifier`` goes to every replica (``cpu``, ``cuda``, or
    a verify service's address, whose accounting joins the row). With
    ``keep_dir``, the arm's traces and flight dumps are copied to
    ``<keep_dir>/<arm>-seed<seed>/{traces,flight}``."""
    import tempfile

    from ..net.verify_service import probe_status_json

    if arm not in ARMS:
        raise SystemExit(f"chaos_bench: unknown arm {arm!r} (know {ARMS})")
    n_gw = max(gateways, 2) if arm == "gateway-kill" else gateways
    faults = {0: "mute"} if arm == "stutter-primary" else None
    drop = 0.05 if arm == "link-drop" else 0.0
    aux = tempfile.TemporaryDirectory(prefix="chaosbench-")
    trace_dir = Path(aux.name) / "traces"
    flight_dir = Path(aux.name) / "flight"
    trace_dir.mkdir()
    flight_dir.mkdir()
    # The mode rides in the config field: sig arms keep the
    # historic keys so bench_compare gates them against earlier runs;
    # mac arms (authenticator + tentative execution) are their own
    # groups on the faulted-path A/B.
    base_key = (
        f"chaos {arm}" if arm != "fault-free" else f"scale f={(n - 1) // 3}"
    )
    row = {
        "config": base_key if mode == "sig" else f"{base_key} {mode}",
        "arm": arm,
        "mode": mode,
        "replicas": n,
        "f": (n - 1) // 3,
        "clients": clients,
        "seed": seed,
    }
    on_service = verifier not in ("cpu", "cuda")
    try:
        status0 = probe_status_json(verifier) if on_service else None
        if on_service and status0 is None:
            raise RuntimeError(f"the verify service at {verifier} does not answer")
        with LocalCluster(
            n=n,
            verifier=verifier,
            metrics_every=1,
            impl=impl,
            vc_timeout_ms=vc_timeout_ms,
            batch_max_items=batch,
            batch_flush_us=batch_flush_us,
            admission_inflight=admission_inflight,
            admission_backlog=admission_backlog,
            fastpath=mode,
            tentative=(mode == "mac"),
            # The kill9 arm needs the durability layer live on every
            # replica: the victim restarts from its WAL.
            wal=(arm == "kill9-restart"),
            faults=faults,
            chaos_drop_pct=drop,
            chaos_seed=seed if drop > 0 else None,
            trace_dir=str(trace_dir),
            flight_dir=str(flight_dir),
            metrics_ports=health_gate,
        ) as cluster:
            cfg_path = Path(cluster.tmpdir.name) / "network.json"
            gws = []
            sched = None
            sampler = None
            health_verdicts: list = []
            try:
                for gi in range(n_gw):
                    gws.append(
                        start_gateway(
                            cfg_path,
                            Path(cluster.tmpdir.name) / f"gateway-{gi}.log",
                            flight_file=flight_dir / f"gateway-{gi}.flight",
                        )
                    )
                quorum = cluster.config.f + 1
                tentative_quorum = (
                    2 * cluster.config.f + 1 if mode == "mac" else 0
                )
                ports = [p for _, p in gws]
                # Warmup (outside the timed region): every tier process
                # gets live upstream links. Under a mute primary the
                # warmup itself crosses the first view change.
                asyncio.run(
                    run_load(
                        "127.0.0.1", ports, len(ports), 1, 1, quorum,
                        120.0, token_prefix=f"warm{seed}",
                        tentative_quorum=tentative_quorum,
                    )
                )
                if health_gate:
                    sampler = HealthSampler(
                        cluster, skip=set(faults or {}))
                    sampler.start()
                sched = FaultSchedule(cluster, arm, fault_at_s, heal_at_s, gws)
                sched.start()
                stats: dict = {}
                t0 = time.perf_counter()
                done, elapsed, lat, stats = asyncio.run(
                    run_load(
                        "127.0.0.1", ports, clients, requests_each, window,
                        quorum, deadline_s, token_prefix=f"cb{seed}",
                        tentative_quorum=tentative_quorum,
                        stats=stats,
                    )
                )
                elapsed = time.perf_counter() - t0
                sched.join(timeout=90.0)
                # Scrape counters BEFORE the gateway teardown: a replica
                # counts every live gateway link that dies as a failover,
                # and the teardown itself would otherwise pollute the
                # arm's gateway_failovers with shutdown noise.
                time.sleep(1.2)  # one more metrics tick
                counters = {
                    k: _sum_metric(cluster, n, k)
                    for k in (
                        "view_changes_started",
                        "overload_rejections",
                        "gateway_failovers",
                    )
                }
                if on_service:
                    row["verify_accounting"] = verify_accounting(
                        cluster, verifier, status0)
                if sampler is not None:
                    sampler.stop()
                    sampler.join(timeout=10)
                    health_verdicts = health.run_detectors(sampler.history)
            finally:
                if sampler is not None:
                    sampler.stop()
                for proc, _ in gws:
                    if proc.poll() is None:
                        proc.terminate()
                for proc, _ in gws:
                    try:
                        proc.wait(timeout=5)
                    except subprocess.TimeoutExpired:
                        proc.kill()
            time.sleep(1.2)  # one more metrics tick
            rounds_max = 0
            executed_total = 0
            rounds_total = 0
            for i in range(n):
                r = _last_metric(cluster, i, "rounds_executed")
                e = _last_metric(cluster, i, "executed")
                if r is not None:
                    rounds_total += r
                    rounds_max = max(rounds_max, r)
                if e is not None:
                    executed_total += e
            row.update(
                {
                    "requests": done,
                    "seconds": round(elapsed, 3),
                    "rounds_per_sec": round(
                        (rounds_max or done) / elapsed, 1
                    ),
                    "requests_per_sec": round(done / elapsed, 1),
                    "reply_p50_ms": round(_pct(lat, 0.5), 3),
                    "reply_p99_ms": round(_pct(lat, 0.99), 3),
                    "mean_batch": (
                        round(executed_total / rounds_total, 2)
                        if rounds_total
                        else 1.0
                    ),
                    "batch_max_items": batch,
                    "batch_flush_us": batch_flush_us,
                    "window": window,
                    "gateways": n_gw,
                    "verifier": f"gateway-{impl}",
                    "verify_on": verifier if not on_service else "service",
                    "completed_pct": round(
                        100.0 * done / max(1, clients * requests_each), 1
                    ),
                    # Perf-under-faults surface.
                    "view_changes_started": counters["view_changes_started"],
                    "overload_rejections": counters["overload_rejections"],
                    "gateway_failovers": counters["gateway_failovers"],
                    "client_failovers": stats.get("failovers", 0),
                    "client_overloaded": stats.get("overloaded", 0),
                    "client_reissued": stats.get("reissued", 0),
                }
            )
            if sched is not None:
                row.update(sched.result)
            vc_lat = sorted(
                view_change_latencies_ms(load_trace_events(trace_dir))
            )
            row["vc_latency_ms"] = {
                "count": len(vc_lat),
                "p50": round(_pct(vc_lat, 0.5), 1),
                "p95": round(_pct(vc_lat, 0.95), 1),
                "max": round(max(vc_lat), 1) if vc_lat else 0.0,
            }
        # Cluster context exits here: daemons get SIGTERM and dump their
        # black boxes into flight_dir (the tmpdir cleanup would race it,
        # so flight_dir lives in OUR aux dir, not the cluster's).
        ok = row["completed_pct"] >= COMPLETION_BAR[arm]
        if health_gate:
            row["health_verdicts"] = health_verdicts
            row["health_snapshots"] = (
                len(sampler.history) if sampler is not None else 0
            )
            ok = ok and not health_verdicts
        row["ok"] = ok
        if keep_dir:
            dest = Path(keep_dir) / f"{arm}-seed{seed}"
            shutil.copytree(trace_dir, dest / "traces", dirs_exist_ok=True)
            shutil.copytree(flight_dir, dest / "flight", dirs_exist_ok=True)
            row["kept"] = str(dest)
        if not ok and blackbox_dir:
            dest = Path(blackbox_dir) / f"{arm}-seed{seed}"
            dest.mkdir(parents=True, exist_ok=True)
            for p in flight_dir.glob("*.flight"):
                shutil.copy(p, dest / p.name)
            row["blackboxes"] = str(dest)
            print(
                f"chaos_bench: {arm} FAILED its completion bar; black "
                f"boxes -> {dest} (decode with "
                "python -m pbft_tpu_torch.scripts.flight_dump)",
                file=sys.stderr,
            )
    finally:
        aux.cleanup()
    return row


def add_verifier_args(parser) -> None:
    """``--verifier`` and ``--service-backend`` (this script and
    endurance_soak)."""
    parser.add_argument(
        "--verifier", default="daemon",
        help="daemon (default: the port's verify daemon, warmed on the "
        "card, every replica dialled to it), cuda (the card in each "
        "asyncio replica's process), cpu (each replica's host verify "
        "pool), or a verify service's HOST:PORT")
    parser.add_argument(
        "--service-backend", default="cuda", choices=("cuda", "native"),
        help="--verifier daemon: the daemon's backend (native = the C++ "
        "verify pool, no card)")


def open_verifier(args):
    """(the address or name every replica gets, the daemon to stop or
    None). ``daemon`` starts and warms one with bench.harness
    start_daemon: a failed warm raises, and no host fallback carries the
    run."""
    if args.verifier != "daemon":
        return args.verifier, None
    from ..bench.harness import start_daemon

    daemon = start_daemon(args.service_backend)
    return daemon.address, daemon


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "--arms",
        default="fault-free,crash-backup,stutter-primary,gateway-kill",
        help=f"comma-separated from {ARMS} (default the acceptance four; "
        "add link-drop for the 5%% loss arm)",
    )
    parser.add_argument("--n", type=int, default=4)
    parser.add_argument("--clients", type=int, default=8)
    parser.add_argument("--requests", type=int, default=120,
                        help="requests per identity (default: 8 x 120 = 960)")
    parser.add_argument("--window", type=int, default=8)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--batch-flush-us", type=int, default=2000)
    parser.add_argument("--impl", default="py", choices=("cxx", "py"),
                        help="py = the port's asyncio replicas (default), "
                        "cxx = pbftd (no --verifier cuda)")
    parser.add_argument("--gateways", type=int, default=1,
                        help="gateway tier width (gateway-kill raises to "
                        ">= 2 so a survivor exists)")
    parser.add_argument("--vc-timeout-ms", type=int, default=600)
    parser.add_argument("--admission-inflight", type=int, default=0,
                        help="per-client in-flight cap at the replicas "
                        "(network.json admission_inflight; 0 = off)")
    parser.add_argument("--admission-backlog", type=int, default=0)
    parser.add_argument("--fault-at-s", type=float, default=2.0,
                        help="schedule offset: when the arm's fault fires")
    parser.add_argument("--heal-at-s", type=float, default=6.0,
                        help="schedule offset: when the crash arm heals")
    parser.add_argument("--deadline-s", type=float, default=300.0)
    parser.add_argument("--seed", type=int, default=12,
                        help="chaos seed: link-drop pattern + load tokens")
    parser.add_argument("--blackbox-dir", default=None,
                        help="failing arms copy every flight dump here")
    parser.add_argument("--keep-dir", default=None,
                        help="every arm copies its traces and flight dumps "
                        "to <dir>/<arm>-seed<seed>/ (for trace_report, "
                        "consensus_timeline and flight_dump)")
    parser.add_argument(
        "--mode", default="sig",
        help="comma-separated fast-path modes per arm: sig "
        "and/or mac (MAC-vector authenticators + tentative execution; "
        "the load counts the 2f+1 tentative reply quorum)")
    parser.add_argument(
        "--health-gate", action="store_true",
        help="sample every replica's /status health document "
        "~1/s during the arm and fail it if the detector library "
        "(silent stall, leak, divergence, stuck view change, queue "
        "saturation) trips — verdicts land in the JSONL row")
    parser.add_argument("--out", default=None, help="append JSONL here")
    add_verifier_args(parser)
    args = parser.parse_args(argv)

    arms = [a.strip() for a in args.arms.split(",") if a.strip()]
    modes = [m.strip() for m in args.mode.split(",") if m.strip()]
    try:
        verifier, daemon = open_verifier(args)
    except (RuntimeError, TimeoutError) as e:
        print(f"chaos_bench: the verify daemon did not warm: {e}", file=sys.stderr)
        return 2
    rows = []
    try:
        for arm in arms:
            for mode in modes:
                row = run_arm_traced(
                    arm, args.n, args.clients, args.requests, args.window,
                    args.batch, args.batch_flush_us, args.impl, args.gateways,
                    args.vc_timeout_ms, args.admission_inflight,
                    args.admission_backlog, args.fault_at_s, args.heal_at_s,
                    args.deadline_s, args.seed, args.blackbox_dir, mode=mode,
                    health_gate=args.health_gate, verifier=verifier,
                    keep_dir=args.keep_dir,
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
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
