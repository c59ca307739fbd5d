"""Protocol throughput harness: BASELINE's configurations 0-4 in the
in-memory simulation and as real ``pbftd`` clusters over loopback TCP (the
port's counterpart of ``pbft_tpu/bench/harness.py``).

Simulation arms (``consensus.simulation.Cluster``: the Python replica cores
in lockstep over an in-memory transport, one request in flight per client;
each replica's pending signatures verified once per step):
- ``cpu``:         the native C++ batch verifier (``native.verify_batch``;
                   built first, before the timed region).
- ``cuda``:        the card: each step's items in windows of ``batch_pad``
                   rows (``crypto.batch.verify_many``), each a replayed CUDA
                   graph. The window is captured before the timed region
                   (``capture_s``), unlike the JAX arm, whose compile fell
                   inside it. Raises without CUDA.

Cluster arms:
- ``native``:      every replica verifies on its own C++ verify pool (the
                   host's control arm).
- ``native-cuda``: every replica ships its signature batches to one
                   coalescing ``VerifyServiceDaemon`` (``net/verify_service.py``),
                   warmed on the card before the first replica starts; each
                   merged window is a replayed CUDA graph of the verify path.
                   ``--service-backend native|cpu`` serves the same wire path
                   from the host instead (tag ``native-svc``), for runs
                   without a card.

A row is the JAX harness's ``BenchResult`` (requests/s, rounds/s, reply
latency percentiles, the latency waterfall with ``--trace-dir``) plus the
service's share of the timed region (items, windows, rejected, fallback
items) and ``accounting``: counts over the cluster's whole life that show
where every signature was verified (on the simulation arms, the verifier's
calls, windows, items and rejections and the replicas' checks).

Usage: python -m pbft_tpu_torch.bench.harness --arm cpu|cuda|native|native-cuda
[--config N] [--requests N] [--out FILE]; cluster arms: [--trace-dir DIR] [--secure]
[--pipeline N] [--flush-us N] [--flush-items N] [--batch-max-items N]
[--batch-flush-us N] [--service-backend cuda|native|cpu]
[--service-inflight N]
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional

from .. import native
from ..consensus.invariants import InvariantChecker
from ..consensus.simulation import Cluster
from ..net.client import PbftClient
from ..net.launcher import LocalCluster
from ..net.verify_service import VerifyServiceDaemon, probe_status_json
from ..utils import waterfall


@dataclasses.dataclass
class BenchResult:
    # The JAX harness's fields, names and order.
    config: str
    replicas: int
    f: int
    clients: int
    requests: int
    seconds: float
    rounds_per_sec: float
    sig_verifies_per_sec: float
    sig_verifications: int
    verifier: str
    byzantine: bool = False
    pipeline: int = 1  # in-flight requests per nominal client
    service_inflight: int = 1  # overlapped service launches (service arms)
    # With batch_max_items > 1 one round agrees on a batch of requests:
    # mean_batch = requests executed / rounds executed, from the replicas'
    # own counters.
    requests_per_sec: float = 0.0
    mean_batch: float = 1.0
    batch_max_items: int = 1
    batch_flush_us: int = 0
    # Client-observed reply latency, send -> f + 1 quorum, ms, over the
    # timed region's requests.
    reply_p50_ms: float = 0.0
    reply_p95_ms: float = 0.0
    reply_p99_ms: float = 0.0
    # segment -> {p50, p95, p99, count} in ms (utils/waterfall.py); empty
    # without a trace dir.
    latency_segments_ms: dict = dataclasses.field(default_factory=dict)
    # The verify service's counts over the timed region (0 without one):
    # items verified, windows launched, False verdicts, items served by its
    # host fallback.
    service_items: int = 0
    service_windows: int = 0
    service_rejected: int = 0
    service_fallback_items: int = 0
    service_items_per_window: float = 0.0
    # Over the cluster's whole life, warmup round included: the replicas'
    # sums of sig_verified + sig_rejected (replica_sig_checks), sig_rejected,
    # verify_deadline_fired and view_changes_started, from their last
    # metrics lines once they hold still; with a service, its items and
    # fallback items over the same span.
    accounting: dict = dataclasses.field(default_factory=dict)
    # Seconds spent capturing the card's window before the timed region
    # (the cuda arm; 0 elsewhere).
    capture_s: float = 0.0
    # Seconds the invariant checker took inside the timed region, left out
    # of ``seconds`` (the simulation arms with ``invariants``; 0 elsewhere).
    invariant_s: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


CONFIGS = [
    # (name, n, clients, requests, byzantine)
    ("readme-demo f=1", 4, 1, 1, False),
    ("firehose f=1", 4, 1, 200, False),
    ("f=2 multi-client", 7, 4, 100, False),
    ("f=5 large-batch", 16, 8, 50, False),
    ("f=10 byzantine-signer", 31, 8, 12, True),
]

# In-flight requests per nominal client, by config index: BASELINE's
# firehose is a client at 1k req/s, far above the per-round rate, so its
# load generator keeps 32 requests in flight.
PIPELINE = {1: 32}

SIM_ARMS = ("cpu", "cuda")
ARMS = SIM_ARMS + ("native", "native-cuda")

_COUNTERS = ("sig_verified", "sig_rejected", "executed", "rounds_executed", "verify_deadline_fired",
             "view_changes_started", "verify_batches", "verify_service_fallbacks")


def _replica_counters(cluster: LocalCluster) -> List[dict]:
    """Each replica's counters from the last metrics line in its log, or
    from its ``metrics()`` for a replica on a thread of this process (0
    where a counter has not appeared)."""
    out = []
    for i in range(cluster.config.n):
        if i in cluster.threads:
            line = cluster.threads[i].metrics()
            out.append({key: int(line.get(key, 0)) for key in _COUNTERS})
            continue
        log = cluster.log_path(i).read_text(errors="ignore")
        row = {}
        for key in _COUNTERS:
            found = re.findall(rf'"{key}":\s*(\d+)', log)
            row[key] = int(found[-1]) if found else 0
        out.append(row)
    return out


def _service_status(address: str) -> dict:
    js = probe_status_json(address)
    if js is None:
        raise RuntimeError(f"the verify service at {address} does not answer")
    return js


def _delta(after: dict, before: dict, key: str) -> int:
    return after.get(key, 0) - before.get(key, 0)


def _pct(vals: List[float], q: float) -> float:
    return vals[min(len(vals) - 1, int(q * len(vals)))] if vals else 0.0


def _verifier(arm: str, batch_pad: int, device=None) -> Callable:
    """A simulation arm's verifier: ``cpu`` is the native pool (it waits
    for the core's build, and raises if the core cannot be built);
    ``cuda`` sends the items in chunks of ``batch_pad``, each one window of
    ``batch.verify_many`` on ``device`` (``None`` = the card)."""
    if arm == "cpu":
        return native.verify_batch
    if arm != "cuda":
        raise ValueError(f"unknown simulation arm {arm!r}: one of {SIM_ARMS}")
    from ..crypto import batch

    def cuda_arm(items):
        out = []
        for i in range(0, len(items), batch_pad):
            out.extend(batch.verify_many(items[i : i + batch_pad], pad_to=batch_pad, device=device))
        return out

    return cuda_arm


def _replica_states_digest(cluster: Cluster) -> str:
    """Blake2b-128 hex of every replica's (view, executed_upto, state
    digest, counters), in replica order."""
    states = [[r.view, r.executed_upto, r.state_digest.hex(), dict(r.counters)] for r in cluster.replicas]
    return hashlib.blake2b(json.dumps(states, sort_keys=True).encode(), digest_size=16).hexdigest()


def run_sim_config(
    index: int,
    arm: str = "cpu",
    batch_pad: int = 256,
    requests: Optional[int] = None,
    device=None,
    invariants: bool = False,
) -> BenchResult:
    """Config ``index`` in the in-memory simulation: ``Cluster`` stepped in
    lockstep, each client with one request in flight (PBFT §4.1), until
    every request has committed with f + 1 matching replies (raises
    otherwise). The Byzantine config's replica n - 1 sends every signature
    as ``"ff" * 64``. The native core is built and, on the ``cuda`` arm, the
    ``batch_pad`` window captured by one call on a pad triple, before the
    timed region. With ``invariants`` an ``InvariantChecker`` watches the
    run and checks the safety invariants each time the cluster quiesces
    (raises ``InvariantViolation``); the checker's own seconds, clocked
    around each of its calls, are ``invariant_s`` and left out of
    ``seconds`` and the rates.

    ``accounting`` holds the verifier's calls, items and False verdicts in
    the timed region (on the ``cuda`` arm also its windows of ``batch_pad``
    rows), the replicas' checks, rejections and view changes, and
    ``replica_states``: a digest of every replica's (view, executed_upto,
    state digest, counters), equal between two runs whose replicas ended
    alike."""
    from ..crypto import batch

    name, n, clients, default_requests, byzantine = CONFIGS[index]
    reqs_total = requests or default_requests
    verify = _verifier(arm, batch_pad, device)
    native.available()  # the replicas' host signer; cpu: the verifier too
    capture_s = 0.0
    if arm == "cuda":
        t0 = time.perf_counter()
        verify([batch.PAD_ITEM])
        capture_s = time.perf_counter() - t0
    tally = {"verifier_calls": 0, "items": 0, "rejected": 0}
    if arm == "cuda":
        tally["windows"] = 0

    def counted(items):
        out = verify(items)
        tally["verifier_calls"] += 1
        if arm == "cuda":
            tally["windows"] += -(-len(items) // batch_pad)
        tally["items"] += len(items)
        tally["rejected"] += out.count(False)
        return out

    cluster = Cluster(n=n, verifier=counted)
    checker = None
    invariant_s = 0.0
    if invariants:
        checker = InvariantChecker(cluster)
        observe = cluster.sent_observer

        def timed_observe(src, msg):
            nonlocal invariant_s
            t = time.perf_counter()
            observe(src, msg)
            invariant_s += time.perf_counter() - t

        cluster.sent_observer = timed_observe
    if byzantine:

        def corrupt(src, msg):
            if src == n - 1 and getattr(msg, "sig", ""):
                return dataclasses.replace(msg, sig="ff" * 64)
            return msg

        cluster.outbound_mutator = corrupt

    t0 = time.perf_counter()
    submitted = 0
    client_ts = {c: 0 for c in range(clients)}
    inflight: dict = {}
    executed = 0
    while executed < reqs_total:
        for c in range(clients):
            if c not in inflight and submitted < reqs_total:
                client_ts[c] += 1
                r = cluster.submit(f"op-{submitted}", client=f"127.0.0.1:{9000 + c}", timestamp=client_ts[c])
                inflight[c] = r.timestamp
                submitted += 1
        if not cluster.step():
            if checker is not None:
                t = time.perf_counter()
                checker.check()
                invariant_s += time.perf_counter() - t
                tally["invariant_checks"] = tally.get("invariant_checks", 0) + 1
            # Quiesced: every request in flight has committed or stalled.
            for c, ts in list(inflight.items()):
                cluster.committed_result(ts)  # raises if not committed
                del inflight[c]
                executed += 1
            if submitted >= reqs_total and not inflight:
                break
    elapsed = time.perf_counter() - t0 - invariant_s
    rounds = max((r.counters.get("rounds_executed", 0) for r in cluster.replicas), default=0)
    executed = max((r.counters.get("executed", 0) for r in cluster.replicas), default=0)
    counters = [r.counters for r in cluster.replicas]
    accounting = {
        **tally,
        "replica_sig_checks": sum(c.get("sig_verified", 0) + c.get("sig_rejected", 0) for c in counters),
        "replica_sig_rejected": sum(c.get("sig_rejected", 0) for c in counters),
        "view_changes_started": sum(c.get("view_changes_started", 0) for c in counters),
        "replica_states": _replica_states_digest(cluster),
    }
    return BenchResult(
        config=name,
        replicas=n,
        f=cluster.config.f,
        clients=clients,
        requests=reqs_total,
        seconds=elapsed,
        rounds_per_sec=(rounds or reqs_total) / elapsed,
        sig_verifies_per_sec=cluster.sig_verifications / elapsed,
        sig_verifications=cluster.sig_verifications,
        verifier=arm,
        byzantine=byzantine,
        requests_per_sec=reqs_total / elapsed,
        mean_batch=executed / rounds if rounds else 1.0,
        accounting=accounting,
        capture_s=capture_s,
        invariant_s=invariant_s,
    )


def run_native_config(
    index: int,
    requests: Optional[int] = None,
    verifier: str = "cpu",
    tag: Optional[str] = None,
    trace_dir: Optional[str] = None,
    secure: bool = False,
    pipeline: Optional[int] = None,
    flush_us: int = 0,
    flush_items: int = 0,
    batch_max_items: int = 1,
    batch_flush_us: int = 0,
    impl="cxx",
    metrics_ports: bool = False,
    on_warm: Optional[Callable[[LocalCluster], None]] = None,
    on_done: Optional[Callable[[LocalCluster], None]] = None,
) -> BenchResult:
    """Config ``index`` driven through replica processes over loopback TCP:
    ``pbftd`` by default, or the runtimes ``impl`` names (``LocalCluster``:
    ``"py"`` is the port's asyncio replica, ``"thread"`` that replica on a
    thread of this process; one string or one per replica). The Byzantine
    config runs replica n - 1 with ``--byzantine`` (every outgoing
    signature corrupted): the honest 2f + 1 carry every round.
    ``verifier`` is ``"cpu"`` (each replica's own verify pool), the address
    of a running verify service, which then reports its counts, or, for
    asyncio replicas, ``"cuda"`` (the card, in each replica's process).
    ``flush_us``/``flush_items`` are the replicas' verify accumulation
    window (network.json). With ``metrics_ports`` every replica serves
    ``/metrics`` and ``/status`` (``cluster.metrics_ports``).
    ``on_warm(cluster)`` runs after the warmup request, before the timed
    region, and ``on_done(cluster)`` after the replicas' counters are read,
    before the cluster stops. Raises when a request misses its reply
    quorum.

    ``accounting`` also holds each replica's verify windows
    (``replica_windows``, its ``verify_batches``) and the batches that
    replicas on a verify service verified on their own host
    (``replica_service_fallbacks``)."""
    name, n, clients, default_requests, byzantine = CONFIGS[index]
    if pipeline is None:
        pipeline = PIPELINE.get(index, 1)
    # Each load generator streams a window of at most 8 requests over one
    # connection (PbftClient.request_many); a deeper pipeline is split over
    # several generator identities, since replies are dialed back per
    # address.
    window = min(pipeline, 8)
    workers = clients * max(1, (pipeline + window - 1) // window)
    reqs_total = requests or max(default_requests, 100, clients * pipeline * 6)
    per_worker = max(1, reqs_total // workers)
    reqs_total = per_worker * workers
    service = None if verifier in ("cpu", "cuda") else verifier
    if trace_dir:
        # pbftd appends to its trace files: a stale run's events would join.
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        for old in Path(trace_dir).glob("replica-*.jsonl"):
            old.unlink()
    life0 = _service_status(service) if service else {}
    with LocalCluster(
        n=n,
        verifier=verifier,
        metrics_every=1,
        byzantine=[n - 1] if byzantine else None,
        trace_dir=trace_dir,
        secure=secure,
        verify_flush_us=flush_us,
        verify_flush_items=flush_items,
        batch_max_items=batch_max_items,
        batch_flush_us=batch_flush_us,
        impl=impl,
        metrics_ports=metrics_ports,
    ) as cluster:
        f_val = cluster.config.f
        handles = [PbftClient(cluster.config) for _ in range(workers)]
        try:
            # A generous warmup with retransmission (a first window may find
            # a service still capturing; the client's retry keeps it alive).
            handles[0].request_with_retry("warmup", timeout=600, retry_every=5)
            if on_warm is not None:
                on_warm(cluster)
            timed0 = _service_status(service) if service else {}
            t0 = time.perf_counter()
            t0_mono = time.monotonic()  # client stamps are monotonic
            errors: List[str] = []

            def drive(ci: int) -> None:
                try:
                    handles[ci].request_many([f"op-{ci}-{k}" for k in range(per_worker)], window=window, timeout=60)
                except Exception as e:  # noqa: BLE001 - raised below
                    errors.append(f"load generator {ci}: {type(e).__name__}: {e}")

            threads = [threading.Thread(target=drive, args=(i,)) for i in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            elapsed = time.perf_counter() - t0
            timed1 = _service_status(service) if service else {}
            if errors:
                raise RuntimeError(f"{len(errors)} of {workers} load generators failed: {errors[0]}")
            client_records = [rec for c in handles for rec in c.latency_records() if rec["send"] >= t0_mono]
            reply_ms = sorted((rec["quorum"] - rec["send"]) * 1e3 for rec in client_records if "quorum" in rec)
            latency_segments: dict = {}
            if trace_dir:
                for ci, c in enumerate(handles):
                    c.write_trace(str(Path(trace_dir) / f"client-{ci}.jsonl"))
                events = waterfall.load_jsonl(sorted(Path(trace_dir).glob("replica-*.jsonl")))
                latency_segments = waterfall.build_waterfall(events, client_records)["segments_ms"]
        finally:
            for c in handles:
                c.close()
        # Counters from each replica's last metrics line, one tick after the
        # load; with a service, until neither they nor the service's item
        # count move between ticks (a slow replica may still be verifying
        # the last round's votes).
        time.sleep(1.5)
        counters = _replica_counters(cluster)
        life1 = _service_status(service) if service else {}
        for _ in range(10 if service else 0):
            time.sleep(1.1)
            now, now_service = _replica_counters(cluster), _service_status(service)
            if now == counters and now_service["items"] == life1["items"]:
                break
            counters, life1 = now, now_service
        if on_done is not None:
            on_done(cluster)
    total = {key: sum(c[key] for c in counters) for key in _COUNTERS}
    rounds_max = max(c["rounds_executed"] for c in counters)
    accounting = {
        "replica_sig_checks": total["sig_verified"] + total["sig_rejected"],
        "replica_sig_rejected": total["sig_rejected"],
        "verify_deadline_fired": total["verify_deadline_fired"],
        "view_changes_started": total["view_changes_started"],
        "replica_windows": [c["verify_batches"] for c in counters],
        "replica_service_fallbacks": total["verify_service_fallbacks"],
    }
    if service:
        accounting["service_items"] = _delta(life1, life0, "items")
        accounting["service_fallback_items"] = _delta(life1, life0, "fallback_items")
    windows = _delta(timed1, timed0, "launches")
    items = _delta(timed1, timed0, "items")
    return BenchResult(
        config=name,
        replicas=n,
        f=f_val,
        clients=clients,
        requests=reqs_total,
        seconds=elapsed,
        # rounds/s counts three-phase instances (the warmup round included);
        # requests/s the driven requests of the timed region.
        rounds_per_sec=(rounds_max or reqs_total) / elapsed,
        sig_verifies_per_sec=total["sig_verified"] / elapsed,
        sig_verifications=total["sig_verified"],
        verifier=tag or ("native-secure" if secure else "native"),
        byzantine=byzantine,
        pipeline=pipeline,
        requests_per_sec=reqs_total / elapsed,
        mean_batch=total["executed"] / total["rounds_executed"] if total["rounds_executed"] else 1.0,
        batch_max_items=batch_max_items,
        batch_flush_us=batch_flush_us,
        reply_p50_ms=_pct(reply_ms, 0.5),
        reply_p95_ms=_pct(reply_ms, 0.95),
        reply_p99_ms=_pct(reply_ms, 0.99),
        latency_segments_ms=latency_segments,
        service_items=items,
        service_windows=windows,
        service_rejected=_delta(timed1, timed0, "rejected"),
        service_fallback_items=_delta(timed1, timed0, "fallback_items"),
        service_items_per_window=items / windows if windows else 0.0,
        accounting=accounting,
    )


def start_daemon(
    service_backend: str = "cuda",
    flush_us: int = 0,
    flush_items: int = 0,
    service_inflight: int = 1,
    trace_dir: Optional[str] = None,
    engine=None,
) -> VerifyServiceDaemon:
    """The verify service of a ``native-cuda`` run, started and warm: with
    backend ``cuda`` every window shape is captured on the card before this
    returns (it raises without a card). Metrics are on; with ``trace_dir``
    its per-window trace goes to ``<trace_dir>-service/service.jsonl``.
    ``engine`` is a ``CudaVerifyEngine`` with ``service_inflight`` slots to
    serve, shared by daemons that run one after another (warmed by the
    first that starts)."""
    trace_path = None
    if trace_dir:
        service_dir = f"{trace_dir.rstrip('/')}-service"
        os.makedirs(service_dir, exist_ok=True)
        trace_path = os.path.join(service_dir, "service.jsonl")
        if os.path.exists(trace_path):
            os.unlink(trace_path)  # appended to: stale events would join
    daemon = VerifyServiceDaemon(
        backend=service_backend,
        flush_us=flush_us,
        flush_items=flush_items,
        inflight=service_inflight,
        trace_path=trace_path,
        metrics_port=0,
        engine=engine,
    )
    try:
        return daemon.start(wait_ready=True)
    except BaseException:
        daemon.stop()
        raise


def run_native_cuda_config(
    index: int,
    requests: Optional[int] = None,
    trace_dir: Optional[str] = None,
    secure: bool = False,
    pipeline: Optional[int] = None,
    flush_us: int = 0,
    flush_items: int = 0,
    service_backend: str = "cuda",
    service_inflight: int = 1,
    batch_max_items: int = 1,
    batch_flush_us: int = 0,
    daemon: Optional[VerifyServiceDaemon] = None,
) -> BenchResult:
    """``run_native_config`` against one coalescing verify service shared by
    every replica: N ``pbftd`` on one host, one window on the card per
    launch. ``flush_us``/``flush_items`` are the service's accumulation
    window. ``daemon`` is a daemon from ``start_daemon`` with the same
    ``service_backend``, ``flush_us``, ``flush_items`` and
    ``service_inflight``, to share across runs; without it the run starts
    and stops its own."""
    own = daemon is None
    if own:
        daemon = start_daemon(service_backend, flush_us, flush_items, service_inflight, trace_dir)
    try:
        res = run_native_config(
            index,
            requests=requests,
            verifier=daemon.address,
            tag=("native-cuda" if service_backend == "cuda" else "native-svc") + ("-secure" if secure else ""),
            trace_dir=trace_dir,
            secure=secure,
            pipeline=pipeline,
            batch_max_items=batch_max_items,
            batch_flush_us=batch_flush_us,
        )
        # Rows taken at different overlap settings are not like for like.
        res.service_inflight = service_inflight
        return res
    finally:
        if own:
            daemon.stop()


_SIM_KNOBS = ("batch_pad", "requests", "device", "invariants")


def run_config(arm: str, index: int, **kwargs) -> BenchResult:
    """One config on one arm; an unknown arm raises. The simulation arms
    take ``batch_pad``, ``requests``, ``device`` and ``invariants`` and
    ignore the cluster arms' knobs, as the JAX harness does."""
    if arm in SIM_ARMS:
        return run_sim_config(index, arm, **{k: v for k, v in kwargs.items() if k in _SIM_KNOBS})
    if arm == "native":
        kwargs = {k: v for k, v in kwargs.items() if k not in ("service_backend", "service_inflight")}
        return run_native_config(index, **kwargs)
    if arm == "native-cuda":
        return run_native_cuda_config(index, **kwargs)
    raise ValueError(f"unknown arm {arm!r}: one of {ARMS}")


def run_all(arm: str = "native-cuda", out_path: Optional[str] = None, trace_dir: Optional[str] = None,
            **kwargs) -> List[BenchResult]:
    """Every config on one arm, one JSON row printed per config (and written
    to ``out_path``); each config's traces in ``<trace_dir>/cfg<i>``, as the
    configs differ in n and pbftd appends to ``replica-<i>.jsonl``."""
    if arm not in ARMS:
        raise ValueError(f"unknown arm {arm!r}: one of {ARMS}")
    results = []
    for i in range(len(CONFIGS)):
        res = run_config(arm, i, trace_dir=f"{trace_dir}/cfg{i}" if trace_dir else None, **kwargs)
        print(res.to_json(), flush=True)
        results.append(res)
    if out_path:
        with open(out_path, "w") as fh:
            for r in results:
                fh.write(r.to_json() + "\n")
    return results


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="BASELINE's configs in the in-memory simulation or as pbftd "
                                     "clusters, verified on the host or on the card")
    parser.add_argument("--arm", default="native-cuda", choices=ARMS,
                        help="cpu / cuda = the in-memory simulation on the native pool / the card; native-cuda = "
                        "pbftd replicas -> the port's coalescing verify service on the card")
    parser.add_argument("--config", type=int, default=None, help="0-4; default all")
    parser.add_argument("--requests", type=int, default=None)
    parser.add_argument("--out", default=None, help="write the JSON rows here too")
    parser.add_argument("--trace-dir", default=None, help="per-replica JSONL traces (and the latency waterfall)")
    parser.add_argument("--secure", action="store_true", help="encrypted replica links")
    parser.add_argument("--pipeline", type=int, default=None,
                        help="in-flight requests per nominal client (default: the PIPELINE table)")
    parser.add_argument("--flush-us", type=int, default=0,
                        help="verify accumulation window, microseconds (native: each replica's; native-cuda: "
                        "the service's)")
    parser.add_argument("--flush-items", type=int, default=0,
                        help="flush early once this many items are pending (0 = the window cap)")
    parser.add_argument("--batch-max-items", type=int, default=1,
                        help="requests the primary folds into one three-phase instance")
    parser.add_argument("--batch-flush-us", type=int, default=0, help="partial-batch flush deadline, microseconds")
    parser.add_argument("--service-backend", default="cuda", choices=["cuda", "native", "cpu"],
                        help="native-cuda arm: the service's backend (native = the C++ verify pool, cpu = the "
                        "oracle: the same wire path without a card)")
    parser.add_argument("--service-inflight", type=int, default=1,
                        help="native-cuda arm: overlapped service launches (1 = serial)")
    args = parser.parse_args(argv)
    if args.arm in SIM_ARMS:
        knobs = dict(requests=args.requests)
    else:
        knobs = dict(requests=args.requests, secure=args.secure, pipeline=args.pipeline, flush_us=args.flush_us,
                     flush_items=args.flush_items, batch_max_items=args.batch_max_items,
                     batch_flush_us=args.batch_flush_us, service_backend=args.service_backend,
                     service_inflight=args.service_inflight)
    if args.config is None:
        run_all(args.arm, out_path=args.out, trace_dir=args.trace_dir, **knobs)
        return
    res = run_config(args.arm, args.config, trace_dir=args.trace_dir, **knobs)
    print(res.to_json(), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(res.to_json() + "\n")


if __name__ == "__main__":
    main()
