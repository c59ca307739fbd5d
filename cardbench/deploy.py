"""One deployment of a configuration, through the system's own entry
points: a ``VerifyServiceDaemon`` in this process, warmed before any replica
starts (as ``bench/harness.py`` ``start_daemon`` does), and ``pbftd``
replicas launched by ``LocalCluster`` with the daemon's address as their
verifier and keys derived from the run's seed.

``Recorder`` wraps the daemon's backend call, in this process: it keeps each
window's triples, verdicts and host-clock span for the check and the
per-layer readers, and, for the control and the fault tests only, alters
the verdicts on their way back to the service (``FAULTS``). ``CardClock``
times every CUDA graph replayed in this process on the card's own clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import socket
import threading
import time
from typing import Callable, Dict, List, Optional


def _accept_all(items, verdicts):
    return [True] * len(verdicts)


def _half_unverified(items, verdicts):
    half = (len(verdicts) + 1) // 2
    return list(verdicts[:half]) + [True] * (len(verdicts) - half)


def _flip_one(items, verdicts):
    out = list(verdicts)
    out[-1] = not out[-1]
    return out


# The faults a run of this system can have, each planted where the answer is
# produced: the control (every signature accepted, the configuration's
# guarantee of RFC 8032 verdicts broken), half of each window left
# unverified and answered True, and one answer of each window altered.
FAULTS: Dict[str, Callable] = {
    "accept_all": _accept_all,
    "half_unverified": _half_unverified,
    "flip_one": _flip_one,
}


@dataclasses.dataclass
class Window:
    start: float
    end: float
    items: list
    verdicts: list


class Recorder:
    """The daemon's backend call, recorded. ``quiet()`` holds new windows
    back and waits out those in flight: the profiler's start and stop
    deadlock against a CUDA graph being launched on another thread."""

    def __init__(self, backend: Callable, fault: Optional[str] = None):
        self._backend = backend
        self._fault = FAULTS[fault] if fault else None
        self.fault_on = False  # set when the load starts: set-up stays sound
        self._cond = threading.Condition()
        self._active = 0
        self._paused = False
        self.windows: List[Window] = []

    def __call__(self, items):
        with self._cond:
            while self._paused:
                self._cond.wait()
            self._active += 1
        try:
            t0 = time.monotonic()
            verdicts = self._backend(items)
            if self._fault is not None and self.fault_on:
                verdicts = self._fault(items, verdicts)
            t1 = time.monotonic()
        finally:
            with self._cond:
                self._active -= 1
                self._cond.notify_all()
        with self._cond:
            self.windows.append(Window(t0, t1, items, list(verdicts)))
        return verdicts

    @contextlib.contextmanager
    def quiet(self):
        with self._cond:
            self._paused = True
            while self._active:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._paused = False
                self._cond.notify_all()


class CardClock:
    """The card's time of every CUDA graph replayed in this process while it
    runs: ``torch.cuda.CUDAGraph.replay`` is wrapped, from ``start()`` to
    ``stop()``, by a pair of timing events recorded on the replaying stream,
    with the host's clock at the launch. A window of the verify service is
    one replay on the service's launch thread, so the pair spans the
    window's device work and nothing of the host's path around it."""

    def __init__(self):
        self.marks: list = []  # (host monotonic at the launch, begin event, end event)
        self._orig = None

    def start(self) -> None:
        import torch

        orig = self._orig = torch.cuda.CUDAGraph.replay
        marks = self.marks

        def replay(graph):
            stream = torch.cuda.current_stream()
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.monotonic()
            begin.record(stream)
            orig(graph)
            end.record(stream)
            marks.append((t, begin, end))

        torch.cuda.CUDAGraph.replay = replay

    def stop(self) -> None:
        if self._orig is not None:
            import torch

            torch.cuda.CUDAGraph.replay = self._orig
            self._orig = None

    def card_ms(self, t0: float, t1: float) -> tuple:
        """(device milliseconds, replays) of the replays launched in [t0, t1)."""
        spans = []
        for t, begin, end in list(self.marks):
            if t0 <= t < t1:
                end.synchronize()
                spans.append(begin.elapsed_time(end))
        return sum(spans), len(spans)


def start_daemon(config: dict, backend: str, trace_path: Optional[str], fault: Optional[str], engine=None):
    """The config's verify service, warm (``wait_ready``), with its backend
    call wrapped by a ``Recorder``. ``backend`` is the config's (``cuda``),
    or ``native`` for the CPU tests; ``engine``, a warm ``CudaVerifyEngine``
    that the control's runs share. Raises when the warm fails."""
    from pbft_tpu_torch.net.verify_service import VerifyServiceDaemon

    svc = config["verify_service"]
    daemon = VerifyServiceDaemon(
        backend=backend,
        devices=svc["devices"] if backend == "cuda" else None,
        flush_us=svc["flush_us"],
        flush_items=svc["flush_items"],
        inflight=svc["inflight"],
        trace_path=trace_path,
        engine=engine,
    )
    recorder = Recorder(daemon.service.backend, fault)
    daemon.service.backend = recorder
    try:
        daemon.start(wait_ready=True)
    except BaseException:
        daemon.stop()
        raise
    return daemon, recorder


def replica_seeds(n: int, seed: int) -> List[bytes]:
    """Each replica's Ed25519 secret, from the run's seed."""
    return [hashlib.blake2b(f"cardbench-{seed}-replica-{i}".encode(), digest_size=32).digest() for i in range(n)]


def start_cluster(config: dict, seed: int, verifier: str):
    """``LocalCluster`` of the config's ``pbftd`` replicas on loopback, each
    with a ``/status`` listener, verifying through ``verifier``."""
    from pbft_tpu_torch.consensus.config import ClusterConfig, ReplicaIdentity
    from pbft_tpu_torch.crypto import ref
    from pbft_tpu_torch.net.launcher import LocalCluster, free_ports

    n = config["replicas"]
    seeds = replica_seeds(n, seed)
    ports = free_ports(n)
    cluster_config = ClusterConfig(
        replicas=[ReplicaIdentity(i, "127.0.0.1", ports[i], ref.public_key(s).hex()) for i, s in enumerate(seeds)],
        watermark_window=config["watermark_window"],
        checkpoint_interval=config["checkpoint_interval"],
        batch_max_items=config["batch_max_items"],
        batch_flush_us=config["batch_flush_us"],
        fastpath=config["fastpath"],
        verifier=verifier,
    )
    cluster = LocalCluster(
        config=cluster_config,
        seeds=seeds,
        verifier=verifier,
        byzantine=config["byzantine"],
        vc_timeout_ms=config["view_change_timeout_ms"],
        metrics_ports=True,
    )
    return cluster.__enter__()


def replica_status(port: int, timeout: float = 5.0) -> dict:
    """A ``pbftd``'s ``/status`` document (its counters and digests)."""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.sendall(b"GET /status HTTP/1.0\r\nHost: 127.0.0.1\r\n\r\n")
        chunks = []
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            chunks.append(chunk)
    body = b"".join(chunks).split(b"\r\n\r\n", 1)[1]
    return json.loads(body)


def snapshot(cluster, daemon) -> dict:
    """Every replica's ``/status`` and the daemon's status, at one moment."""
    t = time.monotonic()
    return {
        "t": t,
        "replicas": [replica_status(p) for p in cluster.metrics_ports],
        "service": daemon.status_json(),
    }
