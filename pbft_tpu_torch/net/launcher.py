"""Cluster launcher: a localhost ``pbftd`` cluster from a ``ClusterConfig``,
as a context manager (the port's copy of ``pbft_tpu/net/launcher.py``, cut
to the options the bench harness passes).

Every replica is a ``pbftd`` process (``core/``), built into the shared
``build-core/`` by ``native.build()`` under its file lock. The port's Python
replica (``consensus/replica.py``) runs only in the in-memory simulation:
the asyncio runtime that would serve it over sockets is not ported.
"""

from __future__ import annotations

import dataclasses
import socket
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

from .. import native
from ..consensus.config import make_local_cluster


def pbftd_path() -> Path:
    """The ``pbftd`` binary, built first where it is missing."""
    native.build()
    return native._BUILD_DIR / "pbftd"


def free_ports(n: int) -> List[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


class LocalCluster:
    """``n`` ``pbftd`` replicas on loopback ephemeral ports.

    ``verifier`` is what each replica verifies with: ``"cpu"`` (``pbftd``'s
    own C++ verify pool) or a verify service's ``host:port`` or unix path.
    ``metrics_every`` (seconds, 0 = off) has each replica write a JSON
    metrics line to its log; ``byzantine`` lists replicas whose every
    outgoing signature is corrupted (``pbftd --byzantine``); ``trace_dir``
    gets one JSONL trace per replica (``replica-<i>.jsonl``)."""

    def __init__(
        self,
        n: int = 4,
        verifier: str = "cpu",
        metrics_every: int = 0,
        byzantine: Optional[List[int]] = None,
        trace_dir: Optional[str] = None,
        secure: bool = False,
        verify_flush_us: int = 0,
        verify_flush_items: int = 0,
        batch_max_items: int = 1,
        batch_flush_us: int = 0,
    ):
        config, seeds = make_local_cluster(n, base_port=0)
        ports = free_ports(n)
        self.config = dataclasses.replace(
            config,
            replicas=[dataclasses.replace(r, port=ports[i]) for i, r in enumerate(config.replicas)],
            verifier=verifier,
            secure=secure,
            verify_flush_us=verify_flush_us,
            verify_flush_items=verify_flush_items,
            batch_max_items=batch_max_items,
            batch_flush_us=batch_flush_us,
        )
        self.seeds = seeds
        self.verifier = verifier
        self.metrics_every = metrics_every
        self.byzantine = set(byzantine or [])
        self.trace_dir = trace_dir
        self.procs: List[subprocess.Popen] = []
        self.tmpdir: Optional[tempfile.TemporaryDirectory] = None

    def __enter__(self) -> "LocalCluster":
        daemon = pbftd_path()
        self.tmpdir = tempfile.TemporaryDirectory(prefix="pbftd-")
        cfg_path = Path(self.tmpdir.name) / "network.json"
        cfg_path.write_text(self.config.to_json())
        try:
            for i in range(self.config.n):
                cmd = [
                    str(daemon),
                    "--config", str(cfg_path),
                    "--id", str(i),
                    "--seed", self.seeds[i].hex(),
                    "--verifier", self.verifier,
                ]
                if self.metrics_every:
                    cmd += ["--metrics-every", str(self.metrics_every)]
                if self.trace_dir:
                    cmd += ["--trace", str(Path(self.trace_dir) / f"replica-{i}.jsonl")]
                if i in self.byzantine:
                    cmd += ["--byzantine"]
                with open(Path(self.tmpdir.name) / f"replica-{i}.log", "wb") as log:
                    self.procs.append(subprocess.Popen(cmd, stdout=log, stderr=log, close_fds=True))
            self._wait_listening()
        except BaseException:
            self.__exit__()
            raise
        return self

    def _wait_listening(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        for ident in self.config.replicas:
            while True:
                try:
                    with socket.create_connection((ident.host, ident.port), timeout=0.2) as probe:
                        probe.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                        break
                except OSError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"replica {ident.replica_id} never listened on {ident.host}:{ident.port}\n{self.logs()}"
                        )
                    time.sleep(0.05)

    def log_path(self, replica_id: int) -> Path:
        return Path(self.tmpdir.name) / f"replica-{replica_id}.log"

    def logs(self) -> str:
        out = []
        if self.tmpdir:
            for p in sorted(Path(self.tmpdir.name).glob("replica-*.log")):
                out.append(f"=== {p.name} ===\n{p.read_text(errors='replace')}")
        return "\n".join(out)

    def __exit__(self, *exc) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if self.tmpdir:
            self.tmpdir.cleanup()
            self.tmpdir = None
