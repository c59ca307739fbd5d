"""Cluster launcher: a localhost cluster from a ``ClusterConfig``, as a
context manager (the port's copy of ``pbft_tpu/net/launcher.py``).

The reference's 'launcher' was four shell windows plus netcat
(README.md:5-43); here the same scenario is a context manager used by the
tests, the bench harness and ``chip_smoke.py``. Each replica is a ``pbftd``
process (``core/``, built into the shared ``build-core/`` by
``native.build()`` under its file lock), a process of the port's asyncio
runtime (``python -m pbft_tpu_torch.net.server``), or that runtime on an
event-loop thread of the calling process (``ThreadReplica``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import random
import socket
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

from .. import native
from ..consensus.config import ClusterConfig, make_local_cluster

IMPLS = ("cxx", "py", "thread")


def pbftd_path() -> Path:
    """The ``pbftd`` binary, built first where it is missing."""
    native.build()
    return native._BUILD_DIR / "pbftd"


def _ephemeral_low() -> int:
    """The first port of the kernel's ephemeral range (0 when unknown)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
            return int(fh.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0


def free_ports(n: int, avoid=()) -> List[int]:
    """``n`` distinct ports that can be bound now, none in ``avoid`` (ports
    handed out already and not bound yet), for processes that bind them a
    moment later. They are drawn below the kernel's ephemeral range
    where it is known: a port from that range (bind port 0) is free again
    once released, and any outgoing connection on the host can take it as
    its local port before the replica binds it (a cluster of 31 replicas
    dials hundreds of links meanwhile); a port below the range can only be
    taken by another explicit bind."""
    low = _ephemeral_low()
    rng = random.SystemRandom()
    socks, ports = [], []
    try:
        for _ in range(64 * n):
            if len(ports) == n:
                break
            s = socket.socket()
            socks.append(s)
            try:
                s.bind(("0.0.0.0", rng.randrange(max(1024, low - 16384), low) if low > 2048 else 0))
            except OSError:
                continue
            if s.getsockname()[1] not in avoid:
                ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    if len(ports) < n:
        raise OSError(f"found {len(ports)} of {n} free ports")
    return ports


class ThreadReplica:
    """One asyncio replica (``AsyncReplicaServer``) on an event loop of its
    own, on a thread of this process: the shape in which the replica and
    the caller share one CUDA context (and the caller can read the
    replica's counters and the kernels' launch counts directly).
    ``start()`` returns once the replica listens, or raises what its
    construction or start raised (e.g. no CUDA for verifier ``cuda``);
    ``begin_stop()`` then ``join()`` stop it and join the thread."""

    def __init__(self, config: ClusterConfig, replica_id: int, seed: bytes, **kwargs):
        self.replica_id = replica_id
        self.server = None
        self.loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(config, seed, kwargs), name=f"replica-{replica_id}", daemon=True
        )

    def start(self, timeout: float = 120.0) -> "ThreadReplica":
        self._thread.start()
        if not self._started.wait(timeout):
            raise TimeoutError(f"replica {self.replica_id} did not start in {timeout} s")
        if self._error is not None:
            raise self._error
        return self

    def _run(self, config: ClusterConfig, seed: bytes, kwargs: dict) -> None:
        from .server import AsyncReplicaServer

        asyncio.set_event_loop(self.loop)
        try:
            self.server = AsyncReplicaServer(config, self.replica_id, seed, **kwargs)
            self.loop.run_until_complete(self.server.start())
        except BaseException as e:  # noqa: BLE001 - re-raised by start()
            self._error = e
            self.loop.close()
            self._started.set()
            return
        self._started.set()
        try:
            self.loop.run_forever()
        finally:
            tasks = asyncio.all_tasks(self.loop)
            for task in tasks:
                task.cancel()
            self.loop.run_until_complete(asyncio.gather(*tasks, return_exceptions=True))
            self.loop.close()

    def metrics(self) -> dict:
        """The replica's ``metrics()`` line, built on its event loop
        (``AsyncReplicaServer.status``)."""
        return self.server.status()

    async def _stop_server(self, timeout: float) -> None:
        # server.stop() waits for its inbound connections to close (Python
        # 3.12's Server.wait_closed); a live peer may hold one open, and
        # the loop's shutdown cancels its handler instead.
        try:
            await asyncio.wait_for(self.server.stop(), timeout)
        except asyncio.TimeoutError:
            pass

    def begin_stop(self, timeout: float = 5.0):
        """Start stopping the server on its loop; the future's result is
        its end. Replicas stopped together each close their links to the
        others at once, so none waits on another's."""
        if self._error is None and self._thread.is_alive():
            return asyncio.run_coroutine_threadsafe(self._stop_server(timeout), self.loop)
        return None

    def join(self, stopping, timeout: float = 5.0) -> None:
        if stopping is not None:
            stopping.result(timeout + 5)
            self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout + 5)



class LocalCluster:
    """N replicas on loopback ephemeral ports.

    ``impl`` selects the runtime per replica (a string for all, or a list):
    "cxx" spawns the native ``pbftd`` daemon, "py" spawns the port's asyncio
    runtime (``python -m pbft_tpu_torch.net.server``), "thread" runs that
    runtime on an event-loop thread of this process (``ThreadReplica``,
    ``self.threads[i]``). They are wire-compatible (framed canonical JSON
    or binary-v2), so mixed clusters interoperate — with ``pbftd`` and with
    the JAX package's asyncio replicas — the strongest form of the
    cross-implementation determinism requirement (SURVEY.md §7).

    ``verifier`` goes to every replica: ``"cpu"`` (each replica's host
    verify pool), a verify service's ``host:port`` or unix path, or, for
    the asyncio replicas only, ``"cuda"`` (the card, in each replica's
    process; ``pbftd`` has no such verifier). A "thread" replica takes the
    launch options that ``AsyncReplicaServer`` takes (verifier, view-change
    timeout, discovery, faults, chaos, metrics port); it has no log file or
    flight dump, and it writes its trace events to this process's tracer,
    which ``trace_dir`` points at its ``replica-<i>.jsonl`` while the
    cluster runs."""

    def __init__(
        self,
        n: int = 4,
        verifier: str = "cpu",
        metrics_every: int = 0,
        vc_timeout_ms: int = 0,
        impl: "str | List[str]" = "cxx",
        discovery: bool = False,
        config: Optional[ClusterConfig] = None,
        seeds: Optional[List[bytes]] = None,
        trace_dir: Optional[str] = None,
        flight_dir: Optional[str] = None,
        byzantine: Optional[List[int]] = None,
        secure: bool = False,
        verify_flush_us: int = 0,
        verify_flush_items: int = 0,
        batch_max_items: "int | List[int]" = 1,
        batch_flush_us: "int | List[int]" = 0,
        extra_env: Optional[List[Optional[dict]]] = None,
        faults: Optional[dict] = None,
        chaos_drop_pct: float = 0.0,
        chaos_delay_ms: int = 0,
        chaos_seed: Optional[int] = None,
        admission_inflight: int = 0,
        admission_backlog: int = 0,
        net_threads: int = 1,
        fastpath: str = "sig",
        tentative: bool = False,
        wal: bool = False,
        wal_fsync: bool = True,
        metrics_ports: bool = False,
    ):
        self.trace_dir = trace_dir
        # Black-box flight recorders: each daemon dumps its last
        # N protocol events to {flight_dir}/replica-{i}.flight on
        # SIGTERM/fatal — kill() therefore ships the dead replica's black
        # box (decode with scripts/flight_dump.py).
        self.flight_dir = flight_dir
        # Request batching: scalars land in network.json; lists
        # become per-replica --batch-* CLI overrides (e.g. a batching
        # primary among batch=1 peers for the mixed-mode interop test).
        n_for_lists = (config.n if config is not None else n)
        self.batch_max_items = (
            batch_max_items
            if isinstance(batch_max_items, list)
            else [batch_max_items] * n_for_lists
        )
        self.batch_flush_us = (
            batch_flush_us
            if isinstance(batch_flush_us, list)
            else [batch_flush_us] * n_for_lists
        )
        self._batch_scalar = not (
            isinstance(batch_max_items, list) or isinstance(batch_flush_us, list)
        )
        # Replica ids whose daemons corrupt every outgoing signature
        # (--byzantine, both runtimes; the real-daemon analogue of the
        # simulation's outbound mutator).
        self.byzantine = set(byzantine or [])
        # Generalized fault injection: {replica_id: mode} maps
        # to --fault on the daemon (sig-corrupt|mute|stutter|equivocate),
        # and the chaos_* scalars become seeded --chaos-* link knobs on
        # EVERY replica (per-replica seeds derive from chaos_seed + id so
        # one scalar still gives each daemon its own stream).
        self.faults = dict(faults or {})
        # Durable recovery: wal=True gives every replica a
        # write-ahead log under {tmpdir}/wal (--wal-dir on both
        # runtimes); kill(hard=True) + revive(from_disk=True) then
        # exercises the kill -9 -> replay-from-disk path. wal_fsync=False
        # keeps the writes but skips the fsync (the A/B durability-cost
        # lever).
        self.wal = wal
        self.wal_fsync = wal_fsync
        # Health introspection: metrics_ports=True gives every
        # replica a loopback scrape listener (--metrics-port, both
        # runtimes) serving Prometheus + the /status health document;
        # self.metrics_ports maps replica id -> bound port after
        # __enter__ (pre-allocated — pbftd logs its ephemeral port to
        # stderr, but pre-allocation keeps revive() on the same port).
        self.want_metrics_ports = metrics_ports
        self.metrics_ports: List[int] = []
        self.chaos_drop_pct = chaos_drop_pct
        self.chaos_delay_ms = chaos_delay_ms
        self.chaos_seed = chaos_seed
        self.discovery = discovery
        if config is None:
            config, seeds = make_local_cluster(n, base_port=0)
            # Discovery mode: every replica binds an ephemeral port and
            # finds peers via multicast beacons (the mDNS-equivalent);
            # otherwise pre-allocate loopback ports in the config.
            ports = [0] * n if discovery else free_ports(n)
            config = dataclasses.replace(
                config,
                replicas=[
                    dataclasses.replace(r, port=ports[i])
                    for i, r in enumerate(config.replicas)
                ],
                verifier=verifier,
                secure=secure,
                verify_flush_us=verify_flush_us,
                verify_flush_items=verify_flush_items,
                batch_max_items=(
                    batch_max_items if self._batch_scalar else 1
                ),
                batch_flush_us=(
                    batch_flush_us if self._batch_scalar else 0
                ),
                # Admission control: network.json knobs, read
                # identically by both runtimes.
                admission_inflight=admission_inflight,
                admission_backlog=admission_backlog,
                # Multi-core replica core: pbftd shards its
                # event loop; the asyncio runtime accepts the key and
                # stays single-loop.
                net_threads=net_threads,
                # Fast-path modes: the MAC authenticator
                # offer and tentative execution, read identically by
                # both runtimes from network.json.
                fastpath=fastpath,
                tentative=tentative,
                # Durable recovery: wal_fsync rides in
                # network.json; the directory itself is a per-launch
                # --wal-dir flag (set in __enter__, where tmpdir exists).
                wal_fsync=wal_fsync,
            )
        self.config = config
        self.seeds = seeds
        self.verifier = verifier
        self.metrics_every = metrics_every
        self.vc_timeout_ms = vc_timeout_ms
        self.impl = [impl] * self.config.n if isinstance(impl, str) else list(impl)
        if len(self.impl) != self.config.n or not set(self.impl) <= set(IMPLS):
            raise ValueError(f"impl {impl!r}: {self.config.n} of {IMPLS}")
        if verifier == "cuda" and "cxx" in self.impl:
            raise ValueError("pbftd has no cuda verifier: give it a verify service's address")
        # Per-replica environment overrides (e.g. PBFT_WIRE_CODEC=json to
        # force a JSON-only 1.0.0 peer in a mixed-codec interop test).
        self.extra_env = extra_env or [None] * self.config.n
        # One entry per replica: the process, or None for a "thread" one.
        self.procs: List[Optional[subprocess.Popen]] = []
        self.threads: dict = {}  # replica id -> ThreadReplica
        self.tmpdir: Optional[tempfile.TemporaryDirectory] = None
        self._cmds: List[tuple] = []  # (cmd, env) per replica, for revive()
        self._traced_thread = False

    def __enter__(self) -> "LocalCluster":
        try:
            self._launch()
            if self.discovery:
                self._learn_discovered_ports()
            self._wait_listening()
        except BaseException:
            self.__exit__()
            raise
        return self

    def _launch(self) -> None:
        import sys

        if self.discovery:
            # Unique group:port per cluster so parallel tests don't hear
            # each other's beacons.
            self._discovery_target = "239.255.%d.%d:%d" % (
                random.randint(1, 254),
                random.randint(1, 254),
                free_ports(1)[0],
            )
        daemon = pbftd_path() if "cxx" in self.impl else None
        self.tmpdir = tempfile.TemporaryDirectory(prefix="pbftd-")
        cfg_path = Path(self.tmpdir.name) / "network.json"
        cfg_path.write_text(self.config.to_json())
        repo_root = str(Path(__file__).resolve().parent.parent.parent)
        if self.want_metrics_ports and not self.metrics_ports:
            self.metrics_ports = free_ports(self.config.n, avoid={r.port for r in self.config.replicas})
        for i in range(self.config.n):
            if self.impl[i] == "thread":
                self._start_thread(i)
                continue
            if self.impl[i] == "cxx":
                cmd = [str(daemon)]
                env = None
            else:
                cmd = [sys.executable, "-m", "pbft_tpu_torch.net.server"]
                env = dict(os.environ, PYTHONPATH=repo_root)
            if self.extra_env[i]:
                env = dict(env if env is not None else os.environ)
                env.update(self.extra_env[i])
            cmd += [
                "--config",
                str(cfg_path),
                "--id",
                str(i),
                "--seed",
                self.seeds[i].hex(),
                "--verifier",
                self.verifier,
            ]
            if self.metrics_every:
                cmd += ["--metrics-every", str(self.metrics_every)]
            if self.want_metrics_ports:
                cmd += ["--metrics-port", str(self.metrics_ports[i])]
            if not self._batch_scalar:
                cmd += [
                    "--batch-max-items", str(self.batch_max_items[i]),
                    "--batch-flush-us", str(self.batch_flush_us[i]),
                ]
            if self.vc_timeout_ms:
                cmd += ["--vc-timeout-ms", str(self.vc_timeout_ms)]
            if self.discovery:
                cmd += ["--discovery", self._discovery_target]
            if self.trace_dir:
                cmd += ["--trace", str(Path(self.trace_dir) / f"replica-{i}.jsonl")]
            if self.flight_dir:
                Path(self.flight_dir).mkdir(parents=True, exist_ok=True)
                cmd += [
                    "--flight-file",
                    str(Path(self.flight_dir) / f"replica-{i}.flight"),
                ]
            if self.wal:
                wal_dir = Path(self.tmpdir.name) / "wal"
                wal_dir.mkdir(parents=True, exist_ok=True)
                cmd += ["--wal-dir", str(wal_dir)]
            if i in self.byzantine:
                cmd += ["--byzantine"]
            if self.faults.get(i):
                cmd += ["--fault", str(self.faults[i])]
            if self.chaos_drop_pct > 0:
                cmd += ["--chaos-drop-pct", str(self.chaos_drop_pct)]
            if self.chaos_delay_ms > 0:
                cmd += ["--chaos-delay-ms", str(self.chaos_delay_ms)]
            if (self.chaos_drop_pct > 0 or self.chaos_delay_ms > 0) and (
                self.chaos_seed is not None
            ):
                cmd += ["--chaos-seed", str(self.chaos_seed + i)]
            self._cmds.append((cmd, env))
            with open(self.log_path(i), "wb") as log:
                self.procs.append(subprocess.Popen(cmd, stdout=log, stderr=log, close_fds=True, env=env))

    def _start_thread(self, i: int) -> None:
        """Replica ``i`` on an event-loop thread of this process."""
        self._cmds.append((None, None))
        self.procs.append(None)
        if self.trace_dir:
            from ..utils import set_trace_file

            Path(self.trace_dir).mkdir(parents=True, exist_ok=True)
            set_trace_file(str(Path(self.trace_dir) / f"replica-{i}.jsonl"))
            self._traced_thread = True
        self.threads[i] = ThreadReplica(
            self.config,
            i,
            self.seeds[i],
            verifier=self.verifier,
            vc_timeout=self.vc_timeout_ms / 1000.0,
            discovery=self._discovery_target,
            byzantine=i in self.byzantine,
            fault=self.faults.get(i) or "",
            chaos_drop_pct=self.chaos_drop_pct,
            chaos_delay_ms=self.chaos_delay_ms,
            chaos_seed=None if self.chaos_seed is None else self.chaos_seed + i,
            metrics_port=self.metrics_ports[i] if self.want_metrics_ports else None,
        ).start()

    _discovery_target = ""

    def _learn_discovered_ports(self, timeout: float = 20.0) -> None:
        """Parse each replica's 'listening on N' log line so the *client*
        knows where to dial; the replicas themselves learn each other
        from beacons."""
        import re

        deadline = time.monotonic() + timeout
        ports: dict = {}
        while len(ports) < self.config.n:
            for i in range(self.config.n):
                if i in ports:
                    continue
                if i in self.threads:
                    ports[i] = self.threads[i].server.listen_port
                    continue
                log = self.log_path(i)
                if log.exists():
                    m = re.search(r"listening on (\d+)", log.read_text(errors="replace"))
                    if m:
                        ports[i] = int(m.group(1))
            if time.monotonic() > deadline:
                raise TimeoutError(f"discovery ports not learned\n{self.logs()}")
            time.sleep(0.05)
        self.config = dataclasses.replace(
            self.config,
            replicas=[
                dataclasses.replace(r, port=ports[i])
                for i, r in enumerate(self.config.replicas)
            ],
        )

    def _wait_listening(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        for ident in self.config.replicas:
            while True:
                try:
                    with socket.create_connection(
                        (ident.host, ident.port), timeout=0.2
                    ) as probe:
                        probe.setsockopt(
                            socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                        )
                        break
                except OSError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"replica {ident.replica_id} never listened on "
                            f"{ident.host}:{ident.port}\n{self.logs()}"
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

    def kill(self, replica_id: int, hard: bool = False) -> None:
        """Crash-stop one replica (fault injection: PBFT tolerates f).
        ``hard=True`` sends SIGKILL (the kill -9 realism arm):
        no signal handler runs — no flight dump, no final fsync beyond
        what group commit already made durable."""
        if replica_id in self.threads:
            raise ValueError(f"replica {replica_id} runs on a thread of this process: it stops with the cluster")
        if hard:
            self.procs[replica_id].kill()
        else:
            self.procs[replica_id].terminate()
        self.procs[replica_id].wait(timeout=5)

    _KEEP = object()  # revive() sentinel: carry the original launch flag

    def revive(
        self,
        replica_id: int,
        fault=_KEEP,
        chaos_drop_pct=_KEEP,
        chaos_delay_ms=_KEEP,
        from_disk: bool = False,
    ) -> None:
        """Restart a killed replica.

        The default is the historic FRESH-STATE restart: the daemon
        forgets everything and catches up via checkpoints + state
        transfer (PBFT §5.3). CAVEAT this default silently relies on —
        and tests composing faults must respect — the <= f window: an
        amnesiac restart has forgotten its PREPARE/COMMIT votes, so for
        the duration of its catch-up it can (under adversarial message
        timing) vote differently than its previous life and must be
        budgeted as one of the f tolerable faults. It is safe in every
        scenario that keeps total concurrent faults within f, which is
        why it was acceptable so far — but it is NOT a durability story.

        ``from_disk=True`` is the durability story: the
        daemon relaunches with its original ``--wal-dir`` (requires the
        cluster to have been built with ``wal=True``), replays the
        write-ahead log, re-joins the SAME view at its stable-checkpoint
        floor, and refuses to emit any vote contradicting a persisted
        one — a from-disk restart never spends fault budget.

        Either way the revived daemon CARRIES the fault/chaos flags of
        the original launch, so kill -> revive composes with fault
        schedules instead of silently swapping in a clean replica. Pass
        ``fault=None`` / ``chaos_*=0`` to revive clean(er), or a new
        mode/value to change the behavior across the restart."""
        cmd, env = self._cmds[replica_id]
        if from_disk:
            if "--wal-dir" not in cmd:
                raise ValueError(
                    "revive(from_disk=True) needs a cluster launched with "
                    "wal=True (no --wal-dir on the original command)"
                )
        elif "--wal-dir" in cmd:
            # Fresh-state semantics must stay the default even on a
            # wal-enabled cluster: wipe this replica's log so the replay
            # finds nothing (the amnesia scenario, deliberately).
            ix = cmd.index("--wal-dir")
            wal_path = Path(cmd[ix + 1]) / f"replica-{replica_id}.wal"
            try:
                wal_path.unlink()
            except FileNotFoundError:
                pass
        if fault is not self._KEEP or chaos_drop_pct is not self._KEEP or (
            chaos_delay_ms is not self._KEEP
        ):
            cmd = self._strip_fault_flags(
                list(cmd),
                strip_fault=fault is not self._KEEP,
                strip_drop=chaos_drop_pct is not self._KEEP,
                strip_delay=chaos_delay_ms is not self._KEEP,
            )
            if fault is not self._KEEP and fault:
                cmd += ["--fault", str(fault)]
            if chaos_drop_pct is not self._KEEP and chaos_drop_pct > 0:
                cmd += ["--chaos-drop-pct", str(chaos_drop_pct)]
            if chaos_delay_ms is not self._KEEP and chaos_delay_ms > 0:
                cmd += ["--chaos-delay-ms", str(chaos_delay_ms)]
            self._cmds[replica_id] = (cmd, env)
        with open(self.log_path(replica_id), "ab") as log:
            self.procs[replica_id] = subprocess.Popen(cmd, stdout=log, stderr=log, close_fds=True, env=env)

    @staticmethod
    def _strip_fault_flags(cmd, strip_fault, strip_drop, strip_delay):
        out, skip = [], 0
        for arg in cmd:
            if skip:
                skip -= 1
                continue
            if strip_fault and arg == "--byzantine":
                continue
            if strip_fault and arg == "--fault":
                skip = 1
                continue
            if strip_drop and arg == "--chaos-drop-pct":
                skip = 1
                continue
            if strip_delay and arg == "--chaos-delay-ms":
                skip = 1
                continue
            out.append(arg)
        return out

    def __exit__(self, *exc) -> None:
        # The processes first: their links to a thread replica then close.
        procs = [p for p in self.procs if p is not None]
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        try:
            stopping = [(t, t.begin_stop()) for t in self.threads.values()]
            for t, fut in stopping:
                t.join(fut)
        finally:
            self.threads = {}
            if self._traced_thread:
                from ..utils import set_trace_file

                set_trace_file(None)
                self._traced_thread = False
            if self.tmpdir:
                self.tmpdir.cleanup()
                self.tmpdir = None
