"""The verifier service: the boundary between the replica runtimes and the
batched verifier on the card (the port of ``pbft_tpu/net/service.py``).

Protocol (mirrors core/verifier.h RemoteVerifier):
    request:  u32be count N, then N * 128 bytes (pub 32 | msg 32 | sig 64)
    response: N bytes, each 0/1

Cross-connection coalescing: when several colocated daemons (one per replica)
submit batches concurrently, a dispatcher merges everything queued into ONE
backend call, so the launch cost is paid once per window. With no
accumulation knob set, the window is exactly "whatever queued while the
previous launch ran".

Backends by name: ``"cuda"`` (the default: the batched verifier on the
card, sharded over the local cards when there are several; raises at
construction without CUDA), ``"native"`` (the C++ core's verify pool,
``pbft_tpu_torch.native``; raises at construction when the library cannot
be built or loaded) and ``"cpu"`` (the RFC 8032 oracle, item by item).

Metrics (``metrics_port``): the verify subset of the manifest
(``utils/trace_schema.py``), labelled ``{replica="service"}``, served as
Prometheus text on ``/metrics`` and the JSON status on ``/status``; the same
counter, gauge and histogram updates at the same points as the JAX service,
so that the two scrape alike. A port that cannot be bound raises from the
constructor.

CLI: ``python -m pbft_tpu_torch.net.service --backend cuda|native|cpu
[--metrics-port N] ...`` serves a bare service (no warmup lifecycle; the
daemon with one is ``verify_service.py``).
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
import time
from typing import Callable, List, Optional, Tuple

Item = Tuple[bytes, bytes, bytes]

# -- readiness handshake wire format -----------------------------------------
#
# Request header (u32be item count) values that are NOT batches:
#   STATUS_PROBE (0)               -> 8-byte binary status reply
#   STATUS_JSON_PROBE (0xFFFFFFFF) -> u32be length + JSON status reply
# Real batches are capped far below, so neither value collides with traffic.

STATUS_PROBE = 0
STATUS_JSON_PROBE = 0xFFFFFFFF
STATUS_MAGIC = b"VS"
STATUS_VERSION = 1
STATUS_LEN = 8

STATE_WARMING = 0
STATE_READY = 1
STATE_CPU_ONLY = 2
STATE_NAMES = {
    STATE_WARMING: "warming",
    STATE_READY: "ready",
    STATE_CPU_ONLY: "cpu-only",
}


def pack_status(state: int, devices: int, warmed: int) -> bytes:
    """8 bytes: 'V' 'S' version state u16be devices u16be warmed-shapes."""
    return STATUS_MAGIC + struct.pack(
        ">BBHH", STATUS_VERSION, state, min(devices, 0xFFFF), min(warmed, 0xFFFF)
    )


def unpack_status(blob: bytes) -> Optional[Tuple[int, int, int]]:
    """(state, devices, warmed_shapes), or None if not a status record."""
    if len(blob) != STATUS_LEN or blob[:2] != STATUS_MAGIC:
        return None
    version, state, devices, warmed = struct.unpack(">BBHH", blob[2:])
    if version != STATUS_VERSION or state not in STATE_NAMES:
        return None
    return state, devices, warmed


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    # Preallocated buffer + recv_into: no quadratic re-copy of a large
    # window split into MTU-sized reads.
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("peer closed mid-message")
        got += r
    return bytes(buf)


def cuda_backend(items: List[Item]) -> List[bool]:
    """The batched verifier on the card: sharded over the local cards when
    there are several (``parallel.verify_many_auto``)."""
    from ..parallel import verify_many_auto

    return verify_many_auto(items)


def cpu_backend(items: List[Item]) -> List[bool]:
    """The RFC 8032 oracle, one item at a time."""
    from ..crypto import ref

    return [ref.verify(p, m, s) for p, m, s in items]


def native_backend(items: List[Item]) -> List[bool]:
    """The C++ core's verify pool on the host (``native.verify_batch``):
    raises, never answers from the oracle, when the library cannot be built
    or loaded."""
    from .. import native

    return native.verify_batch(items)


class _Pending:
    __slots__ = ("items", "event", "verdicts", "error")

    def __init__(self, items: List[Item]):
        self.items = items
        self.event = threading.Event()
        self.verdicts: Optional[List[bool]] = None
        self.error: Optional[Exception] = None


# Every replica of a cluster dials the service at its start; socketserver's
# backlog of 5 drops the dials of a larger cluster past pbftd's 250 ms
# connect deadline, and such a replica verifies on its own CPU pool.
_LISTEN_BACKLOG = 128


class VerifierService:
    """Threaded TCP (or unix-domain) batch-verification server."""

    # Largest merged window, in items: the top of the pad ladder
    # (crypto/batch.py _PAD_LADDER). Overflow stays queued for the next one.
    MAX_WINDOW = 4096

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        unix_path: Optional[str] = None,
        backend: Callable[[List[Item]], List[bool]] | str = "cuda",
        coalesce: bool = True,
        flush_us: int = 0,
        flush_items: int = 0,
        trace_path: Optional[str] = None,
        inflight: int = 1,
        metrics_port: Optional[int] = None,
        status_provider: Optional[Callable[[], Tuple[int, int, int]]] = None,
        status_json_provider: Optional[Callable[[], dict]] = None,
    ):
        backend_name = backend if isinstance(backend, str) else None
        if backend == "cuda":
            from ..device import resolve_device

            resolve_device(None)  # no card: raise here, not per request
        elif backend == "native":
            from .. import native

            native.lib()  # no library: raise here, not per request
        if isinstance(backend, str):
            backend = {"cuda": cuda_backend, "native": native_backend, "cpu": cpu_backend}[backend]
        self.backend = backend
        # A bare service has no warmup lifecycle, so its status is settled
        # here: "ready" for the card (it captures each shape at its first
        # use), "cpu-only" for everything else (test callables included).
        # The daemon (verify_service.py) overrides both providers with its
        # live state machine.
        state = STATE_READY if backend_name == "cuda" else STATE_CPU_ONLY
        self._status_provider = status_provider or (lambda: (state, 0, 0))
        self._status_json_provider = status_json_provider or (
            lambda: {
                "state": STATE_NAMES[self._status_provider()[0]],
                "devices": self._status_provider()[1],
                "backend": backend_name or "custom",
                "requests": self.requests,
                "launches": self.batches,
                "items": self.items,
                "rejected": self.rejected,
            }
        )
        # Bounded accumulation: after the first request queues, wait until
        # flush_items are pending (0 = MAX_WINDOW) or flush_us have passed.
        self._flush_s = flush_us / 1e6
        self._flush_target = flush_items or self.MAX_WINDOW
        # Overlapped launches: with inflight > 1 the dispatcher ships window
        # N+1 from another launch thread while N is still executing.
        self._inflight = max(1, inflight)
        self._inflight_sem = threading.Semaphore(self._inflight)
        self._launch_threads: List[threading.Thread] = []
        # Per-dispatch JSONL trace ({"ev":"verify_batch","size":merged,..}):
        # the merged window IS the launch.
        from ..utils.trace import Tracer

        self._tracer = Tracer(open(trace_path, "a") if trace_path else None)
        # Metrics: disabled unless a scrape surface was asked for. Updated
        # under self._cond (several launch threads finish at once with
        # inflight > 1).
        from ..utils.metrics import MetricsRegistry

        self.metrics_registry = MetricsRegistry(labels={"replica": "service"}, enabled=metrics_port is not None)
        if self.metrics_registry.enabled:
            self.metrics_registry.preregister("service.py")
        self._metrics_server = None
        self.metrics_listen_port = 0
        self.batches = 0  # backend calls (launch windows)
        self.requests = 0  # wire requests (>= batches when coalescing)
        self.items = 0
        # False verdicts of launched windows (pbft_verify_rejected_total).
        self.rejected = 0
        self._coalesce = coalesce
        self._cond = threading.Condition()
        self._pending: List[_Pending] = []
        self._running = True
        service = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                # The 1-byte-per-item verdict reply must not sit in a Nagle
                # stall. Unix sockets have no Nagle.
                if self.request.family == socket.AF_INET:
                    self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

            def handle(self):  # one connection, many batches
                sock = self.request
                try:
                    while True:
                        n = int.from_bytes(_recv_exact(sock, 4), "big")
                        if n == STATUS_PROBE:
                            sock.sendall(pack_status(*service._status_provider()))
                            continue
                        if n == STATUS_JSON_PROBE:
                            blob = json.dumps(service._status_json_provider()).encode()
                            sock.sendall(len(blob).to_bytes(4, "big") + blob)
                            continue
                        blob = _recv_exact(sock, n * 128)
                        items = [
                            (
                                blob[i * 128 : i * 128 + 32],
                                blob[i * 128 + 32 : i * 128 + 64],
                                blob[i * 128 + 64 : i * 128 + 128],
                            )
                            for i in range(n)
                        ]
                        verdicts = service._submit(items)
                        sock.sendall(bytes(1 if v else 0 for v in verdicts))
                except (ConnectionError, OSError):
                    return

        if unix_path is not None:

            class UnixServer(socketserver.ThreadingUnixStreamServer):
                daemon_threads = True
                request_queue_size = _LISTEN_BACKLOG

            self.server = UnixServer(unix_path, Handler)
            self.address = unix_path
        else:

            class TcpServer(socketserver.ThreadingTCPServer):
                daemon_threads = True
                allow_reuse_address = True
                request_queue_size = _LISTEN_BACKLOG

            self.server = TcpServer((host, port), Handler)
            self.address = "%s:%d" % self.server.server_address
        if metrics_port is not None:
            from ..utils.metrics import start_metrics_server

            try:
                self._metrics_server = start_metrics_server(
                    self.metrics_registry, metrics_port, status_fn=self._status_json_provider
                )
            except OSError:
                self.server.server_close()
                if self._tracer.sink is not None:
                    self._tracer.sink.close()
                raise
            self.metrics_listen_port = self._metrics_server.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._dispatcher: Optional[threading.Thread] = None
        if self._coalesce:
            # Started here (not in start()) so a bare serve_forever()
            # coalesces too.
            self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
            self._dispatcher.start()

    def _submit(self, items: List[Item]) -> List[bool]:
        """Handler-thread entry: verify `items`, possibly merged with other
        connections' concurrent submissions into one backend call."""
        if not self._coalesce:
            with self._cond:
                self.requests += 1
                self.batches += 1
                self.items += len(items)
            t0 = time.monotonic()
            verdicts = self._checked(self.backend, items)
            with self._cond:
                self.rejected += verdicts.count(False)
                if self.metrics_registry.enabled:
                    # Uncoalesced, every request is its own one-client window.
                    self._count_window(len(items), 1, time.monotonic() - t0, verdicts)
            return verdicts
        p = _Pending(items)
        with self._cond:
            self.requests += 1
            if not self._running:  # dispatcher gone: fail this connection
                raise ConnectionError("verifier service stopping")
            self._pending.append(p)
            self._cond.notify()
        # No fixed deadline, but a dead dispatcher must not strand the
        # connection.
        while not p.event.wait(timeout=1.0):
            if self._dispatcher is not None and not self._dispatcher.is_alive():
                raise ConnectionError("verifier dispatcher died")
        if p.error is not None:
            raise ConnectionError(f"verification failed: {p.error!r}")
        assert p.verdicts is not None
        return p.verdicts

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while self._running and not self._pending:
                    self._cond.wait(0.5)
                if not self._running and not self._pending:
                    return
                if self._flush_s > 0:
                    # Hold the window open until the item target or the
                    # deadline; _cond.wait releases the lock meanwhile.
                    deadline = time.monotonic() + self._flush_s
                    while (
                        self._running
                        and sum(len(p.items) for p in self._pending) < self._flush_target
                    ):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
                # Take whole requests up to MAX_WINDOW items (a single
                # oversized request still goes through, alone).
                window: List[_Pending] = []
                size = 0
                while self._pending:
                    nxt = len(self._pending[0].items)
                    if window and size + nxt > self.MAX_WINDOW:
                        break
                    size += nxt
                    window.append(self._pending.pop(0))
                if self.metrics_registry.enabled:  # items left queued past MAX_WINDOW
                    self.metrics_registry.gauge("pbft_verify_queue_depth").set(
                        sum(len(p.items) for p in self._pending)
                    )
            # The window is formed before a launch slot is free: requests
            # that queue while it waits go to the next window.
            self._inflight_sem.acquire()
            if self._inflight == 1:
                self._dispatch_guarded(window)
            else:
                t = threading.Thread(target=self._dispatch_guarded, args=(window,), daemon=True)
                with self._cond:  # stop() reads this list concurrently
                    self._launch_threads = [x for x in self._launch_threads if x.is_alive()]
                    self._launch_threads.append(t)
                t.start()

    def _dispatch_guarded(self, window: List[_Pending]) -> None:
        try:
            self._dispatch_window(window)
        except Exception as e:  # noqa: BLE001 - never strand a handler
            for p in window:
                if not p.event.is_set():
                    p.error = e
                    p.event.set()
        finally:
            self._inflight_sem.release()

    @staticmethod
    def _checked(backend, items: List[Item]) -> List[bool]:
        """Run the backend and validate the verdict count: a wrong-length
        result would otherwise mis-slice silently across connections."""
        verdicts = backend(items)
        if verdicts is None or len(verdicts) != len(items):
            got = "None" if verdicts is None else str(len(verdicts))
            raise ValueError(f"backend returned {got} verdicts for {len(items)} items")
        return verdicts

    def _count_window(self, size: int, clients: int, secs: float, verdicts: Optional[List[bool]]) -> None:
        """One launch window's metrics (the caller holds ``self._cond``); a
        failed merged window (``verdicts`` None) rejects nothing yet."""
        reg = self.metrics_registry
        reg.counter("pbft_verify_batches_total").inc()
        reg.counter("pbft_verify_items_total").inc(size)
        reg.histogram("pbft_verify_batch_size").observe(size)
        reg.histogram("pbft_verify_seconds").observe(secs)
        reg.counter("pbft_verify_service_launches_total").inc()
        reg.histogram("pbft_verify_service_window_size").observe(size)
        reg.histogram("pbft_verify_service_coalesced_clients").observe(clients)
        if verdicts is not None:
            reg.counter("pbft_verify_rejected_total").inc(verdicts.count(False))

    def _dispatch_window(self, window: List[_Pending]) -> None:
        merged: List[Item] = []
        for p in window:
            merged.extend(p.items)
        t0 = time.monotonic()
        try:
            verdicts = self._checked(self.backend, merged)
        except Exception:
            # One launch failing must not reject every client's honest
            # signatures: retry each request alone so only the poisoned
            # one errors out.
            verdicts = None
        if self._tracer.enabled:
            # A failed merged launch is NOT a verify_batch event: its size
            # is not items-per-launch.
            self._tracer.event(
                "verify_batch" if verdicts is not None else "verify_window_failed",
                replica="service",
                size=len(merged),
                requests=len(window),
                rejected=(verdicts.count(False) if verdicts is not None else -1),
                secs=round(time.monotonic() - t0, 6),
            )
        with self._cond:
            self.batches += 1
            self.items += len(merged)
            if verdicts is not None:
                self.rejected += verdicts.count(False)
            if self.metrics_registry.enabled:
                secs = time.monotonic() - t0
                self.metrics_registry.gauge("pbft_verify_inflight_age_seconds").set(round(secs, 6))
                self._count_window(len(merged), len(window), secs, verdicts)
        if verdicts is None:
            for p in window:
                t1 = time.monotonic()
                try:
                    p.verdicts = self._checked(self.backend, p.items)
                except Exception as e:  # noqa: BLE001 - handed to submitter
                    p.error = e
                if self._tracer.enabled:
                    if p.verdicts is not None:
                        self._tracer.event(
                            "verify_batch",
                            replica="service",
                            size=len(p.items),
                            requests=1,
                            rejected=p.verdicts.count(False),
                            secs=round(time.monotonic() - t1, 6),
                        )
                    else:
                        self._tracer.event(
                            "verify_batch_error",
                            replica="service",
                            size=len(p.items),
                            secs=round(time.monotonic() - t1, 6),
                        )
                p.event.set()
            return
        off = 0
        for p in window:
            p.verdicts = verdicts[off : off + len(p.items)]
            off += len(p.items)
            p.event.set()

    def start(self) -> "VerifierService":
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        # Flip _running BEFORE joining anything: handlers enqueueing after
        # this point get a ConnectionError; the dispatcher drains the queue.
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server.server_close()
        self.server.shutdown()
        self.server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        if self._dispatcher:
            self._dispatcher.join(timeout=5)
        with self._cond:
            launch_threads = list(self._launch_threads)
        for t in launch_threads:
            t.join(timeout=5)
        if self._tracer.sink is not None and (
            (self._dispatcher is None or not self._dispatcher.is_alive())
            and not any(t.is_alive() for t in launch_threads)
        ):
            # Close only once the dispatcher is provably done with it.
            self._tracer.sink.close()
            self._tracer = type(self._tracer)()  # disabled from here on


def main(argv: Optional[List[str]] = None) -> None:
    """CLI: a bare verifier service for a ``pbftd --verifier host:port``
    cluster (the card by default)."""
    import argparse

    parser = argparse.ArgumentParser(description="batch-verification service (no warmup lifecycle)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7600)
    parser.add_argument("--unix", default=None, help="unix socket path instead of TCP")
    parser.add_argument("--backend", default="cuda", choices=["cuda", "native", "cpu"])
    parser.add_argument(
        "--flush-us",
        type=int,
        default=0,
        help="bounded accumulation: hold each window up to this many microseconds (0 = dispatch at once)",
    )
    parser.add_argument("--flush-items", type=int, default=0, help="...or until this many items are pending (0 = MAX_WINDOW)")
    parser.add_argument("--trace", default=None, help="JSONL per-dispatch trace file")
    parser.add_argument(
        "--inflight", type=int, default=1, help="overlapped launches: ship window N+1 while N executes (1 = serial)"
    )
    parser.add_argument(
        "--metrics-port", type=int, default=None, help="serve Prometheus text format on this port (0 = ephemeral)"
    )
    args = parser.parse_args(argv)
    svc = VerifierService(
        host=args.host,
        port=args.port,
        unix_path=args.unix,
        backend=args.backend,
        flush_us=args.flush_us,
        flush_items=args.flush_items,
        trace_path=args.trace,
        inflight=args.inflight,
        metrics_port=args.metrics_port,
    )
    metrics = f" metrics=127.0.0.1:{svc.metrics_listen_port}" if args.metrics_port is not None else ""
    print(f"verifier service on {svc.address} backend={args.backend}{metrics}", flush=True)
    svc.server.serve_forever()


if __name__ == "__main__":  # pragma: no cover - CLI entry
    main()
