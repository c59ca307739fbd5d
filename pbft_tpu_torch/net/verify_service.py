"""The persistent verify service on the card: the port of
``pbft_tpu/net/verify_service.py`` (engine, daemon, status probes, the
replica-side client, CLI).

One long-lived process owns the H100: ``CudaVerifyEngine.warm()`` builds (or
loads) the kernel library and captures one CUDA graph per pad-ladder window
shape, shard and launch slot at startup, outside any request (the
counterpart of the JAX engine's AOT executables); then the daemon serves the
128-byte-triple protocol of ``service.py``, merging the traffic of every
colocated replica into one window per launch, each a replay.

Readiness handshake: a request with item count 0 returns an 8-byte status
record (state warming|ready|cpu-only, device count, warmed shape count);
count 0xFFFFFFFF returns a length-prefixed JSON status. ``core/verifier.cc``
RemoteVerifier, the JAX package's ServiceVerifier and this module's
:class:`ServiceVerifier` speak it unchanged. While the engine warms, the
daemon serves traffic from its fallback (``native.host_batch_verify``: the
C++ core's verify pool, built and loaded on a thread of its own from the
daemon's construction, or the oracle until it loads or where the core
cannot be built) and counts what it served in ``fallback_items``; the JSON
status says which (``host_verifier``). A failed warm is not hidden: the
daemon refuses traffic from then on (a client's request fails, and it
verifies locally), the JSON status reports the state ``failed`` and the
error (the 8-byte record, which has no such state, stays ``warming``, so
that a client keeps verifying locally), ``start(wait_ready=True)``
re-raises it, and the CLI ends with a nonzero exit. The ``cpu-only`` state
is reached only through ``backend="native"`` or ``backend="cpu"``, which
skip the engine.

Cards and the host<->device pipeline: the engine shards every window over a
mesh of the local cards (``parallel.compile_sharded``; ``--devices N`` keeps
the first N). Each shard of each slot has its own captured window: static
pinned host buffers, static device buffers, a graph memory pool and a CUDA
stream (``utils/graphs.py``). The daemon passes its ``inflight`` as the slot
count, so with ``inflight=2`` window N+1 stages and replays in its own slot
while window N computes.

Metrics (``metrics_port``): the service's series (``service.py``) and the
daemon's (``verify_service.py``: the cold and warm compile gauges, set after
a successful warm), on ``/metrics``, and the JSON status on ``/status``.

Restarts: the kernel libraries are cached by a hash of their sources, the
arch and nvcc, under ``build/pbft_tpu_torch/`` by default or, with
``--cache-dir DIR`` (the JAX daemon's flag), under
``host_keyed_cache_dir(DIR)`` (``utils/cache.py``), so a restart on the
same host compiles nothing (``warm_stats`` ``build_compiled`` is empty) and
a cache from another host is never read. The JSON status reports the
kernels' launch counts in this process (``kernel_launches``).

Deliberate differences from the JAX daemon: no ``auto`` backend, which
would flip to ``cpu-only`` when the card fails (a failed warm is raised);
no ``--export-dir``: CUDA graphs cannot be serialized, so every start
captures its graphs anew (``cold_compile_s``).

CLI: ``python -m pbft_tpu_torch.net.verify_service --port 7600 [--devices N]
[--device cpu] [--backend cuda|native|cpu] [--metrics-port N]
[--cache-dir DIR]``.
"""

from __future__ import annotations

import json
import socket
import sys
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from .service import (  # noqa: F401 - re-exported API
    Item,
    STATE_CPU_ONLY,
    STATE_NAMES,
    STATE_READY,
    STATE_WARMING,
    STATUS_JSON_PROBE,
    STATUS_LEN,
    STATUS_MAGIC,
    STATUS_PROBE,
    STATUS_VERSION,
    VerifierService,
    _recv_exact,
    cpu_backend,
    native_backend,
    pack_status,
    unpack_status,
)

# -- the card-owning engine --------------------------------------------------


class CudaVerifyEngine:
    """Owns the cards: the kernel library, one mesh over the local cards and
    one compiled sharded window per window shape. The duck type of the JAX
    package's ShardedVerifyEngine: ``warm()``, ``verify(items)``,
    ``device_count``, ``warmed_sizes``, ``stats``.

    ``devices`` is the number of shards: the first N local cards (default:
    all of them) when ``device`` is None, else N shards on ``device`` (``"cpu"``
    runs the plain path; default 1). ``slots`` is the number of windows of
    one shape that may run at once (the daemon passes its ``inflight``).
    ``kernel`` replaces ``ed25519.verify_kernel`` ((B,32),(B,32),(B,64)
    uint8 tensors -> (B,) bool tensor); tests pass a cheap stand-in.
    ``cache_dir`` roots the kernel build (``kernels.build_root``).
    Devices are resolved at ``warm()``."""

    def __init__(
        self,
        shapes: Optional[Sequence[int]] = None,
        device=None,
        kernel=None,
        devices: Optional[int] = None,
        slots: int = 1,
        cache_dir: Optional[str] = None,
    ):
        if shapes is None:
            from ..crypto.batch import _PAD_LADDER

            shapes = _PAD_LADDER
        self._want_shapes = tuple(sorted(set(shapes)))
        self._want_device = device
        self._want_devices = devices
        self._slots = max(1, slots)
        self._kernel = kernel
        self.cache_dir = cache_dir
        self._lock = threading.Lock()
        self._fns: dict = {}  # padded window size -> compiled sharded window
        self.device_count = 0
        self.stats: dict = {}

    # -- startup -------------------------------------------------------------

    def _make_mesh(self):
        from ..parallel import make_mesh

        if self._want_device is None:
            return make_mesh(n_devices=self._want_devices)
        return make_mesh(devices=[self._want_device] * (self._want_devices or 1))

    def warm(self) -> dict:
        """Build the mesh, build or load the kernels, and compile every
        window shape, rounded up to a multiple of the mesh size: one captured
        window per shard and slot, and one all-pad window through it, which
        must verify True. A capture that fails raises. Raises without CUDA
        when ``device`` is None, and when more cards are asked for than exist.

        Returns (and stores in ``self.stats``) the warmup accounting in the
        JAX engine's keys: ``compiled`` counts the graphs captured here
        (shapes x shards x slots), ``aot_loaded`` is 0 (a CUDA graph cannot
        be serialized), ``cold_compile_s`` is the whole warmup (kernel
        build, priming runs, captures and instantiations included),
        ``build_s`` the build or load of the kernel library alone,
        ``build_compiled`` the libraries nvcc compiled for it (none when
        the build directory, ``build_dir``, held them), ``slots``
        the slots per shape, ``compile_s_by_shape`` each shape's priming
        runs, captures, instantiations and all-pad window, and
        ``graph_pool_bytes`` (``_by_shape``) the device memory each shape's
        graphs hold: their pools and static buffers
        (``torch.cuda.memory_reserved`` after the shape minus before, over
        the mesh's cards, with unheld cached blocks freed first)."""
        import torch

        from ..crypto import kernels
        from ..parallel import compile_sharded

        t0 = time.perf_counter()
        mesh = self._make_mesh()
        dev = mesh.devices[0]
        cards = sorted({d for d in mesh.devices if d.type == "cuda"}, key=str)

        def reserved() -> int:
            # Cached blocks that nothing holds (an eager run's) are freed
            # first, so that the difference is what the new graphs hold.
            if cards:
                torch.cuda.empty_cache()
            return sum(torch.cuda.memory_reserved(d) for d in cards)

        with self._lock:
            stats = {
                "devices": mesh.size,
                "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "shards": [str(d) for d in mesh.devices],
                "shapes": [],
                "aot_loaded": 0,
                "compiled": 0,
                "warm_load_s": 0.0,
                "cold_compile_s": 0.0,
                "build_s": 0.0,
                "build_compiled": [],
                "build_dir": None,
                "slots": self._slots,
                "graph_pool_bytes": 0,
                "compile_s_by_shape": {},
                "graph_pool_bytes_by_shape": {},
            }
            if dev.type == "cuda" and self._kernel is None:
                info = kernels.build(self.cache_dir)
                stats["build_s"] = round(info["build_s"], 3)
                stats["build_compiled"] = list(info["compiled"])
                stats["build_dir"] = info["dir"]
            fns = {}
            for want in self._want_shapes:
                size = -(-want // mesh.size) * mesh.size
                if size not in fns:
                    t1, before = time.perf_counter(), reserved()
                    fns[size] = compile_sharded(mesh, size, kernel=self._kernel, slots=self._slots)
                    stats["compile_s_by_shape"][size] = round(time.perf_counter() - t1, 3)
                    stats["graph_pool_bytes_by_shape"][size] = reserved() - before
                    stats["compiled"] += self._slots * len(mesh.devices)
                    stats["shapes"].append(size)
            stats["cold_compile_s"] = round(time.perf_counter() - t0, 3)
            stats["graph_pool_bytes"] = sum(stats["graph_pool_bytes_by_shape"].values())
            self._fns = fns
            self.device_count = mesh.size
            self.stats = stats
        return stats

    @property
    def warmed_sizes(self) -> Tuple[int, ...]:
        return tuple(sorted(self._fns))

    # -- serving -------------------------------------------------------------

    def verify(self, items: List[Item]) -> List[bool]:
        """Pad to a warmed window shape and replay it over the mesh in a free
        slot: each shard stages its rows through its window's pinned buffers
        and replays its graph on its own stream; the verdicts come back in
        order. Oversized batches chunk into top-of-ladder windows; no shape
        is captured at serving time."""
        if not items:
            return []
        if not self._fns:
            raise RuntimeError("engine not warmed")
        from ..crypto.batch import pad_batch

        sizes = self.warmed_sizes
        out: List[bool] = []
        for off in range(0, len(items), sizes[-1]):
            chunk = items[off : off + sizes[-1]]
            size = min(s for s in sizes if s >= len(chunk))
            pubs, msgs, sigs, n = pad_batch(chunk, size)
            verdicts = self._fns[size](pubs, msgs, sigs).cpu().numpy()
            out.extend(bool(v) for v in verdicts[:n])
        return out


# -- the daemon --------------------------------------------------------------


class VerifyServiceDaemon:
    """A :class:`~pbft_tpu_torch.net.service.VerifierService` that owns its
    card's lifecycle: starts in ``warming`` (traffic served by the fallback,
    by default ``native.host_batch_verify``), warms the
    :class:`CudaVerifyEngine` on a background thread, and flips to
    ``ready``. ``backend="native"`` (the C++ verify pool; raises here when
    it cannot be built or loaded) and ``backend="cpu"`` (the oracle) skip
    the engine and serve from the host (state ``cpu-only``)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        unix_path: Optional[str] = None,
        backend: str = "cuda",
        device=None,
        devices: Optional[int] = None,
        warm_shapes: Optional[Sequence[int]] = None,
        max_window: Optional[int] = None,
        flush_us: int = 0,
        flush_items: int = 0,
        inflight: int = 2,
        trace_path: Optional[str] = None,
        metrics_port: Optional[int] = None,
        engine: Optional[CudaVerifyEngine] = None,
        fallback: Optional[Callable[[List[Item]], List[bool]]] = None,
        cache_dir: Optional[str] = None,
    ):
        if backend not in ("cuda", "native", "cpu"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self._t0 = time.monotonic()
        self._state = STATE_WARMING
        self._state_lock = threading.Lock()
        self.warm_error: Optional[BaseException] = None
        self._warm_thread: Optional[threading.Thread] = None
        self.engine = engine
        if engine is None and backend == "cuda":
            self.engine = CudaVerifyEngine(
                shapes=warm_shapes, device=device, devices=devices, slots=inflight, cache_dir=cache_dir
            )
        if fallback is None:
            if backend == "native":
                from .. import native

                native.lib()  # no library: raise here, not per request
                fallback = native_backend
            elif backend == "cpu":
                fallback = cpu_backend
            else:
                from .. import native

                fallback = native.host_batch_verify
                native.load_in_background()
        self._fallback = fallback
        self.fallback_items = 0
        self.service = VerifierService(
            host=host,
            port=port,
            unix_path=unix_path,
            backend=self._dispatch,
            flush_us=flush_us,
            flush_items=flush_items,
            trace_path=trace_path,
            inflight=inflight,
            metrics_port=metrics_port,
            status_provider=self._status,
            status_json_provider=self.status_json,
        )
        if max_window:
            self.service.MAX_WINDOW = max_window
        if self.service.metrics_registry.enabled:
            # The compile gauges exist from the first scrape.
            self.service.metrics_registry.preregister("verify_service.py")

    # -- state machine -------------------------------------------------------

    @property
    def state(self) -> int:
        with self._state_lock:
            return self._state

    @property
    def state_name(self) -> str:
        return STATE_NAMES[self.state]

    @property
    def address(self) -> str:
        return self.service.address

    def _set_state(self, state: int) -> None:
        with self._state_lock:
            self._state = state

    def _status(self) -> Tuple[int, int, int]:
        eng = self.engine
        return (
            self.state,
            eng.device_count if eng else 0,
            len(eng.warmed_sizes) if eng else 0,
        )

    def _host_verifier(self) -> str:
        """What the fallback answers with: ``native``, ``oracle``, or
        ``custom`` for a caller's callable."""
        from .. import native

        if self._fallback is native.host_batch_verify:
            return native.host_verifier()
        return {native_backend: "native", cpu_backend: "oracle"}.get(self._fallback, "custom")

    def status_json(self) -> dict:
        eng = self.engine
        out = {
            "state": "failed" if self.warm_error is not None else self.state_name,
            "devices": eng.device_count if eng else 0,
            "warmed_shapes": list(eng.warmed_sizes) if eng else [],
            "backend": self.backend,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "requests": self.service.requests,
            "launches": self.service.batches,
            "items": self.service.items,
            "rejected": self.service.rejected,
            "fallback_items": self.fallback_items,
            "host_verifier": self._host_verifier(),
        }
        if eng and eng.stats:
            out["warm_stats"] = eng.stats
        if self.backend == "cuda":
            from ..crypto import kernels

            out["kernel_launches"] = dict(kernels.LAUNCHES)
        if self.warm_error is not None:
            out["warm_error"] = f"{type(self.warm_error).__name__}: {self.warm_error}"
        return out

    # -- serving -------------------------------------------------------------

    def _dispatch(self, items: List[Item]) -> List[bool]:
        """The service backend: the warmed engine when ready; the fallback
        while warming (a request never waits on warmup), counted in
        ``fallback_items``; the host backend when cpu-only. Raises once the
        warm has failed: a dead card is never served as a slow warm."""
        with self._state_lock:
            state, error = self._state, self.warm_error
            if state == STATE_WARMING and error is None:
                self.fallback_items += len(items)
        if state == STATE_READY:
            return self.engine.verify(items)
        if error is not None:
            raise RuntimeError(f"verify engine failed to warm: {error!r}")
        return self._fallback(items)

    def _warm(self) -> None:
        try:
            # An engine that is already warm (one shared by daemons that
            # run one after another) serves as it is.
            stats = self.engine.stats if self.engine.warmed_sizes else self.engine.warm()
        except Exception as e:  # noqa: BLE001 - reported, never hidden
            with self._state_lock:
                self.warm_error = e
            return
        reg = self.service.metrics_registry
        if reg.enabled:
            reg.gauge("pbft_verify_service_cold_compile_seconds").set(stats["cold_compile_s"])
            reg.gauge("pbft_verify_service_warm_compile_seconds").set(stats["warm_load_s"])
        self._set_state(STATE_READY)

    def start(self, wait_ready: bool = False, timeout: float = 900.0):
        """Serve at once; warm in the background. With ``wait_ready``, block
        until warm and raise if the warm failed or did not finish."""
        self.service.start()
        if self.engine is None:
            self._set_state(STATE_CPU_ONLY)
            return self
        self._warm_thread = threading.Thread(target=self._warm, daemon=True)
        self._warm_thread.start()
        if wait_ready:
            self._warm_thread.join(timeout)
            if self.warm_error is not None:
                raise RuntimeError(f"verify engine failed to warm: {self.warm_error!r}") from self.warm_error
            if self.state != STATE_READY:
                raise TimeoutError(f"verify engine not warm after {timeout} s")
        return self

    def stop(self) -> None:
        self.service.stop()


# -- status probes and the replica-side client --------------------------------


def _dial(target: str, timeout: float) -> socket.socket:
    if target.startswith("/"):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(target)
        return sock
    host, port = target.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    # A 4-byte verify header must not sit in a Nagle stall.
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def probe_status(target: str, timeout: float = 0.5) -> Optional[Tuple[int, int, int]]:
    """One short-deadline status probe: (state, devices, warmed) or None
    when the service is unreachable."""
    try:
        with _dial(target, timeout) as sock:
            sock.sendall(STATUS_PROBE.to_bytes(4, "big"))
            return unpack_status(_recv_exact(sock, STATUS_LEN))
    except (OSError, ConnectionError, ValueError):
        return None


def probe_status_json(target: str, timeout: float = 2.0) -> Optional[dict]:
    """The JSON status (state, devices, warm stats …), or None."""
    try:
        with _dial(target, timeout) as sock:
            sock.sendall(STATUS_JSON_PROBE.to_bytes(4, "big"))
            n = int.from_bytes(_recv_exact(sock, 4), "big")
            if n > 1 << 20:
                return None
            return json.loads(_recv_exact(sock, n).decode())
    except (OSError, ConnectionError, ValueError):
        return None


class ServiceVerifier:
    """The replica-side client of the daemon (the counterpart of
    ``core/verifier.cc`` RemoteVerifier, and of the JAX package's
    ServiceVerifier): dial the colocated verify service with a short connect
    deadline, consume the readiness handshake, and ship (pub, digest, sig)
    batches over the 128-byte protocol. Any failure (connect refused, the
    service warming, the link killed mid-stream, a short reply) verifies
    that batch with ``fallback`` (by default ``native.host_batch_verify``)
    and backs off reconnecting for ``retry_s``, so the replica's verify loop
    never stalls on the service's lifecycle. ``used_fallback`` counts the
    batches the fallback verified; ``verify_batch`` never raises on the
    service's account."""

    def __init__(
        self,
        target: str,
        fallback: Optional[Callable[[List[Item]], List[bool]]] = None,
        connect_timeout: float = 0.25,
        io_timeout: float = 30.0,
        retry_s: float = 1.0,
    ):
        self.target = target
        if fallback is None:
            from .. import native

            fallback = native.host_batch_verify
            native.load_in_background()
        self._fallback = fallback
        self._connect_timeout = connect_timeout
        self._io_timeout = io_timeout
        self._retry_s = retry_s
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._retry_after = 0.0
        self.state: Optional[int] = None
        self.devices = 0
        self.used_fallback = 0

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self.state = None
        self._retry_after = time.monotonic() + self._retry_s

    def _probe(self, sock: socket.socket) -> Optional[Tuple[int, int, int]]:
        try:
            sock.sendall(STATUS_PROBE.to_bytes(4, "big"))
            return unpack_status(_recv_exact(sock, STATUS_LEN))
        except (OSError, ConnectionError):
            return None

    def _ensure_connected(self) -> bool:
        """Whether the service takes this batch; (re)connects and re-probes
        a warming service at the retry cadence. Ready and cpu-only links are
        settled."""
        if self._sock is not None:
            if self.state != STATE_WARMING:
                return self.state in (STATE_READY, STATE_CPU_ONLY)
            if time.monotonic() < self._retry_after:
                return False
            self._retry_after = time.monotonic() + self._retry_s
            st = self._probe(self._sock)
            if st is None:
                self._drop()
                return False
            self.state, self.devices, _ = st
            return self.state in (STATE_READY, STATE_CPU_ONLY)
        if time.monotonic() < self._retry_after:
            return False
        try:
            sock = _dial(self.target, self._connect_timeout)
        except OSError:
            self._retry_after = time.monotonic() + self._retry_s
            return False
        sock.settimeout(self._io_timeout)
        st = self._probe(sock)
        if st is None:
            sock.close()
            self._retry_after = time.monotonic() + self._retry_s
            return False
        self._sock = sock
        self.state, self.devices, _ = st
        # Warming: keep the link (the handshake was answered) but verify
        # locally until a later probe reports ready.
        return self.state in (STATE_READY, STATE_CPU_ONLY)

    def verify_batch(self, items: List[Item]) -> List[bool]:
        if not items:
            return []
        with self._lock:
            if not self._ensure_connected():
                self.used_fallback += 1
                return self._fallback(items)
            try:
                payload = b"".join(p + m + s for p, m, s in items)
                self._sock.sendall(len(items).to_bytes(4, "big") + payload)
                out = _recv_exact(self._sock, len(items))
                return [bool(b) for b in out]
            except (OSError, ConnectionError):
                # Killed mid-stream: drop the link (partial verdict bytes
                # must never pair with the next batch) and verify this batch
                # locally.
                self._drop()
                self.used_fallback += 1
                return self._fallback(items)

    __call__ = verify_batch

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


def main(argv: Optional[List[str]] = None) -> int:
    """The verify service CLI for a ``pbftd --verifier host:port`` cluster."""
    import argparse

    parser = argparse.ArgumentParser(description="verify service daemon on the card")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7600)
    parser.add_argument("--unix", default=None, help="unix socket path instead of TCP")
    parser.add_argument(
        "--backend",
        default="cuda",
        choices=["cuda", "native", "cpu"],
        help="cuda warms the engine (the native verify pool serves while it "
        "warms); native serves the C++ verify pool only, cpu the oracle only "
        "(state cpu-only)",
    )
    parser.add_argument(
        "--device",
        default=None,
        help="engine device (default: the card; 'cpu' runs the plain path)",
    )
    parser.add_argument(
        "--devices",
        type=int,
        default=None,
        help="shard windows over this many local cards (default: all); with "
        "--device, this many shards on that device",
    )
    parser.add_argument(
        "--warm-shapes",
        default=None,
        help="comma-separated window sizes to warm (default: the pad "
        "ladder 16,64,256,1024,4096)",
    )
    parser.add_argument("--window", type=int, default=None, help="largest merged window in items")
    parser.add_argument("--flush-us", type=int, default=0)
    parser.add_argument("--flush-items", type=int, default=0)
    parser.add_argument(
        "--inflight",
        type=int,
        default=2,
        help="overlapped launches; 2 = stage window N+1 while N computes",
    )
    parser.add_argument("--trace", default=None, help="JSONL per-dispatch trace file")
    parser.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        help="serve Prometheus text on /metrics and the JSON status on /status at this port (0 = ephemeral)",
    )
    parser.add_argument("--wait-ready", action="store_true", help="block until warm before announcing")
    parser.add_argument(
        "--cache-dir",
        default=None,
        help="root the kernel build at host_keyed_cache_dir(DIR) (default: build/pbft_tpu_torch/ in the repo)",
    )
    args = parser.parse_args(argv)
    shapes = [int(s) for s in args.warm_shapes.split(",") if s] if args.warm_shapes else None
    daemon = VerifyServiceDaemon(
        host=args.host,
        port=args.port,
        unix_path=args.unix,
        backend=args.backend,
        device=args.device,
        devices=args.devices,
        warm_shapes=shapes,
        max_window=args.window,
        flush_us=args.flush_us,
        flush_items=args.flush_items,
        inflight=args.inflight,
        trace_path=args.trace,
        metrics_port=args.metrics_port,
        cache_dir=args.cache_dir,
    )
    try:
        daemon.start(wait_ready=args.wait_ready)
    except (RuntimeError, TimeoutError) as e:
        print(json.dumps({"ev": "verify_service_failed", "error": str(e)}), flush=True)
        daemon.stop()
        return 1
    listening = {"ev": "verify_service_listening", "addr": daemon.address}
    if args.metrics_port is not None:
        listening["metrics_port"] = daemon.service.metrics_listen_port
    print(json.dumps({**listening, **daemon.status_json()}), flush=True)
    try:
        state = daemon.state
        while daemon.warm_error is None:
            time.sleep(0.25)
            if daemon.state != state:
                state = daemon.state
                print(json.dumps(daemon.status_json()), flush=True)
        print(json.dumps({"ev": "verify_service_failed", **daemon.status_json()}), flush=True)
        return 1
    except KeyboardInterrupt:  # pragma: no cover - operator stop
        return 0
    finally:
        daemon.stop()


if __name__ == "__main__":  # pragma: no cover - CLI entry
    sys.exit(main())
