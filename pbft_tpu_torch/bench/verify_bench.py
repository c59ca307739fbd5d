"""Benchmark: Ed25519 signature verifications per second, on one host with
its card: the port's counterpart of the repository's root ``bench.py``.

    python -m pbft_tpu_torch.bench                  # the service arm (default)
    python -m pbft_tpu_torch.bench --cuda-worker    # in-process, on the card
    PBFT_BENCH_NATIVE=1 python -m pbft_tpu_torch.bench
    PBFT_BENCH_CONSENSUS=1 python -m pbft_tpu_torch.bench
    PBFT_BENCH_CPU=1 python -m pbft_tpu_torch.bench

Every arm prints ONE JSON line, the last line of its standard output, with
``bench.py``'s keys: ``metric`` (``ed25519_sig_verifies_per_sec``),
``value``, ``unit``, ``vs_baseline`` (value / 50,000, BASELINE.json's
target), ``backend`` and the arm's extras; a failure prints the same line
with ``value`` 0.0 and an ``error`` ("stage: reason"; an exception that no
stage names is ``unexpected``, its traceback on standard error) and exits
1. Logs go to standard error. The lines of the arms that run on the card also carry
the card's name and power limit (``card``, ``power_limit``, as
``nvidia-smi --query-gpu=name,power.limit`` gives them).

The arms, in the order ``main`` picks them:

- ``--cuda-worker`` (backend ``cuda``; ``bench.py --tpu-worker``): the card
  from ``device.resolve_device(None)``, never the CPU in its place. The
  kernels are built from this checkout's sources into
  ``host_keyed_cache_dir(build/cache)`` (``utils/cache.py``; ``bench.py``
  keeps its JAX cache under ``.jax_cache`` the same way). First call:
  ``batch.verify_many`` on the pool (``PBFT_BENCH_BATCH``, default 4,096),
  whose bitmap must be every row but ``batch // 2``. Then the chain, the
  counterpart of ``bench.py``'s ``lax.scan`` over ``verify_kernel``: the
  pool is put on the card once, and ``PBFT_BENCH_CHAIN`` (default 16)
  applications of ``ed25519.verify_kernel`` are captured in ONE CUDA graph,
  each adding its verdicts into an int32 ``acc`` that the graph allocates in
  its own pool and zeroes. A replay runs every captured node, so nothing is
  hoisted out of the chain or folded, and the graph needs no counterpart of
  ``lax.optimization_barrier``. ``acc`` must equal chain x the bitmap on
  every row before the timed region and after every timed call. The timed
  region replays, synchronizes the card and copies ``acc`` to the host on
  every call (no call can be served from a cached result) until
  ``PBFT_BENCH_SECS`` (default 5); value = chains x chain x batch / elapsed.
  The line carries ``batch``, ``chain``, ``chains``, ``capture_s`` (the
  chain's capture and instantiation), ``first_batch_s``, ``window_ms``
  (elapsed / (chains x chain): the replay mode a run met shows here) and
  ``launches``, each kernel's launches in the timed region
  (``crypto/kernels.py`` counters), which equal ``applications`` = chains x
  chain.
- ``PBFT_BENCH_NATIVE`` (backend ``cpu-native``): the native C++ verify pool
  (``pbft_tpu_torch.native``) on the same pool: one thread, then
  ``PBFT_VERIFY_THREADS`` (default 0 = the hardware's), the pooled verdicts
  held to the serial ones; ``threads``, ``single_thread_per_sec``,
  ``pooled_per_sec``, ``pool_speedup``.
- ``PBFT_BENCH_CONSENSUS`` (metric ``pbft_requests_per_sec``, backend
  ``consensus-native``): the f = 1 firehose (config 1) as ``pbftd`` replicas
  on their own verify pools, ``bench.harness.run_native_config``, with
  ``PBFT_BENCH_REQUESTS`` (960), ``PBFT_BENCH_PIPELINE`` (64),
  ``PBFT_BATCH_MAX_ITEMS`` (1) and ``PBFT_BATCH_FLUSH_US`` (0); the line
  carries the latency waterfall (``segments_ms``) and the requests driven
  (``requests``: the line is printed only when every one committed). The
  host's control arm.
- ``PBFT_BENCH_CPU`` without ``PBFT_VERIFY_SERVICE`` (backend ``cpu``): the
  chained code of the card's arm with ``device="cpu"``, where the kernels run
  their plain versions (the chain is then a loop, not a graph). Asked for by
  name only.
- the service arm (the default; backend ``verify-service``): probe
  ``PBFT_VERIFY_SERVICE`` (default ``127.0.0.1:7600``) with
  ``probe_status_json``. With no answer and a card present
  (``torch.cuda.is_available()``), or with ``PBFT_BENCH_LAUNCH_SERVICE=1``,
  spawn ``python -m pbft_tpu_torch.net.verify_service --backend cuda`` on a
  free port (its standard output to /dev/null) and wait for ``ready`` under
  ``PBFT_SERVICE_WARM_BUDGET_S`` (900), outside the timed region; a service
  found warming is waited for the same way. Then ``PBFT_BENCH_SERVICE_CONNS``
  (4) connections of ``PBFT_BENCH_BATCH`` (1,024) triples each make one
  untimed round trip (bitmap checked) and are timed for ``PBFT_BENCH_SECS``.
  The line has ``bench.py``'s extras (``devices``, ``service_state``,
  ``connections``, ``batch``, ``warm_start_s``, ``steady_state_per_sec``,
  ``service_cold_compile_s``, ``service_warm_load_s``, ``cold_start_s`` when
  spawned here) and the port's ``graph_pool_bytes``, the service's windows
  and items over this run (``service_windows``, ``service_items``), its
  kernel launches over this run where it reports them (``kernel_launches``)
  and ``service_pid`` when spawned here. A spawned service is stopped
  before the line is printed. A service that is ``ready``, or ``cpu-only``
  because it was started with ``--backend native`` or ``cpu``, is driven as
  it is; ``service_state`` says which.

The pool (``_signed_pool``) is ``bench.py``'s: 64 signers with seeds
``bytes([i + 1, 0x42]) * 16`` and 32-byte random messages, tiled to the
batch, ``sigs[batch // 2, 7] ^= 0xFF``, signed by the native signer (the
port's oracle where the core cannot be built). The one change: the
messages come from ``np.random.default_rng(PBFT_BENCH_SEED)`` (default 0)
rather than ``os.urandom``, so that a run can be repeated.

Deliberate differences from ``bench.py`` (three silent fallbacks dropped):

- a spawned service whose warm fails (state ``failed``, or the process
  exits) ends the run with ``service-warm`` and its error; ``bench.py``
  measures its native arm instead;
- with no card, no service and no arm named, the run ends with
  ``backend-init``; ``bench.py`` measures its native arm and tags it
  ``cpu-native-fallback``;
- there is no XLA:CPU last resort, no note that points at a file under
  ``benchmarks/`` (the port reads nothing there), no backend init watchdog
  (``PBFT_BENCH_INIT_TIMEOUT``: no tunnel can hang ``torch.cuda``) and no
  TPU probe.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np

REPO = Path(__file__).resolve().parents[2]
CACHE_DIR = REPO / "build" / "cache"  # kernels under host_keyed_cache_dir(CACHE_DIR)
METRIC = "ed25519_sig_verifies_per_sec"
BASELINE_PER_SEC = 50_000.0
POOL = 64  # distinct signed triples, tiled to the batch


class BenchFailed(Exception):
    """A stage failed: ``main`` prints the failure line and exits 1."""

    def __init__(self, stage: str, err: str):
        super().__init__(f"{stage}: {err}")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _emit(per_sec: float, backend: str, extra: Optional[dict] = None) -> None:
    result = {
        "metric": METRIC,
        "value": round(per_sec, 1),
        "unit": "signatures/sec",
        "vs_baseline": round(per_sec / BASELINE_PER_SEC, 3),
        "backend": backend,
    }
    result.update(extra or {})
    print(json.dumps(result), flush=True)


def _fail(stage: str, err: str):
    raise BenchFailed(stage, err)


def _card() -> dict:
    """The card's name and power limit, as nvidia-smi gives them."""
    from ..scripts.gpu_evidence import card_info

    info = card_info()
    return {"card": info["device"], "power_limit": info["power_limit"]}


def _native_mod():
    """The native C++ core module, or None where it cannot be built."""
    from .. import native

    return native if native.available() else None


def _signed_pool(batch: int, rng):
    """(pubs, msgs, sigs) uint8 arrays: ``bench.py``'s 64-triple signed
    pool tiled to the batch, with sigs[batch // 2] corrupted. The messages
    are ``rng.bytes(32)`` each, in signer order (``bench.py`` draws them
    from ``os.urandom``); the native signer signs where it can be built."""
    pubs = np.zeros((POOL, 32), np.uint8)
    msgs = np.zeros((POOL, 32), np.uint8)
    sigs = np.zeros((POOL, 64), np.uint8)
    native = _native_mod()
    if native is not None:
        signer_pub, signer_sign = native.public_key, native.sign
        _log("signer: native C++ core")
    else:
        from ..crypto import ref

        signer_pub, signer_sign = ref.public_key, ref.sign
        _log("signer: Python oracle")
    for i in range(POOL):
        seed = bytes([i + 1, 0x42]) * 16
        msg = rng.bytes(32)
        pubs[i] = np.frombuffer(signer_pub(seed), np.uint8)
        msgs[i] = np.frombuffer(msg, np.uint8)
        sigs[i] = np.frombuffer(signer_sign(seed, msg), np.uint8)
    reps = (batch + POOL - 1) // POOL
    bp = np.tile(pubs, (reps, 1))[:batch]
    bm = np.tile(msgs, (reps, 1))[:batch]
    bs = np.tile(sigs, (reps, 1))[:batch]
    bs[batch // 2, 7] ^= 0xFF
    return bp, bm, bs


def _pool(batch: int):
    return _signed_pool(batch, np.random.default_rng(_env_int("PBFT_BENCH_SEED", 0)))


def _items(bp, bm, bs) -> list:
    return [(bytes(p), bytes(m), bytes(s)) for p, m, s in zip(bp, bm, bs)]


def _bitmap_ok(out, batch: int) -> bool:
    """Every row valid but the corrupted one at ``batch // 2``."""
    return sum(bool(v) for v in out) == batch - 1 and not out[batch // 2]


# -- the native arm -------------------------------------------------------------


def _native_rate(native, items, target_secs: float) -> float:
    """Sustained verifies/sec over repeated full-batch calls."""
    done, elapsed = 0, 0.0
    t0 = time.perf_counter()
    while elapsed < target_secs or done == 0:
        native.verify_batch(items)
        done += len(items)
        elapsed = time.perf_counter() - t0
    return done / elapsed


def run_native(target_secs: float) -> None:
    """The native C++ verify pool, one thread and then pooled, on the pool
    (``PBFT_BENCH_BATCH``, default 4,096)."""
    native = _native_mod()
    if native is None:
        _fail("native", "native core unavailable")
    batch = _env_int("PBFT_BENCH_BATCH", 4096)
    items = _items(*_pool(batch))
    out = native.verify_batch(items)
    if not _bitmap_ok(out, batch):
        _fail("native-verdicts", f"wrong bitmap: sum={sum(out)}")
    native.set_verify_threads(1)
    single = _native_rate(native, items, max(1.0, target_secs / 2))
    _log(f"native CPU arm (1 thread): {single:.0f} verifies/sec")
    native.set_verify_threads(_env_int("PBFT_VERIFY_THREADS", 0))  # 0 = hardware concurrency
    threads = native.verify_threads()
    if threads > 1:
        if native.verify_batch(items) != out:
            _fail("native-verdicts", "pooled verdicts diverge from serial")
        pooled = _native_rate(native, items, target_secs)
    else:
        pooled = single
    _log(f"native CPU arm: {pooled:.0f} verifies/sec pooled ({threads} threads; {pooled / single:.2f}x single-thread)")
    _emit(pooled, "cpu-native", {
        "threads": threads,
        "single_thread_per_sec": round(single, 1),
        "pooled_per_sec": round(pooled, 1),
        "pool_speedup": round(pooled / single, 2),
    })


# -- the consensus arm -----------------------------------------------------------


def run_consensus() -> None:
    """The f = 1 firehose through real ``pbftd`` replicas on their own verify
    pools: requests/s with its latency waterfall."""
    import tempfile

    from .harness import run_native_config

    with tempfile.TemporaryDirectory(prefix="pbft-bench-traces-") as td:
        res = run_native_config(
            1,  # firehose f = 1
            requests=_env_int("PBFT_BENCH_REQUESTS", 960),
            pipeline=_env_int("PBFT_BENCH_PIPELINE", 64),
            batch_max_items=_env_int("PBFT_BATCH_MAX_ITEMS", 1),
            batch_flush_us=_env_int("PBFT_BATCH_FLUSH_US", 0),
            trace_dir=td,
        )
    print(json.dumps({
        "metric": "pbft_requests_per_sec",
        "value": res.requests_per_sec,
        "unit": "requests/sec",
        "rounds_per_sec": res.rounds_per_sec,
        "mean_batch": res.mean_batch,
        "batch_max_items": res.batch_max_items,
        "batch_flush_us": res.batch_flush_us,
        "reply_p50_ms": res.reply_p50_ms,
        "reply_p95_ms": res.reply_p95_ms,
        "reply_p99_ms": res.reply_p99_ms,
        "segments_ms": res.latency_segments_ms,
        "requests": res.requests,
        "backend": "consensus-native",
    }), flush=True)


# -- the in-process arms: the chain on the card, or on the CPU -------------------


class Chain:
    """``chain`` applications of ``ed25519.verify_kernel`` on one batch put on
    ``device`` once, each adding its verdicts into an int32 ``acc``; a call
    returns ``acc`` on the host. On the card the whole chain is one CUDA
    graph, captured after one eager application on a side stream (constants
    and kernel libraries load there, outside the capture), with ``acc``
    allocated and zeroed inside it; a call replays it, counts the launches it
    recorded and copies ``acc`` out, which waits for the replay. On the CPU
    a call runs the chain op by op (the kernels' plain versions)."""

    def __init__(self, pubs, msgs, sigs, chain: int, device):
        import torch

        from ..crypto import ed25519, kernels

        self._torch, self._kernels, self._verify = torch, kernels, ed25519.verify_kernel
        self.chain = chain
        self.inputs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (pubs, msgs, sigs))
        self._graph = None
        self.capture_s = 0.0
        if self.inputs[0].device.type == "cuda":
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._verify(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._graph = torch.cuda.CUDAGraph()
            with kernels.recording() as launches, torch.cuda.graph(self._graph):
                self._acc = self._run()
            torch.cuda.synchronize()
            self.capture_s = time.perf_counter() - t0
            self.launches = launches  # per replay

    def _run(self):
        torch = self._torch
        acc = torch.zeros(self.inputs[0].shape[0], dtype=torch.int32, device=self.inputs[0].device)
        for _ in range(self.chain):
            acc += self._verify(*self.inputs).to(torch.int32)
        return acc

    def __call__(self) -> np.ndarray:
        if self._graph is None:
            return self._run().numpy()
        self._graph.replay()
        self._kernels.add_launches(self.launches)
        return self._acc.cpu().numpy()


def run_chained(backend: str, target_secs: float) -> None:
    """The in-process arm: ``backend`` ``cuda`` (the card) or ``cpu`` (the
    plain versions)."""
    import torch

    from ..crypto import batch as B
    from ..crypto import kernels
    from ..device import resolve_device

    if backend == "cuda":
        try:
            device = resolve_device(None)
        except RuntimeError as e:
            _fail("backend-init", str(e))
        try:
            info = kernels.build(CACHE_DIR)
        except RuntimeError as e:
            _fail("kernel-build", str(e))
        _log(f"kernels: {info['dir']} ({info['build_s']:.1f} s, compiled {info['compiled']})")
    else:
        device = torch.device("cpu")
    batch = _env_int("PBFT_BENCH_BATCH", 4096)
    chain = _env_int("PBFT_BENCH_CHAIN", 16)
    _log(f"device: {device}; batch={batch} chain={chain}")
    bp, bm, bs = _pool(batch)
    try:
        t0 = time.perf_counter()
        out = B.verify_many(_items(bp, bm, bs), device=device)
        first_batch_s = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 - reported on the line
        _fail("first-batch", repr(e))
    if not _bitmap_ok(out, batch):
        _fail("verdicts", f"wrong bitmap: sum={sum(out)}")
    _log(f"verify_many capture+first: {first_batch_s:.1f}s; verdicts OK")
    want = chain * np.asarray(out, np.int32)
    try:
        chained = Chain(bp, bm, bs, chain, device)
        if backend == "cuda":
            _log(f"chain of {chain} captured in {chained.capture_s:.1f}s")
        acc = chained()
        if not np.array_equal(acc, want):
            _fail("chained-verdicts", f"acc differs from {chain} x the bitmap on rows {np.flatnonzero(acc != want)[:8]}")
        kernels.reset_launches()
        chains, wrong, elapsed = 0, 0, 0.0
        t0 = time.perf_counter()
        while elapsed < target_secs or chains == 0:
            wrong += not np.array_equal(chained(), want)
            chains += 1
            elapsed = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    except BenchFailed:
        raise
    except Exception as e:  # noqa: BLE001 - reported on the line
        _fail("timed-region", repr(e))
    if wrong:
        _fail("chained-verdicts", f"{wrong} of {chains} timed chains differ from {chain} x the bitmap")
    per_sec = chains * chain * batch / elapsed
    _log(f"{chains} chains x {chain} batches of {batch} in {elapsed:.2f}s")
    extra = {
        "batch": batch, "chain": chain, "chains": chains, "applications": chains * chain,
        "capture_s": round(chained.capture_s, 3), "first_batch_s": round(first_batch_s, 3),
        "window_ms": round(elapsed / (chains * chain) * 1e3, 3), "launches": launches,
    }
    if backend == "cuda":
        extra.update(_card())
    _emit(per_sec, backend, extra)


# -- the service arm --------------------------------------------------------------


def _wait_ready(target: str, proc, budget_s: float) -> dict:
    """Poll the service's JSON status until ``ready`` or ``cpu-only``; a
    failed warm, a spawned process that exits or a spent budget fails the
    run (``service-warm``)."""
    from ..net.verify_service import probe_status_json

    t0 = time.perf_counter()
    while True:
        if proc is not None and proc.poll() is not None:
            _fail("service-warm", f"verify service exited rc={proc.returncode} during warmup")
        status = probe_status_json(target, timeout=2.0)
        state = status.get("state") if status else None
        if state in ("ready", "cpu-only"):
            return status
        if state == "failed":
            _fail("service-warm", str(status.get("warm_error")))
        if time.perf_counter() - t0 > budget_s:
            _fail("service-warm", f"{target} not ready after {budget_s:.0f}s (state {state})")
        time.sleep(0.2)


def _launch_service():
    """Spawn the port's verify daemon on the card on a free port: (process,
    address). Its standard output, where it announces itself, goes to
    /dev/null (this process's is for the result line); its standard error is
    ours."""
    from ..net.launcher import free_ports

    port = free_ports(1)[0]
    cmd = [sys.executable, "-m", "pbft_tpu_torch.net.verify_service", "--port", str(port),
           "--backend", "cuda", "--cache-dir", str(CACHE_DIR)]
    _log(f"launching verify service: {' '.join(cmd)}")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, cwd=REPO, env=env)
    return proc, f"127.0.0.1:{port}"


def _stop_service(proc) -> None:
    if proc is None or proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def _drive_service(target: str, target_secs: float) -> dict:
    """Several connections submit windows at once (the service merges them),
    timed after one untimed round trip each, whose bitmap is checked."""
    batch = _env_int("PBFT_BENCH_BATCH", 1024)
    conns = _env_int("PBFT_BENCH_SERVICE_CONNS", 4)
    io_timeout = float(os.environ.get("PBFT_BENCH_SERVICE_TIMEOUT", "300"))
    bp, bm, bs = _pool(batch)
    payload = batch.to_bytes(4, "big") + b"".join(bytes(bp[i]) + bytes(bm[i]) + bytes(bs[i]) for i in range(batch))
    host, port = target.rsplit(":", 1)

    def roundtrip(sock) -> bytes:
        sock.sendall(payload)
        out = b""
        while len(out) < batch:
            chunk = sock.recv(batch - len(out))
            if not chunk:
                raise ConnectionError("service closed mid-verdicts")
            out += chunk
        return out

    socks = []
    try:
        t0 = time.perf_counter()
        for _ in range(conns):
            sock = socket.create_connection((host, int(port)), timeout=io_timeout)
            socks.append(sock)
            out = roundtrip(sock)
            if not _bitmap_ok(out, batch):
                _fail("service-verdicts", f"wrong bitmap: sum={sum(out)}")
        warm_start_s = time.perf_counter() - t0
        _log(f"service warm-start ({conns} conns): {warm_start_s:.2f}s")

        done = [0] * conns
        errors: list = []
        stop_at = time.perf_counter() + target_secs

        def worker(idx: int, sock) -> None:
            try:
                while time.perf_counter() < stop_at or done[idx] == 0:
                    done[idx] += len(roundtrip(sock))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=worker, args=(i, s), daemon=True) for i, s in enumerate(socks)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=target_secs * 10 + 120)
        elapsed = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            _fail("service-timed-region", "; ".join(errors[:3]) or "a connection did not finish")
    finally:
        for sock in socks:
            sock.close()
    per_sec = sum(done) / elapsed
    _log(f"service steady state: {per_sec:.0f} verifies/sec over {conns} connections ({elapsed:.2f}s timed)")
    return {"connections": conns, "batch": batch, "warm_start_s": round(warm_start_s, 3), "per_sec": per_sec}


def _delta(after: dict, before: dict, key: str) -> int:
    return int(after.get(key, 0)) - int(before.get(key, 0))


def run_service(target_secs: float) -> None:
    """Drive the verify service at ``PBFT_VERIFY_SERVICE``, spawning the
    port's daemon on the card when none answers."""
    from ..net.verify_service import probe_status_json

    target = os.environ.get("PBFT_VERIFY_SERVICE", "127.0.0.1:7600")
    budget = float(os.environ.get("PBFT_SERVICE_WARM_BUDGET_S", "900"))
    proc, cold_start_s = None, None
    status = probe_status_json(target, timeout=2.0)
    if status is None:
        import torch

        if not (torch.cuda.is_available() or os.environ.get("PBFT_BENCH_LAUNCH_SERVICE")):
            _fail("backend-init", "no CUDA device and no verify service; PBFT_BENCH_NATIVE=1 runs the host's arm")
        t0 = time.perf_counter()
        proc, target = _launch_service()
    else:
        _log(f"verify service at {target}: {status}")
    try:
        status = _wait_ready(target, proc, budget)
        if proc is not None:
            cold_start_s = time.perf_counter() - t0
            _log(f"verify service ready in {cold_start_s:.1f}s: {status}")
        run = _drive_service(target, target_secs)
        after = probe_status_json(target, timeout=5.0)
        if after is None:
            _fail("service-status", f"{target} stopped answering after the timed region")
    finally:
        _stop_service(proc)
    warm_stats = status.get("warm_stats", {})
    extra = {
        "devices": status.get("devices", 0),
        "service_state": status.get("state"),
        "connections": run["connections"],
        "batch": run["batch"],
        "warm_start_s": run["warm_start_s"],
        "steady_state_per_sec": round(run["per_sec"], 1),
        "service_cold_compile_s": warm_stats.get("cold_compile_s"),
        "service_warm_load_s": warm_stats.get("warm_load_s"),
        "graph_pool_bytes": warm_stats.get("graph_pool_bytes"),
        "service_windows": _delta(after, status, "launches"),
        "service_items": _delta(after, status, "items"),
    }
    if "kernel_launches" in after:
        extra["kernel_launches"] = {k: n - status["kernel_launches"].get(k, 0)
                                    for k, n in after["kernel_launches"].items()}
    if proc is not None:
        extra["cold_start_s"] = round(cold_start_s, 1)
        extra["service_pid"] = proc.pid
    if status.get("backend") == "cuda":
        extra.update(_card())
    _emit(run["per_sec"], "verify-service", extra)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    target_secs = float(os.environ.get("PBFT_BENCH_SECS", "5.0"))
    try:
        if "--cuda-worker" in argv:
            run_chained("cuda", target_secs)
        elif os.environ.get("PBFT_BENCH_NATIVE"):
            run_native(target_secs)
        elif os.environ.get("PBFT_BENCH_CONSENSUS"):
            run_consensus()
        elif os.environ.get("PBFT_BENCH_CPU") and "PBFT_VERIFY_SERVICE" not in os.environ:
            run_chained("cpu", target_secs)
        else:
            run_service(target_secs)
    except BenchFailed as e:
        error = str(e)
    except Exception as e:  # noqa: BLE001 - every failure still ends in the one line
        traceback.print_exc()
        error = f"unexpected: {type(e).__name__}: {e}"
    else:
        return 0
    print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "signatures/sec", "vs_baseline": 0.0,
                      "error": error}), flush=True)
    return 1
