"""The port's verify service (pbft_tpu_torch.net) on the CPU: copies of the
coalescing / lifecycle tests of tests/test_service_coalesce.py run against
the port, wire compatibility with the JAX package's own socket client
(ServiceVerifier, probe_status, probe_status_json), and the engine's mesh of
shards (--devices). Only the wire test and the 2-shard engine test run the
real plain verify path, at one small warmed shape each."""

import json
import socket
import threading
import time

import pytest
import torch

from pbft_tpu.net.service import VerifierService as JaxVerifierService
from pbft_tpu.net.verify_service import ServiceVerifier
from pbft_tpu.net.verify_service import probe_status as jax_probe_status
from pbft_tpu.net.verify_service import probe_status_json as jax_probe_status_json
from pbft_tpu_torch.crypto import ref
from pbft_tpu_torch.net import verify_service as VS
from pbft_tpu_torch.net.service import (
    STATE_CPU_ONLY,
    STATE_READY,
    STATE_WARMING,
    VerifierService,
    cuda_backend,
)
from pbft_tpu_torch.net.verify_service import (
    CudaVerifyEngine,
    VerifyServiceDaemon,
    probe_status,
    probe_status_json,
)


def _send_batch(addr: str, items):
    host, port = addr.rsplit(":", 1)
    payload = b"".join(p + m + s for p, m, s in items)
    with socket.create_connection((host, int(port)), timeout=10) as sock:
        sock.sendall(len(items).to_bytes(4, "big") + payload)
        out = b""
        while len(out) < len(items):
            chunk = sock.recv(len(items) - len(out))
            assert chunk
            out += chunk
    return [bool(b) for b in out]


def _item(tag: int, valid: bool):
    # The fake backends deem an item valid iff sig[0] == pub[0].
    pub = bytes([tag]) * 32
    msg = bytes([tag ^ 0xFF]) * 32
    sig = (bytes([tag]) if valid else bytes([tag ^ 1])) + bytes(63)
    return pub, msg, sig


def _fake_kernel(pubs, msgs, sigs):
    """Cheap stand-in for verify_kernel on tensors: same rule as above."""
    return pubs[:, 0] == sigs[:, 0]


def test_concurrent_requests_coalesce_into_fewer_launches():
    calls = []
    gate = threading.Event()

    def slow_backend(items):
        calls.append(len(items))
        if len(calls) == 1:
            gate.wait(10)  # hold the first launch so others queue behind it
        return [p[0] == s[0] for p, m, s in items]

    svc = VerifierService(backend=slow_backend).start()
    try:
        results = {}

        def client(cid: int):
            items = [_item(cid, True), _item(cid, cid % 2 == 0)]
            results[cid] = _send_batch(svc.address, items)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(1, 5)]
        threads[0].start()
        while not calls:
            time.sleep(0.01)
        for t in threads[1:]:
            t.start()
        deadline = time.monotonic() + 5
        while svc.requests < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        gate.set()
        for t in threads:
            t.join(timeout=10)
        assert svc.requests == 4
        assert svc.batches < 4, f"no coalescing happened: {calls}"
        assert sum(calls) == 8 and svc.items == 8
        for cid in range(1, 5):
            assert results[cid] == [True, cid % 2 == 0], (cid, results[cid])
    finally:
        gate.set()
        svc.stop()


def test_poison_batch_only_fails_its_own_connection(tmp_path):
    gate = threading.Event()
    first = threading.Event()

    def backend(items):
        if not first.is_set():
            first.set()
            gate.wait(10)
        if any(p[0] == 66 for p, m, s in items):
            raise RuntimeError("poison")
        return [p[0] == s[0] for p, m, s in items]

    trace = tmp_path / "service.jsonl"
    svc = VerifierService(backend=backend, trace_path=str(trace)).start()
    try:
        results = {}

        def client(cid: int):
            try:
                results[cid] = _send_batch(svc.address, [_item(cid, True)])
            except (AssertionError, ConnectionError, OSError):
                results[cid] = "error"

        t1 = threading.Thread(target=client, args=(1,))
        t1.start()
        while not first.is_set():
            time.sleep(0.01)
        others = [threading.Thread(target=client, args=(c,)) for c in (65, 66, 67)]
        for t in others:
            t.start()
        deadline = time.monotonic() + 5
        while svc.requests < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        gate.set()
        t1.join(timeout=10)
        for t in others:
            t.join(timeout=10)
        assert results[1] == [True]
        assert results[65] == [True]
        assert results[66] == "error"  # the poisoned one, and only it
        assert results[67] == [True]
    finally:
        gate.set()
        svc.stop()
    events = [json.loads(line) for line in trace.read_text().splitlines()]
    vb = [e for e in events if e["ev"] == "verify_batch"]
    failed = [e for e in events if e["ev"] == "verify_window_failed"]
    errored = [e for e in events if e["ev"] == "verify_batch_error"]
    assert len(failed) == 1 and failed[0]["size"] == 3, failed
    assert sum(e["size"] for e in vb) == 3, vb
    assert sum(e["rejected"] for e in vb) == 0, vb
    assert len(errored) == 1 and errored[0]["size"] == 1, errored
    assert all(e["requests"] == 1 for e in vb if e["size"] == 1), vb


def test_overlapped_launches_hide_launch_latency():
    """inflight=2: window N+1 ships while N executes; the serial default
    cannot. Verdict slicing stays per-request in both modes."""

    def run(inflight: int):
        first_launch_started = threading.Event()
        spans = []

        def slow_backend(items):
            start = time.monotonic()
            first_launch_started.set()
            time.sleep(0.35)  # stands in for a launch; releases the GIL
            spans.append((start, time.monotonic()))
            return [p[0] == s[0] for p, m, s in items]

        svc = VerifierService(backend=slow_backend, inflight=inflight).start()
        try:
            results = {}

            def client(cid: int):
                if cid == 2:
                    assert first_launch_started.wait(10)
                results[cid] = _send_batch(svc.address, [_item(cid, True)])

            threads = [threading.Thread(target=client, args=(c,)) for c in (1, 2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=15)
            assert results[1] == [True] and results[2] == [True]
            assert svc.batches == 2 and len(spans) == 2, spans
            return sorted(spans)
        finally:
            svc.stop()

    serial = run(1)
    assert serial[1][0] >= serial[0][1], f"serial launches overlapped: {serial}"
    overlapped = run(2)
    assert overlapped[1][0] < overlapped[0][1], f"overlapped launches serialized: {overlapped}"


def test_overlapped_window_merges_what_queued_while_slots_were_busy():
    """inflight=2 with both launches held: the next request forms a window
    that waits for a slot, and the requests that queue behind it go out
    together as ONE window. The port forms the same windows as the JAX
    package's dispatcher on the same script."""

    def run(service_cls):
        windows = []
        gate = threading.Event()
        started = threading.Semaphore(0)

        def backend(items):
            windows.append(tuple(sorted(p[0] for p, m, s in items)))
            if len(windows) <= 2:
                started.release()
                gate.wait(10)
            return [p[0] == s[0] for p, m, s in items]

        svc = service_cls(backend=backend, inflight=2).start()
        try:
            results = {}

            def client(cid: int):
                results[cid] = _send_batch(svc.address, [_item(cid, cid != 4)])

            def wait_for(cond):
                deadline = time.monotonic() + 5
                while not cond() and time.monotonic() < deadline:
                    time.sleep(0.01)
                assert cond()

            threads = {c: threading.Thread(target=client, args=(c,)) for c in range(1, 6)}
            for c in (1, 2):  # one held launch each
                threads[c].start()
                assert started.acquire(timeout=10)
            threads[3].start()  # taken into a window that waits for a slot
            wait_for(lambda: svc.requests == 3 and not svc._pending)
            for c in (4, 5):
                threads[c].start()
            wait_for(lambda: svc.requests == 5)
            gate.set()
            for t in threads.values():
                t.join(timeout=10)
                assert not t.is_alive()
            assert svc.batches == 4 and svc.requests == 5
            assert [results[c] for c in range(1, 6)] == [[True], [True], [True], [False], [True]]
            return sorted(windows)
        finally:
            gate.set()
            svc.stop()

    port = run(VerifierService)
    assert port == [(1,), (2,), (3,), (4, 5)], port
    assert run(JaxVerifierService) == port


def test_status_probe_reports_state_and_traffic_continues():
    """count 0 returns the 8-byte status, the JSON probe the rich status,
    and a batch on the SAME connection after a probe still verifies."""

    def backend(items):
        return [p[0] == s[0] for p, m, s in items]

    svc = VerifierService(backend=backend).start()
    try:
        assert probe_status(svc.address) == (STATE_CPU_ONLY, 0, 0)
        js = probe_status_json(svc.address)
        assert js["state"] == "cpu-only" and js["backend"] == "custom"
        host, port = svc.address.rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=10) as sock:
            sock.sendall((0).to_bytes(4, "big"))
            status = b""
            while len(status) < 8:
                status += sock.recv(8 - len(status))
            assert status[:2] == b"VS"
            p, m, s = _item(9, True)
            sock.sendall((1).to_bytes(4, "big") + p + m + s)
            assert sock.recv(1) == b"\x01"
    finally:
        svc.stop()


class _StubEngine:
    """Engine double with a gated warmup and a distinguishable verdict."""

    def __init__(self, gate):
        self.gate = gate
        self.device_count = 5
        self.stats = {}
        self._warmed = ()

    @property
    def warmed_sizes(self):
        return self._warmed

    def warm(self):
        assert self.gate.wait(10)
        self._warmed = (16, 64)
        self.stats = {"cold_compile_s": 0.5, "warm_load_s": 0.0}
        return self.stats

    def verify(self, items):
        return [True] * len(items)  # accept-all: provably not the fallback


def test_daemon_warming_serves_fallback_then_flips_ready():
    gate = threading.Event()
    daemon = VerifyServiceDaemon(
        engine=_StubEngine(gate),
        fallback=lambda items: [False] * len(items),  # reject-all fallback
    )
    daemon.start()
    try:
        st = probe_status(daemon.address)
        assert st is not None and st[0] == STATE_WARMING
        sv = ServiceVerifier(daemon.address, fallback=lambda items: [None] * len(items), retry_s=0.05)
        # The client consumed the handshake: warming -> its LOCAL fallback.
        assert sv.verify_batch([_item(1, True)]) == [None]
        assert sv.used_fallback == 1
        # A pre-handshake client shipping anyway gets the daemon fallback.
        assert _send_batch(daemon.address, [_item(2, True)]) == [False]
        assert probe_status_json(daemon.address)["fallback_items"] == 1
        gate.set()
        deadline = time.monotonic() + 10
        while daemon.state != STATE_READY and time.monotonic() < deadline:
            time.sleep(0.02)
        assert probe_status(daemon.address) == (STATE_READY, 5, 2)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if sv.verify_batch([_item(3, False)]) == [True]:
                break  # accept-all engine answered
            time.sleep(0.05)
        else:
            raise AssertionError("client never flipped onto the ready engine")
        js = probe_status_json(daemon.address)
        assert js["state"] == "ready" and js["devices"] == 5
        assert js["warm_stats"]["cold_compile_s"] == 0.5
        assert js["fallback_items"] == 1
    finally:
        gate.set()
        daemon.stop()


def test_failed_warm_is_raised_not_hidden():
    class Broken(_StubEngine):
        def warm(self):
            raise RuntimeError("no card")

    daemon = VerifyServiceDaemon(engine=Broken(threading.Event()))
    try:
        try:
            daemon.start(wait_ready=True, timeout=10)
            raised = False
        except RuntimeError as e:
            raised = "no card" in str(e)
        assert raised
        js = probe_status_json(daemon.address)
        assert js["state"] == "failed" and "no card" in js["warm_error"]
        # The 8-byte record has no failed state: it keeps a client verifying
        # locally. A request sent anyway is refused, not served as warm-time
        # traffic.
        assert probe_status(daemon.address)[0] == STATE_WARMING
        host, port = daemon.address.rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=10) as sock:
            sock.sendall((1).to_bytes(4, "big") + b"".join(_item(1, True)))
            assert sock.recv(1) == b""
        assert probe_status_json(daemon.address)["fallback_items"] == 0
    finally:
        daemon.stop()


def test_engine_parity_pad_slots_and_window_boundaries():
    eng = CudaVerifyEngine(shapes=(8, 16), device="cpu", kernel=_fake_kernel)
    stats = eng.warm()
    assert eng.device_count == 1 and eng.warmed_sizes == (8, 16)
    assert stats["shapes"] == [8, 16] and stats["compiled"] == 2 and stats["aot_loaded"] == 0
    items = [_item(i + 1, i % 3 != 0) for i in range(11)]
    want = [i % 3 != 0 for i in range(11)]
    assert eng.verify(items) == want
    assert eng.verify(items[:8]) == want[:8]
    assert eng.verify(items[:9]) == want[:9]
    # Oversized: chunks into top-of-ladder windows, order preserved.
    big = [_item((i % 23) + 1, i % 5 != 0) for i in range(40)]
    assert eng.verify(big) == [i % 5 != 0 for i in range(40)]


def test_jax_client_talks_to_the_port_daemon():
    """Wire compatibility: the JAX package's pure-socket client and probes
    against the port's daemon running the real plain verify path."""
    def no_fallback(items):
        raise AssertionError("the client fell back")

    daemon = VerifyServiceDaemon(engine=CudaVerifyEngine(shapes=(16,), device="cpu"))
    daemon.start(wait_ready=True, timeout=300)
    try:
        assert jax_probe_status(daemon.address) == (STATE_READY, 1, 1)
        js = jax_probe_status_json(daemon.address)
        assert js["state"] == "ready" and js["warmed_shapes"] == [16]
        items, want = [], []
        for i in range(3):
            seed, pub = ref.keygen(bytes([0x31 + i]) * 32)
            msg = bytes([i]) * 32
            sig = ref.sign(seed, msg)
            items += [(pub, msg, sig), (pub, msg, bytes([sig[0] ^ 0x40]) + sig[1:])]
            want += [True, False]
        sv = ServiceVerifier(daemon.address, fallback=no_fallback)
        try:
            assert sv.verify_batch(items) == want
            assert sv.used_fallback == 0
        finally:
            sv.close()
        js = jax_probe_status_json(daemon.address)
        assert js["fallback_items"] == 0 and js["items"] == len(items)
    finally:
        daemon.stop()


@pytest.mark.parametrize("devices,shapes,want", [(None, (8, 16), (8, 16)), (3, (8, 16), (9, 18)), (2, (16,), (16,))])
def test_engine_shards_and_rounds_shapes_to_the_mesh(devices, shapes, want):
    eng = CudaVerifyEngine(shapes=shapes, device="cpu", kernel=_fake_kernel, devices=devices)
    stats = eng.warm()
    assert eng.device_count == stats["devices"] == (devices or 1)
    assert eng.warmed_sizes == want and stats["shapes"] == list(want)
    assert stats["shards"] == ["cpu"] * (devices or 1)
    big = [_item((i % 23) + 1, i % 5 != 0) for i in range(40)]
    assert eng.verify(big) == [i % 5 != 0 for i in range(40)]


def _signed_pairs(count: int):
    items, want = [], []
    for i in range(count):
        seed, pub = ref.keygen(bytes([0x51 + i]) * 32)
        msg = bytes([i]) * 32
        sig = ref.sign(seed, msg)
        items += [(pub, msg, sig), (pub, msg, sig[:32] + bytes([sig[32] ^ 1]) + sig[33:])]
        want += [True, False]
    return items, want


def test_two_shard_engine_serves_the_oracle_and_reports_two_devices():
    """The real plain verify on a 2-shard CPU mesh behind the daemon; the
    invalid rows sit on both sides of the shard boundary (rows 3 | 4)."""
    daemon = VerifyServiceDaemon(engine=CudaVerifyEngine(shapes=(8,), device="cpu", devices=2))
    daemon.start(wait_ready=True, timeout=300)
    try:
        assert probe_status(daemon.address) == (STATE_READY, 2, 1)
        js = probe_status_json(daemon.address)
        assert js["devices"] == 2 and js["warm_stats"]["shards"] == ["cpu", "cpu"]
        items, want = _signed_pairs(4)
        assert want == [ref.verify(*it) for it in items]
        assert _send_batch(daemon.address, items) == want
        assert probe_status_json(daemon.address)["fallback_items"] == 0
    finally:
        daemon.stop()


def test_cuda_backend_and_engine_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VerifierService(backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cuda_backend([_item(1, True)])
    for devices in (None, 2):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CudaVerifyEngine(devices=devices).warm()


def test_engine_raises_for_more_cards_than_exist(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="asked for 2 devices, 1 available"):
        CudaVerifyEngine(devices=2, kernel=_fake_kernel).warm()


@pytest.mark.parametrize("argv,want", [([], None), (["--devices", "3"], 3), (["--devices", "1", "--device", "cpu"], 1)])
def test_cli_parses_devices(monkeypatch, argv, want):
    seen = {}

    class Recorder:
        def __init__(self, **kwargs):
            seen.update(kwargs)

        def start(self, wait_ready=False):
            raise RuntimeError("not started")

        def stop(self):
            seen["stopped"] = True

    monkeypatch.setattr(VS, "VerifyServiceDaemon", Recorder)
    assert VS.main(argv) == 1
    assert seen["devices"] == want and seen["stopped"]
