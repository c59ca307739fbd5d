"""The verify service's operator surface in the port, on the CPU: the
metrics manifest and scrapes against the JAX package's, the trace events
against the manifest, the native verify pool (``pbft_tpu_torch.native``)
against the JAX package's binding and the oracle, the replica-side
``ServiceVerifier`` against the port's daemon, a dying listener and the JAX
daemon, and the default backends. Backends are stand-ins, the native pool
or the oracle on a few items: nothing here runs the plain torch verifier."""

import json
import socket
import threading
import time
import urllib.request

import pytest
import torch

from pbft_tpu import native as jax_native
from pbft_tpu.net.service import VerifierService as JaxVerifierService
from pbft_tpu.net.verify_service import VerifyServiceDaemon as JaxVerifyServiceDaemon
from pbft_tpu.utils import trace_schema as jax_schema
from pbft_tpu_torch import native
from pbft_tpu_torch.crypto import ref
from pbft_tpu_torch.net import service as SV
from pbft_tpu_torch.net import verify_service as VS
from pbft_tpu_torch.net.service import (
    STATE_CPU_ONLY,
    STATE_READY,
    STATE_WARMING,
    VerifierService,
    native_backend,
)
from pbft_tpu_torch.net.verify_service import (
    ServiceVerifier,
    VerifyServiceDaemon,
    probe_status,
    probe_status_json,
)
from pbft_tpu_torch.utils import trace_schema as schema
from tests.test_torch_ed25519 import _SMALL_ORDER, _cases


def _item(tag: int, valid: bool):
    # The stand-in backends deem an item valid iff sig[0] == pub[0].
    pub = bytes([tag]) * 32
    msg = bytes([tag ^ 0xFF]) * 32
    sig = (bytes([tag]) if valid else bytes([tag ^ 1])) + bytes(63)
    return pub, msg, sig


def _standin(items):
    if any(p[0] == 66 for p, m, s in items):
        raise RuntimeError("poison")
    return [p[0] == s[0] for p, m, s in items]


def _send(addr: str, items):
    """One request on a fresh connection; None when the service closed it."""
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=10) as sock:
        sock.sendall(len(items).to_bytes(4, "big") + b"".join(p + m + s for p, m, s in items))
        out = b""
        while len(out) < len(items):
            chunk = sock.recv(len(items) - len(out))
            if not chunk:
                return None
            out += chunk
    return [bool(b) for b in out]


def _get(port: int, path: str = "/metrics") -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def _series(text: str) -> set:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def _signed(count: int, tag: int):
    """(items, oracle verdicts): ``count`` signed digests, every other
    signature corrupted."""
    items = []
    for i in range(count):
        seed, pub = ref.keygen(bytes([tag, i]) * 16)
        msg = bytes([tag ^ i]) * 32
        sig = ref.sign(seed, msg)
        items.append((pub, msg, sig if i % 2 == 0 else bytes([sig[0] ^ 0x40]) + sig[1:]))
    return items, [i % 2 == 0 for i in range(count)]


class _GatedEngine:
    """Engine stand-in: warm() blocks on ``gate``; verify accepts all."""

    def __init__(self, gate):
        self.gate = gate
        self.device_count = 1
        self.stats = {}
        self._warmed = ()

    @property
    def warmed_sizes(self):
        return self._warmed

    def warm(self):
        assert self.gate.wait(10)
        self._warmed = (16,)
        self.stats = {"cold_compile_s": 1.25, "warm_load_s": 0.0}
        return self.stats

    def verify(self, items):
        return [True] * len(items)


def _wait_ready(daemon):
    deadline = time.monotonic() + 10
    while daemon.state != STATE_READY and time.monotonic() < deadline:
        time.sleep(0.02)
    assert daemon.state == STATE_READY


def _service_events():
    return {k: v for k, v in schema.EVENT_SCHEMAS.items() if "service.py" in v["emitters"]}


def _service_metrics():
    return {k: v for k, v in schema.METRIC_SCHEMAS.items() if v[1] & {"service.py", "verify_service.py"}}


def test_manifest_is_the_jax_manifests_service_subset():
    # The port carries the whole manifest (the asyncio replica emits the
    # rest); the service's part is the JAX manifest's service part.
    want_events = {k: v for k, v in jax_schema.EVENT_SCHEMAS.items() if "service.py" in v["emitters"]}
    want_metrics = {
        k: v for k, v in jax_schema.METRIC_SCHEMAS.items() if v[1] & {"service.py", "verify_service.py"}
    }
    assert schema.EVENT_SCHEMAS == jax_schema.EVENT_SCHEMAS
    assert schema.METRIC_SCHEMAS == jax_schema.METRIC_SCHEMAS
    assert _service_events() == want_events and _service_metrics() == want_metrics
    assert schema.LATENCY_BUCKETS_S == jax_schema.LATENCY_BUCKETS_S
    assert schema.BATCH_SIZE_BUCKETS == jax_schema.BATCH_SIZE_BUCKETS
    for name, (kind, _) in schema.METRIC_SCHEMAS.items():
        if kind == "histogram":
            assert schema.histogram_buckets(name) == jax_schema.histogram_buckets(name), name


def _scripted_traffic(service_cls, coalesce: bool):
    """One service with the stand-in backend and metrics on; valid, invalid
    and poisoned requests; returns its scrape. Coalesced, the first request
    is held so that the next three (one poisoned) merge into one window,
    which fails and is retried request by request."""
    gate = threading.Event()
    first = threading.Event()

    def backend(items):
        if not first.is_set():
            first.set()
            gate.wait(10)
        return _standin(items)

    svc = service_cls(backend=backend if coalesce else _standin, coalesce=coalesce, metrics_port=0).start()
    try:
        if not coalesce:
            gate.set()
            assert _send(svc.address, [_item(1, True), _item(2, False), _item(3, True)]) == [True, False, True]
            assert _send(svc.address, [_item(4, False)]) == [False]
            assert _send(svc.address, [_item(66, True)]) is None  # the backend raised
            assert _send(svc.address, [_item(5, True), _item(6, True)]) == [True, True]
        else:
            results = {}

            def client(cid, items):
                results[cid] = _send(svc.address, items)

            held = threading.Thread(target=client, args=(1, [_item(1, True), _item(2, False)]))
            held.start()
            assert first.wait(10)
            others = [
                threading.Thread(target=client, args=(c, [_item(c, c != 67)])) for c in (65, 66, 67)
            ]
            for t in others:
                t.start()
            deadline = time.monotonic() + 5
            while svc.requests < 4 and time.monotonic() < deadline:
                time.sleep(0.01)
            gate.set()
            for t in [held] + others:
                t.join(10)
                assert not t.is_alive()
            assert results == {1: [True, False], 65: [True], 66: None, 67: [False]}
        return _get(svc.metrics_listen_port)
    finally:
        gate.set()
        svc.stop()


@pytest.mark.parametrize("coalesce", [False, True])
def test_scrape_equals_the_jax_service_line_for_line(coalesce):
    """The same wire requests through the JAX and the port service give the
    same scrape, but for the lines that hold a time."""

    def timeless(text):
        lines = text.splitlines()
        if coalesce:  # the in-flight age gauge holds a time too
            return [x for x in lines if "_seconds" not in x.split("{")[0] or x.startswith("#")
                    or x.split("{")[0].endswith("_count")]
        return [x for x in lines if not x.startswith(("pbft_verify_seconds_sum", "pbft_verify_seconds_bucket"))]

    port = _scripted_traffic(VerifierService, coalesce)
    jax = _scripted_traffic(JaxVerifierService, coalesce)
    assert timeless(port) == timeless(jax)
    # Uncoalesced, the poisoned request's failed call counts no batch.
    assert 'pbft_verify_batches_total{replica="service"} ' + ("2" if coalesce else "3") in port
    assert _series(port) == {n for n, (_, e) in schema.METRIC_SCHEMAS.items() if "service.py" in e}


def test_daemon_scrape_before_traffic_equals_the_jax_daemons():
    port = VerifyServiceDaemon(backend="cpu", metrics_port=0).start()
    jax = JaxVerifyServiceDaemon(backend="cpu", metrics_port=0).start()
    try:
        scrape = _get(port.service.metrics_listen_port)
        assert scrape == _get(jax.service.metrics_listen_port)
        assert _series(scrape) == set(_service_metrics())
        status = _get(port.service.metrics_listen_port, "/status")
        assert '"state": "cpu-only"' in status and '"backend": "cpu"' in status
    finally:
        port.stop()
        jax.stop()


def test_compile_gauges_come_from_the_warm_and_fallback_is_counted():
    gate = threading.Event()
    daemon = VerifyServiceDaemon(engine=_GatedEngine(gate), fallback=lambda items: [False] * len(items),
                                 metrics_port=0).start()
    try:
        port = daemon.service.metrics_listen_port
        assert 'pbft_verify_service_cold_compile_seconds{replica="service"} 0' in _get(port)
        assert _send(daemon.address, [_item(1, True)] * 3) == [False] * 3  # warming: the fallback
        gate.set()
        _wait_ready(daemon)
        assert _send(daemon.address, [_item(1, False)]) == [True]  # ready: the engine
        scrape = _get(port)
        assert 'pbft_verify_service_cold_compile_seconds{replica="service"} 1.25' in scrape
        assert 'pbft_verify_service_warm_compile_seconds{replica="service"} 0' in scrape
        assert 'pbft_verify_items_total{replica="service"} 4' in scrape
        assert 'pbft_verify_rejected_total{replica="service"} 3' in scrape
        js = probe_status_json(daemon.address)
        assert js["fallback_items"] == 3 and js["items"] == 4
    finally:
        gate.set()
        daemon.stop()


def test_trace_lines_validate_against_the_manifest(tmp_path):
    trace = tmp_path / "service.jsonl"
    gate = threading.Event()
    first = threading.Event()

    def backend(items):
        if not first.is_set():
            first.set()
            gate.wait(10)
        return _standin(items)

    svc = VerifierService(backend=backend, trace_path=str(trace)).start()
    try:
        held = threading.Thread(target=_send, args=(svc.address, [_item(1, False)]))
        held.start()
        assert first.wait(10)
        others = [threading.Thread(target=_send, args=(svc.address, [_item(c, True)])) for c in (65, 66)]
        for t in others:
            t.start()
        deadline = time.monotonic() + 5
        while svc.requests < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        gate.set()
        for t in [held] + others:
            t.join(10)
    finally:
        gate.set()
        svc.stop()
    events = [json.loads(line) for line in trace.read_text().splitlines()]
    assert {e["ev"] for e in events} == set(_service_events())
    for e in events:
        spec = schema.EVENT_SCHEMAS[e["ev"]]
        assert "service.py" in spec["emitters"]
        assert spec["required"] <= set(e) <= spec["required"] | spec["optional"], e


def test_native_pool_equals_the_jax_binding_and_the_oracle():
    (pubs, msgs, sigs), want = _cases()
    items = [(bytes(pubs[i]), bytes(msgs[i]), bytes(sigs[i])) for i in range(len(want))]
    jax_got = jax_native.verify_batch(items)
    assert native.verify_batch(items) == jax_got
    assert native_backend(items) == jax_got
    assert native.host_batch_verify(items) == jax_got
    # Oracle equality on every row but the small-order ones: the pool's
    # random-linear-combination windows are a documented accept-set caveat
    # for colluding torsion defects (tests/test_native_crypto.py).
    honest = [i for i, it in enumerate(items) if it[0] not in _SMALL_ORDER and it[2][:32] not in _SMALL_ORDER]
    assert len(honest) >= 20 and False in [want[i] for i in honest]
    assert [jax_got[i] for i in honest] == [want[i] for i in honest]
    stats = native.verify_pool_stats()
    assert stats["threads"] == native.verify_threads() >= 1 and stats["items"] >= 3 * len(items)
    with pytest.raises(ValueError):
        native.verify_batch([(bytes(31), bytes(32), bytes(64))])


def _unloaded(monkeypatch):
    """Forget the loaded library for one test (restored after it)."""
    so = native.lib()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_error", None)
    monkeypatch.setattr(native, "_retry_at", 0.0)
    return so


def test_native_raises_and_only_host_batch_verify_degrades(monkeypatch):
    def broken():
        raise RuntimeError("no native core")

    _unloaded(monkeypatch)
    monkeypatch.setattr(native, "build", broken)
    items, want = _signed(2, 0x21)
    with pytest.raises(RuntimeError, match="no native core"):
        native.verify_batch(items)
    with pytest.raises(RuntimeError, match="no native core"):
        native_backend(items)
    assert not native.available()
    assert native.host_batch_verify(items) == want and native.host_verifier() == "oracle"
    for make in (lambda: VerifierService(backend="native"), lambda: VerifyServiceDaemon(backend="native")):
        with pytest.raises(RuntimeError, match="no native core"):
            make()


@pytest.mark.parametrize("fault", ["load", "build", "compiler"])
def test_a_failed_load_is_retried_a_failed_build_backs_off_and_no_compiler_is_final(monkeypatch, fault):
    so = _unloaded(monkeypatch)
    calls = {"build": 0, "load": 0}

    def build():
        calls["build"] += 1
        if fault == "compiler":
            raise native.NoCompilerError("no compiler")
        if fault == "build" and calls["build"] == 1:
            raise RuntimeError("compile failed")
        return {"built": False, "build_s": 0.0}

    def load():
        calls["load"] += 1
        if fault == "load" and calls["load"] == 1:
            raise OSError("half-written library")
        return so

    monkeypatch.setattr(native, "build", build)
    monkeypatch.setattr(native, "_load", load)
    assert not native.available() and native.host_verifier() == "oracle"
    wait = native._retry_at - time.monotonic()
    if fault == "load":  # tried again at the next call
        assert native.available() and native.host_verifier() == "native"
        assert calls == {"build": 2, "load": 2}
        return
    assert not native.available() and calls["build"] == 1  # within the back-off: no build
    if fault == "compiler":
        assert wait == float("inf")
        return
    assert 50 < wait <= native._BUILD_RETRY_S
    native._retry_at = 0.0  # a minute later
    assert native.available() and calls["build"] == 2


def test_no_request_waits_on_a_build_and_the_status_names_the_host_verifier(monkeypatch):
    so = _unloaded(monkeypatch)
    building, release = threading.Event(), threading.Event()

    def slow_build():
        building.set()
        assert release.wait(10)
        return {"built": True, "build_s": 0.0}

    monkeypatch.setattr(native, "build", slow_build)
    monkeypatch.setattr(native, "_load", lambda: so)
    gate = threading.Event()
    daemon = VerifyServiceDaemon(engine=_GatedEngine(gate)).start()  # starts the build
    try:
        assert building.wait(10)
        assert probe_status_json(daemon.address)["host_verifier"] == "oracle"
        items, want = _signed(2, 0x2B)
        t0 = time.monotonic()
        assert _send(daemon.address, items) == want  # the oracle, while the build runs
        assert time.monotonic() - t0 < 5 and not release.is_set()
        release.set()
        deadline = time.monotonic() + 10
        while probe_status_json(daemon.address)["host_verifier"] != "native":
            assert time.monotonic() < deadline, "the library never loaded"
            time.sleep(0.02)
        before = native.verify_pool_stats()["items"]
        assert _send(daemon.address, items) == want
        assert native.verify_pool_stats()["items"] == before + 2
        assert probe_status_json(daemon.address)["fallback_items"] == 4
    finally:
        release.set()
        gate.set()
        daemon.stop()
    for backend, name in (("cpu", "oracle"), ("native", "native")):
        d = VerifyServiceDaemon(backend=backend).start()
        try:
            assert d.status_json()["host_verifier"] == name
        finally:
            d.stop()


def test_service_verifier_uses_its_fallback_while_warming_then_the_daemon():
    gate = threading.Event()
    daemon = VerifyServiceDaemon(engine=_GatedEngine(gate)).start()
    assert daemon._fallback is native.host_batch_verify
    try:
        assert probe_status(daemon.address)[0] == STATE_WARMING
        sv = ServiceVerifier(daemon.address, fallback=lambda items: [None] * len(items), retry_s=0.05)
        assert sv.verify_batch([_item(1, False)]) == [None]
        assert sv.used_fallback == 1 and sv.state == STATE_WARMING
        # A client that ships anyway is served by the daemon's fallback:
        # the native pool, which rejects the stand-in items.
        assert _send(daemon.address, [_item(2, True)] * 2) == [False, False]
        assert probe_status_json(daemon.address)["fallback_items"] == 2
        gate.set()
        _wait_ready(daemon)
        deadline = time.monotonic() + 10
        while sv.verify_batch([_item(3, False)]) != [True]:  # the accept-all engine
            assert time.monotonic() < deadline, "the client never moved onto the ready daemon"
            time.sleep(0.05)
        used = sv.used_fallback
        assert sv(([_item(4, False)])) == [True] and sv.used_fallback == used
        assert sv.state == STATE_READY and sv.devices == 1
        sv.close()
        assert probe_status_json(daemon.address)["fallback_items"] == 2
    finally:
        gate.set()
        daemon.stop()


def test_service_verifier_drops_a_link_killed_mid_stream():
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    addr = "127.0.0.1:%d" % listener.getsockname()[1]

    def serve_once():
        conn, _ = listener.accept()
        with conn:
            assert SV._recv_exact(conn, 4) == bytes(4)  # the handshake
            conn.sendall(SV.pack_status(STATE_READY, 1, 1))
            n = int.from_bytes(SV._recv_exact(conn, 4), "big")
            SV._recv_exact(conn, n * 128)
            conn.sendall(b"\x01")  # one verdict byte of n, then gone
        listener.close()

    server = threading.Thread(target=serve_once)
    server.start()
    local = []

    def fallback(items):
        local.append(len(items))
        return [p[0] == s[0] for p, m, s in items]

    sv = ServiceVerifier(addr, fallback=fallback, retry_s=30)
    batch = [_item(1, True), _item(2, False), _item(3, True)]
    assert sv.verify_batch(batch) == [True, False, True]
    server.join(10)
    assert local == [3] and sv.used_fallback == 1
    assert sv._sock is None and sv.state is None
    # Backing off: the next batch is verified locally without a dial.
    assert sv.verify_batch(batch[:1]) == [True] and local == [3, 1]


def test_service_verifier_against_the_jax_daemon():
    def no_fallback(items):
        raise AssertionError("the client fell back")

    items, want = _signed(4, 0x33)
    daemon = JaxVerifyServiceDaemon(backend="cpu").start()
    try:
        sv = ServiceVerifier(daemon.address, fallback=no_fallback)
        try:
            assert sv.verify_batch(items) == want
            assert sv.state == STATE_CPU_ONLY and sv.used_fallback == 0
        finally:
            sv.close()
    finally:
        daemon.stop()


def test_bare_service_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VerifierService()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    svc = VerifierService().start()  # no traffic: nothing touches a card
    try:
        assert svc.backend is SV.cuda_backend
        assert probe_status(svc.address) == (STATE_READY, 0, 0)
        assert probe_status_json(svc.address)["backend"] == "cuda"
    finally:
        svc.stop()
    for name in ("native", "cpu"):
        svc = VerifierService(backend=name).start()
        try:
            assert probe_status(svc.address) == (STATE_CPU_ONLY, 0, 0)
        finally:
            svc.stop()


def test_a_metrics_port_in_use_raises_from_the_constructor():
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    port = taken.getsockname()[1]
    try:
        for make in (
            lambda: JaxVerifierService(backend="cpu", metrics_port=port),
            lambda: VerifierService(backend="cpu", metrics_port=port),
            lambda: VerifyServiceDaemon(backend="cpu", metrics_port=port),
        ):
            with pytest.raises(OSError):
                make()
    finally:
        taken.close()


def test_clis_pass_backend_and_metrics_port(monkeypatch):
    seen = {}

    class Recorder:
        def __init__(self, **kwargs):
            seen.update(kwargs)
            self.address, self.metrics_listen_port = "127.0.0.1:1", 2
            self.server = self

        def start(self, wait_ready=False):
            raise RuntimeError("not started")

        def serve_forever(self):
            seen["served"] = True

        def stop(self):
            seen["stopped"] = True

    monkeypatch.setattr(VS, "VerifyServiceDaemon", Recorder)
    assert VS.main(["--backend", "native", "--metrics-port", "0"]) == 1
    assert seen["backend"] == "native" and seen["metrics_port"] == 0 and seen["stopped"]
    seen.clear()
    monkeypatch.setattr(SV, "VerifierService", Recorder)
    SV.main(["--metrics-port", "9", "--port", "0"])
    assert seen["backend"] == "cuda" and seen["metrics_port"] == 9 and seen["served"]
