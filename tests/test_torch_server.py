"""The port's asyncio replica runtime and the modules it stands on, on the
CPU, against the JAX package's: the schema manifest, the flight recorder's
bytes, the secure channel's handshake, keys and frames, the metrics surface
and the view-timer policy, then clusters: port and JAX replicas in one event
loop, the port's ``LocalCluster`` with ``py`` and mixed replicas, a gateway,
and the CLI's ``cuda`` default. Every comparison is exact. The ``cuda``
cases run a cluster whose replicas verify on the card, and hold the kernels'
launches of an in-process replica equal to its windows."""

import asyncio
import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from pbft_tpu.consensus.config import ClusterConfig as JaxClusterConfig
from pbft_tpu.net import secure as jax_secure
from pbft_tpu.net.server import AsyncReplicaServer as JaxServer
from pbft_tpu.net.server import ViewTimerBackoff as JaxBackoff
from pbft_tpu.utils import flight as jax_flight
from pbft_tpu.utils import metrics as jax_metrics
from pbft_tpu.utils import trace_schema as jax_schema
from pbft_tpu_torch import native
from pbft_tpu_torch.consensus.config import ClusterConfig, make_local_cluster
from pbft_tpu_torch.net import gateway, secure
from pbft_tpu_torch.net.client import PbftClient
from pbft_tpu_torch.net.launcher import LocalCluster, free_ports
from pbft_tpu_torch.net.server import AsyncReplicaServer, ViewTimerBackoff
from pbft_tpu_torch.utils import flight, metrics, trace_schema

_REPO = Path(__file__).resolve().parent.parent


def _cluster_json(n: int = 4):
    """(network.json text on free loopback ports, seeds)."""
    config, seeds = make_local_cluster(n, base_port=0)
    ports = free_ports(n)
    config = dataclasses.replace(
        config, replicas=[dataclasses.replace(r, port=ports[i]) for i, r in enumerate(config.replicas)]
    )
    return config.to_json(), seeds


def _oracle_verify(items):
    # The accept set of crypto.ref.verify, one signature at a time.
    return [native.verify(p, m, s) for p, m, s in items]


# -- the modules, against the JAX package's ---------------------------------


def test_trace_schema_tables_equal_the_jax_packages():
    names = [k for k in vars(jax_schema) if k.isupper()]
    assert {"EVENT_SCHEMAS", "METRIC_SCHEMAS", "PHASES", "FLIGHT_EVENT_IDS", "HEALTH_DOC_VERSION",
            "PHASE_HISTOGRAMS"} <= set(names)
    for name in names:
        assert getattr(trace_schema, name) == getattr(jax_schema, name), name
    for name, (kind, _) in jax_schema.METRIC_SCHEMAS.items():
        if kind == "histogram":
            assert trace_schema.histogram_buckets(name) == jax_schema.histogram_buckets(name), name


def test_flight_record_bytes_equal_the_jax_packages(monkeypatch, tmp_path):
    recorders = [flight.FlightRecorder(capacity=16), jax_flight.FlightRecorder(capacity=16)]
    for rec in recorders:  # one sequence at one clock; the ring keeps the last 16
        clock = iter(range(10**9, 10**9 + 1000, 7))
        monkeypatch.setattr(time, "monotonic_ns", lambda clock=clock: next(clock))
        for seq in range(6):
            rec.record("request_rx", view=0, seq=seq)
            rec.record_phase("pre_prepare", 0, seq)
            rec.record_phase("executed", 0, seq)
        rec.record("verify_batch", view=2**31 + 5, seq=-1, peer=40000)
        rec.record("gateway_failover", view=1, peer=3, t_ns=42)
        rec.record(99, view=1, seq=2)
    port, jax = (r.encode() for r in recorders)
    assert port == jax and port[:8] == b"PBFTBBX1" and len(port) == 16 + 16 * 20
    assert recorders[0].dump(str(tmp_path / "a.flight")) == 16
    assert jax_flight.decode_file(str(tmp_path / "a.flight")) == flight.decode_bytes(jax)


@pytest.mark.parametrize("port_initiates", [True, False])
def test_secure_channel_interoperates_with_the_jax_packages(port_initiates):
    text, seeds = _cluster_json()
    config = ClusterConfig.from_json(text)

    def pubkey_of(node):
        return config.identity(node).pubkey_bytes() if 0 <= node < config.n else None

    eph_i, eph_r = bytes([7]) * 32, bytes([9]) * 32

    def pair(ini_mod, resp_mod):
        ini = ini_mod.SecureChannel(0, seeds[0], pubkey_of, initiator=True, expected_peer=1, eph_secret=eph_i,
                                    offer_mac=True)
        resp = resp_mod.SecureChannel(1, seeds[1], pubkey_of, initiator=False, eph_secret=eph_r, offer_mac=True)
        hello = ini.initiator_hello()
        hello_r = resp.on_hello(hello)
        auth = ini.on_hello_reply(hello_r)
        resp.on_auth(auth)
        return ini, resp, (hello, hello_r, auth)

    ini_mod, resp_mod = (secure, jax_secure) if port_initiates else (jax_secure, secure)
    ini, resp, frames = pair(ini_mod, resp_mod)
    jini, jresp, jframes = pair(jax_secure, jax_secure)
    assert frames == jframes  # the same handshake frames, byte for byte
    assert ini.established and resp.established and ini.mac_negotiated and resp.mac_negotiated
    assert (ini._send_key, ini._recv_key, ini.auth_send_key) == (jini._send_key, jini._recv_key, jini.auth_send_key)
    assert (resp._send_key, resp.auth_recv_key) == (jresp._send_key, jresp.auth_recv_key)
    for payload in (b"", b"{}", bytes(range(256)) * 3):
        sealed = ini.seal_frame(payload)
        assert sealed == jini.seal_frame(payload)
        assert resp.open_frame(sealed) == payload
        back = resp.seal_frame(payload[::-1])
        assert ini.open_frame(back) == payload[::-1]
    tampered = bytearray(ini.seal_frame(b"pre-prepare"))
    tampered[3] ^= 1
    with pytest.raises((secure.HandshakeError, jax_secure.HandshakeError)):
        resp.open_frame(bytes(tampered))
    tampered = bytearray(resp.seal_frame(b"commit"))
    tampered[-1] ^= 1
    with pytest.raises((secure.HandshakeError, jax_secure.HandshakeError)):
        ini.open_frame(bytes(tampered))
    assert secure.PROTOCOL_VERSION == jax_secure.PROTOCOL_VERSION
    assert secure.plain_hello(2, offer_mac=True) == jax_secure.plain_hello(2, offer_mac=True)


def test_view_timer_backoff_equals_the_jax_packages():
    port, jax = ViewTimerBackoff(0.5), JaxBackoff(0.5)
    # (now, executed, view, in_view_change), stalls, retransmits, progress.
    polls = [(0, 0, 0, False), (0.1, 0, 0, False), (0.6, 0, 0, False), (0.7, 0, 1, True), (1.8, 0, 1, True),
             (1.9, 0, 1, True), (3.0, 0, 1, True), (3.1, 0, 1, True), (9.0, 0, 1, True), (9.1, 4, 1, False),
             (20.0, 5, 1, False)] + [(30.0 + 40 * i, 5, 1, True) for i in range(40)]
    got = [(port.poll(*p), port.level) for p in polls]
    assert got == [(jax.poll(*p), jax.level) for p in polls]
    assert max(level for _, level in got) == ViewTimerBackoff.MAX_LEVEL
    port.clear()
    jax.clear()
    assert (port.level, port.deadline) == (jax.level, jax.deadline) == (1, None)


def test_consensus_spans_and_replica_scrape_equal_the_jax_packages():
    regs = []
    for mod in (metrics, jax_metrics):
        clock = iter(x / 8 for x in range(1000))
        reg = mod.MetricsRegistry(labels={"replica": "2"})
        reg.preregister()
        spans = mod.ConsensusSpans(reg, replica=2, clock=lambda clock=clock: next(clock), max_open=3)
        for seq in range(1, 6):
            for phase in ("request", "pre_prepare", "prepared", "committed", "executed"):
                spans.on_phase(phase, 0, seq)
        spans.on_phase("pre_prepare", 1, 9)  # evicted, never executed
        spans.on_phase("executed", 7, 7)  # never opened
        regs.append(reg.render_prometheus())
    assert regs[0] == regs[1]
    assert 'pbft_request_reply_seconds_count{replica="2"} 5' in regs[0]
    # A replica's scrape before any traffic: every manifest series, as the
    # JAX replica's (the runtime's own gauges included).
    text, seeds = _cluster_json()
    servers = [AsyncReplicaServer(ClusterConfig.from_json(text), 1, seeds[1], verifier="cpu", metrics_port=0),
               JaxServer(JaxClusterConfig.from_json(text), 1, seeds[1], verifier="cpu", metrics_port=0)]
    scrapes = [s.metrics_registry.render_prometheus() for s in servers]
    assert scrapes[0] == scrapes[1]
    assert {ln.split()[2] for ln in scrapes[0].splitlines() if ln.startswith("# TYPE ")} == set(
        trace_schema.METRIC_SCHEMAS)
    assert metrics.file_size_bytes(None) == 0 and metrics.count_open_fds() > 0 and metrics.read_rss_bytes() > 0
    assert gateway.GATEWAY_CLIENT_PREFIX == "gw/"


# -- clusters ----------------------------------------------------------------


async def _stop_all(servers) -> None:
    # Dialed links first, so that no server waits on another's inbound link.
    for s in servers:
        for link in list(s._peer_links.values()):
            link.writer.close()
    try:
        await asyncio.wait_for(asyncio.gather(*(s.stop() for s in servers)), 10)
    except asyncio.TimeoutError:
        pass


def test_port_and_jax_replicas_commit_together_in_one_loop():
    text, seeds = _cluster_json()
    port_cfg, jax_cfg = ClusterConfig.from_json(text), JaxClusterConfig.from_json(text)

    async def run():
        servers = [JaxServer(jax_cfg, i, seeds[i], verifier=_oracle_verify) for i in (0, 1)]
        servers += [AsyncReplicaServer(port_cfg, i, seeds[i], verifier=_oracle_verify) for i in (2, 3)]
        for s in servers:
            await s.start()
        client = PbftClient(port_cfg)
        try:
            results = await asyncio.get_running_loop().run_in_executor(
                None, lambda: [client.request_with_retry(f"op-{i}", timeout=30) for i in range(3)])
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and any(s.replica.executed_upto < 3 for s in servers):
                await asyncio.sleep(0.05)
            states = [(s.replica.view, s.replica.executed_upto, s.replica.state_digest.hex(),
                       s.replica.committed_chain.hex()) for s in servers]
            checks = [s.replica.counters["sig_verified"] + s.replica.counters["sig_rejected"] for s in servers]
        finally:
            client.close()
            await _stop_all(servers)
        return results, states, checks

    results, states, checks = asyncio.run(run())
    assert results == ["awesome!"] * 3
    assert states[0][1] == 3 and all(s == states[0] for s in states), states
    assert all(c > 0 for c in checks)


@pytest.mark.parametrize("impl", ["py", ["cxx", "py", "cxx", "py"], ["thread", "py", "cxx", "thread"]],
                         ids=["py", "cxx-py", "thread-py-cxx"])
def test_local_cluster_commits_with_port_replicas(impl):
    with LocalCluster(n=4, verifier="cpu", impl=impl, metrics_every=1) as cluster:
        client = PbftClient(cluster.config)
        try:
            assert [client.request_with_retry(f"op-{i}", timeout=30) for i in range(3)] == ["awesome!"] * 3
        finally:
            client.close()
        for i, t in cluster.threads.items():
            m = t.metrics()
            assert m["replica"] == i and m["verify_batches"] > 0 and m["net_backend"] == "asyncio"
        logs = cluster.logs()
        t0 = time.monotonic()
    # Two replicas on threads stop together without waiting on each other's
    # links (each closes its dialed links before it waits for its own).
    assert time.monotonic() - t0 < 3.0
    for i, kind in enumerate([impl] * 4 if isinstance(impl, str) else impl):
        if kind == "py":
            assert re.search(rf"async replica {i} listening on \d+ \(verifier=cpu\)", logs), logs


def test_free_ports_avoid_each_other_and_the_ephemeral_range():
    # Replica and metrics ports are handed out before the replicas bind
    # them: the second set must miss the first, and both must stay out of
    # the range that outgoing connections take their local ports from.
    from pbft_tpu_torch.net import launcher

    first = free_ports(64)
    second = free_ports(64, avoid=set(first))
    assert len(set(first)) == len(set(second)) == 64 and not set(first) & set(second)
    low = launcher._ephemeral_low()
    if low > 2048:
        assert all(1024 <= p < low for p in first + second)
    for p in second:
        with socket.socket() as s:
            s.bind(("0.0.0.0", p))


def test_gateway_client_commits_through_the_ports_gateway():
    with LocalCluster(n=4, verifier="cpu", impl="py") as cluster:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pbft_tpu_torch.net.gateway", "--config",
             str(Path(cluster.tmpdir.name) / "network.json"), "--port", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=_REPO,
            env=dict(os.environ, PYTHONPATH=str(_REPO)),
        )
        try:
            line = proc.stdout.readline()
            m = re.search(r"gateway listening on (\d+)", line)
            assert m, line
            client = gateway.GatewayClient(cluster.config, f"127.0.0.1:{m.group(1)}")
            try:
                assert client.address.startswith(gateway.GATEWAY_CLIENT_PREFIX)
                assert client.request_many(["a", "b"], window=2, timeout=20) == ["awesome!"] * 2
            finally:
                client.close()
        finally:
            proc.terminate()
            proc.wait(10)


# -- the entry point ---------------------------------------------------------


def test_cli_defaults_to_cuda_and_raises_before_listening(tmp_path):
    text, seeds = _cluster_json()
    cfg = tmp_path / "network.json"
    cfg.write_text(text)
    port = ClusterConfig.from_json(text).identity(0).port
    # No card visible: the default verifier must refuse to start.
    proc = subprocess.run(
        [sys.executable, "-m", "pbft_tpu_torch.net.server", "--config", str(cfg), "--id", "0",
         "--seed", seeds[0].hex()],
        capture_output=True, text=True, timeout=120, cwd=_REPO,
        env=dict(os.environ, PYTHONPATH=str(_REPO), CUDA_VISIBLE_DEVICES=""),
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr and "listening" not in proc.stdout, proc.stderr[-2000:]
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=1).close()


def test_cpu_replica_imports_no_torch(tmp_path):
    text, seeds = _cluster_json()
    code = (
        "import sys, time; t = time.perf_counter()\n"
        "from pbft_tpu_torch.consensus.config import ClusterConfig\n"
        "from pbft_tpu_torch.net.server import AsyncReplicaServer\n"
        f"s = AsyncReplicaServer(ClusterConfig.from_json({text!r}), 0, bytes.fromhex({seeds[0].hex()!r}),"
        " verifier='cpu')\n"
        "print(sorted(m for m in ('torch', 'numpy', 'jax') if m in sys.modules), time.perf_counter() - t)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60, cwd=_REPO,
                         env=dict(os.environ, PYTHONPATH=str(_REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("]")[0] == "[", out.stdout
    with pytest.raises(ValueError, match="unknown verifier"):
        AsyncReplicaServer(ClusterConfig.from_json(text), 0, seeds[0], verifier="tpu")


# -- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_cuda_cluster_commits_on_the_card(card):
    native.build()
    with LocalCluster(n=4, verifier="cuda", impl="py", metrics_every=1) as cluster:
        client = PbftClient(cluster.config)
        try:
            client.request_with_retry("warmup", timeout=300, retry_every=5)
            assert client.request_many([f"op-{i}" for i in range(10)], window=4, timeout=60) == ["awesome!"] * 10
        finally:
            client.close()
        logs = cluster.logs()
    assert logs.count("(verifier=cuda)") == 4, logs


@pytest.mark.cuda
def test_in_process_replica_launches_once_per_window(card):
    from pbft_tpu_torch.crypto import batch
    from pbft_tpu_torch.crypto import kernels as K

    native.build()
    with LocalCluster(n=4, verifier="cuda", impl=["thread", "py", "py", "py"]) as cluster:
        server = cluster.threads[0].server
        client = PbftClient(cluster.config)
        try:
            client.request_with_retry("warmup", timeout=300, retry_every=5)
            time.sleep(1.0)
            for k in (1, 17, 65):  # shapes 16, 64 and 256, captured before the count
                batch.verify_many([batch.PAD_ITEM] * k)
            windows0 = server.batches_run
            K.reset_launches()
            assert [client.request_with_retry(f"op-{i}", timeout=60) for i in range(5)] == ["awesome!"] * 5
            time.sleep(1.0)
            windows = server.batches_run - windows0
            got = dict(K.LAUNCHES)
        finally:
            client.close()
    assert windows > 0 and got == {k: windows for k in K.KERNELS}, (windows, got)
