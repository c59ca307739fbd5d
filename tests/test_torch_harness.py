"""The port's protocol path on the CPU: its copies of the cluster
configuration, the client messages and the harness tables against the JAX
package's (same inputs, made from a numpy seed), then real ``pbftd``
clusters (built by the port's ``native.build()``) through the port's
verify service with the ``native`` backend, an honest one through
``run_native_cuda_config`` and one with a Byzantine signer. Nothing here
runs the plain torch verifier; the card's arm is ``-m cuda`` in
``tests/test_torch_cluster.py``."""

import dataclasses
import json

import numpy as np
import pytest

from pbft_tpu.bench import harness as jax_harness
from pbft_tpu.consensus import config as jax_config
from pbft_tpu.consensus import messages as jax_messages
from pbft_tpu.crypto import ref as jax_ref
from pbft_tpu.utils import waterfall as jax_waterfall
from pbft_tpu_torch import native
from pbft_tpu_torch.bench import harness
from pbft_tpu_torch.consensus import config, messages
from pbft_tpu_torch.crypto import ref
from pbft_tpu_torch.net.client import PbftClient
from pbft_tpu_torch.net.launcher import LocalCluster
from pbft_tpu_torch.net.verify_service import probe_status_json
from pbft_tpu_torch.utils import waterfall

SEED = 0x6B7


@pytest.mark.parametrize("n", [4, 7, 31])
def test_cluster_config_json_is_byte_identical(n):
    rng = np.random.default_rng(SEED + n)
    port_cfg, port_seeds = config.make_local_cluster(n)
    jax_cfg, jax_seeds = jax_config.make_local_cluster(n)
    assert port_seeds == jax_seeds
    assert port_cfg.to_json() == jax_cfg.to_json()
    # The keys pbftd reads and the harness sets, at random values.
    knobs = dict(
        verify_flush_us=int(rng.integers(0, 10**6)),
        verify_flush_items=int(rng.integers(0, 4097)),
        batch_max_items=int(rng.integers(1, 64)),
        batch_flush_us=int(rng.integers(0, 10**4)),
        verifier=f"127.0.0.1:{int(rng.integers(1024, 65536))}",
        secure=bool(rng.integers(0, 2)),
    )
    ports = [int(p) for p in rng.integers(1024, 65536, size=n)]
    port_cfg = dataclasses.replace(
        port_cfg, replicas=[dataclasses.replace(r, port=p) for r, p in zip(port_cfg.replicas, ports)], **knobs
    )
    jax_cfg = dataclasses.replace(
        jax_cfg, replicas=[dataclasses.replace(r, port=p) for r, p in zip(jax_cfg.replicas, ports)], **knobs
    )
    text = port_cfg.to_json()
    assert text == jax_cfg.to_json()
    assert config.ClusterConfig.from_json(text) == port_cfg
    assert jax_config.ClusterConfig.from_json(text) == jax_cfg
    assert (port_cfg.n, port_cfg.f, port_cfg.primary_of(n + 1)) == (jax_cfg.n, jax_cfg.f, jax_cfg.primary_of(n + 1))
    # Every key is settable, as in the JAX package: a file that sets
    # net_threads round-trips byte for byte.
    text = dataclasses.replace(jax_cfg, net_threads=4).to_json()
    assert config.ClusterConfig.from_json(text).net_threads == 4
    assert config.ClusterConfig.from_json(text).to_json() == text


def test_client_messages_are_byte_identical():
    rng = np.random.default_rng(SEED)
    seed = rng.bytes(32)
    assert ref.public_key(seed) == jax_ref.public_key(seed)
    ops = ["op-0", "awesome!", 'quote " and \\ backslash', "unicode é ☃", ""]
    for k, op in enumerate(ops):
        ts = int(rng.integers(0, 2**62))
        client = f"127.0.0.1:{int(rng.integers(1024, 65536))}"
        pairs = [
            (messages.ClientRequest(op, ts, client), jax_messages.ClientRequest(op, ts, client)),
        ]
        for tentative in (0, 1):
            fields = dict(view=int(rng.integers(0, 9)), timestamp=ts, client=client, replica=k, result=op,
                          sig=rng.bytes(64).hex(), tentative=tentative)
            pairs.append((messages.ClientReply(**fields), jax_messages.ClientReply(**fields)))
        for port_msg, jax_msg in pairs:
            assert port_msg.canonical() == jax_msg.canonical()
            assert port_msg.signable() == jax_msg.signable()
            assert messages.to_wire(port_msg) == jax_messages.to_wire(jax_msg)
            assert ref.sign(seed, port_msg.signable()) == jax_ref.sign(seed, jax_msg.signable())
            assert messages.from_wire(jax_messages.to_wire(jax_msg)[4:]) == port_msg
        assert b"tentative" not in pairs[1][0].canonical() and b'"tentative":1' in pairs[2][0].canonical()
    with pytest.raises(ValueError, match="int64"):
        messages.from_wire(b'{"type":"client-request","operation":"x","timestamp":9223372036854775808,"client":"c"}')


def test_harness_tables_and_row_fields_equal_the_jax_harness():
    assert harness.CONFIGS == jax_harness.CONFIGS
    assert harness.PIPELINE == jax_harness.PIPELINE
    jax_fields = [f.name for f in dataclasses.fields(jax_harness.BenchResult)]
    port_fields = [f.name for f in dataclasses.fields(harness.BenchResult)]
    assert port_fields[: len(jax_fields)] == jax_fields
    assert port_fields[len(jax_fields):] == [
        "service_items", "service_windows", "service_rejected", "service_fallback_items",
        "service_items_per_window", "accounting", "capture_s", "invariant_s",
    ]
    args = dict(config="c", replicas=4, f=1, clients=1, requests=2, seconds=1.0, rounds_per_sec=2.0,
                sig_verifies_per_sec=3.0, sig_verifications=3, verifier="native")
    row = json.loads(harness.BenchResult(**args).to_json())
    assert set(json.loads(jax_harness.BenchResult(**args).to_json())) <= set(row)


def test_waterfall_join_equals_the_jax_package():
    rng = np.random.default_rng(SEED + 1)
    events, records = [], []
    for k in range(40):
        client, ts, view, seq = f"c{k % 3}", k, 0, k // 2 + 1
        t = float(k)
        records.append({"client": client, "req_ts": ts, "send": t, "quorum": t + float(rng.random())})
        events.append({"ev": "request_rx", "client": client, "req_ts": ts, "ts": t + 0.01})
        events.append({"ev": "batch_sealed", "view": view, "seq": seq, "replica": 0, "ts": t + 0.02, "batch": 2,
                       "reqs": [[client, ts]]})
        stamps = np.cumsum(rng.random(4)) + t + 0.02
        events.append({"ev": "consensus_span", "view": view, "seq": seq, "replica": 0,
                       **dict(zip(("pre_prepare", "prepared", "committed", "executed"), stamps.tolist()))})
    assert waterfall.build_waterfall(events, records) == jax_waterfall.build_waterfall(events, records)


def test_unknown_arms_raise_and_the_card_arm_needs_a_card(monkeypatch):
    import torch

    with pytest.raises(ValueError, match="unknown arm"):
        harness.run_all("native-tpu")
    with pytest.raises(ValueError, match="unknown arm"):
        harness.run_config("jax", 0)
    with pytest.raises(SystemExit):
        harness.main(["--arm", "native-tpu", "--config", "0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        harness.run_native_cuda_config(0, requests=1)


def test_pbftd_clusters_commit_through_the_port_daemon(tmp_path):
    """Config 0 through run_native_cuda_config on a daemon with the native
    backend: every request commits, the daemon verified every signature
    the replicas checked and its fallback none; then a four-replica cluster
    with a Byzantine signer commits through the same daemon, which rejects
    that replica's signatures; then config 3's sixteen replicas verify every
    signature on the daemon; then the CLI's row."""
    native.build()
    daemon = harness.start_daemon("native", trace_dir=str(tmp_path / "traces"))
    try:
        res = harness.run_native_cuda_config(0, requests=6, trace_dir=str(tmp_path / "traces"),
                                             service_backend="native", daemon=daemon)
        assert (res.verifier, res.replicas, res.f, res.requests, res.byzantine) == ("native-svc", 4, 1, 6, False)
        assert res.service_items > 0 and res.service_windows > 0 and res.service_fallback_items == 0
        assert res.service_items_per_window == res.service_items / res.service_windows
        acc = res.accounting
        assert acc["service_items"] == acc["replica_sig_checks"] > res.service_items
        assert acc["service_fallback_items"] == acc["verify_deadline_fired"] == acc["view_changes_started"] == 0
        assert res.service_rejected == acc["replica_sig_rejected"] == 0
        assert 0 < res.reply_p50_ms <= res.reply_p99_ms
        assert res.latency_segments_ms["prepared"]["count"] == 6
        assert (tmp_path / "traces-service" / "service.jsonl").stat().st_size > 0

        before = probe_status_json(daemon.address)
        with LocalCluster(n=4, verifier=daemon.address, byzantine=[3]) as cluster:
            client = PbftClient(cluster.config)
            try:
                assert client.request_many([f"byz-{k}" for k in range(4)], window=2, timeout=30) == ["awesome!"] * 4
            finally:
                client.close()
        after = probe_status_json(daemon.address)
        assert after["rejected"] > before["rejected"] and after["fallback_items"] == 0

        # Sixteen replicas dial the service at once: none may miss its
        # connect deadline and verify on its own pool.
        res = harness.run_native_cuda_config(3, requests=8, service_backend="native", daemon=daemon)
        assert res.replicas == 16 and res.accounting["service_items"] == res.accounting["replica_sig_checks"]
    finally:
        daemon.stop()
    out = tmp_path / "row.jsonl"
    harness.main(["--arm", "native-cuda", "--service-backend", "native", "--config", "0", "--requests", "3",
                  "--out", str(out)])
    row = json.loads(out.read_text())
    assert row["verifier"] == "native-svc" and row["requests"] == 3 and row["service_items"] > 0
