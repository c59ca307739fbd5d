"""PBFT clusters on the port's verifier, on the card (``-m cuda``; skips
without one). Nothing here imports JAX, so the file runs on the card's
machine with ``--noconftest``.

(a) A ``pbft_tpu.net.LocalCluster`` of four replicas (f = 1) ships its
signature batches to the port's daemon (``VerifyServiceDaemon``,
backend ``cuda``, warmed first, metrics on): twenty requests commit with
f + 1 matching replies, the daemon verified items and its fallback none,
and its scrape counts what its status counts. First four ``pbftd``
replicas (``core/verifier.cc`` RemoteVerifier), then two ``pbftd`` and two
asyncio replicas (which dial it through the JAX package's
ServiceVerifier).

(b) The port's own ``LocalCluster``/``PbftClient`` and harness
(``pbft_tpu_torch.bench.harness``) drive ``pbftd`` clusters through the
port's daemon on the card: config 0 commits, the daemon verified every
signature the replicas checked (none on the host), and a cluster with a
Byzantine signer commits while the daemon rejects its signatures.

(c) The in-memory ``pbft_tpu.consensus.simulation.Cluster`` with the
port's ``cuda_backend`` as its verifier runs the README's demo request:
replies and signature verifications equal a run on the host oracle.
"""

import time
import urllib.request

import pytest
import torch

from pbft_tpu.consensus.simulation import Cluster
from pbft_tpu.net import LocalCluster, PbftClient
from pbft_tpu_torch import native
from pbft_tpu_torch.bench import harness
from pbft_tpu_torch.net.client import PbftClient as PortClient
from pbft_tpu_torch.net.launcher import LocalCluster as PortCluster
from pbft_tpu_torch.net.service import cuda_backend
from pbft_tpu_torch.net.verify_service import VerifyServiceDaemon, probe_status_json

REQUESTS = 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _scraped_items(daemon) -> int:
    url = f"http://127.0.0.1:{daemon.service.metrics_listen_port}/metrics"
    with urllib.request.urlopen(url, timeout=10) as r:
        for line in r.read().decode().splitlines():
            if line.startswith('pbft_verify_items_total{replica="service"} '):
                return int(line.split()[-1])
    raise AssertionError("pbft_verify_items_total is not in the scrape")


def _settled_status(daemon) -> dict:
    """The daemon's status once its item count holds still for half a
    second (a replica shutting down may still have a batch in flight)."""
    last = probe_status_json(daemon.address)
    for _ in range(60):
        time.sleep(0.5)
        now = probe_status_json(daemon.address)
        if now["items"] == last["items"]:
            return now
        last = now
    raise AssertionError(f"the daemon's item count never settled: {last}")


def commit_through(daemon, impl) -> dict:
    """Twenty requests through a four-replica cluster whose verifier is
    ``daemon``; the daemon's status before and after."""
    before = probe_status_json(daemon.address)
    with LocalCluster(n=4, verifier=daemon.address, impl=impl) as cluster:
        client = PbftClient(cluster.config)
        try:
            reqs = [client.request(f"op-{i}") for i in range(REQUESTS)]
            for r in reqs:
                assert client.wait_result(r.timestamp, timeout=60) == "awesome!"
        finally:
            client.close()
    return {"before": before, "after": _settled_status(daemon)}


@pytest.mark.cuda
def test_pbftd_cluster_commits_through_the_port_daemon(cuda_device):
    native.build()  # pbftd, in parallel, before the launcher looks for it
    daemon = VerifyServiceDaemon(backend="cuda", metrics_port=0).start(wait_ready=True, timeout=600)
    try:
        for impl in ("cxx", ["cxx", "cxx", "py", "py"]):
            run = commit_through(daemon, impl)
            after = run["after"]
            assert after["state"] == "ready", after
            assert after["items"] > run["before"]["items"], (impl, run)
            assert after["fallback_items"] == 0, after
            assert _scraped_items(daemon) == after["items"] == probe_status_json(daemon.address)["items"]
    finally:
        daemon.stop()


@pytest.mark.cuda
def test_port_harness_commits_through_the_port_daemon_on_the_card(cuda_device):
    native.build()
    daemon = harness.start_daemon("cuda")
    try:
        res = harness.run_native_cuda_config(0, requests=REQUESTS, daemon=daemon)
        assert (res.verifier, res.requests) == ("native-cuda", REQUESTS)
        assert res.service_items > 0 and res.service_fallback_items == 0
        acc = res.accounting
        assert acc["service_items"] == acc["replica_sig_checks"] and acc["service_fallback_items"] == 0
        assert acc["verify_deadline_fired"] == 0
        before = probe_status_json(daemon.address)
        with PortCluster(n=4, verifier=daemon.address, byzantine=[3]) as cluster:
            client = PortClient(cluster.config)
            try:
                assert client.request_many([f"byz-{k}" for k in range(8)], window=4, timeout=60) == ["awesome!"] * 8
            finally:
                client.close()
        after = _settled_status(daemon)
        assert after["rejected"] > before["rejected"] and after["fallback_items"] == 0
    finally:
        daemon.stop()


@pytest.mark.cuda
def test_simulated_cluster_on_the_card_equals_the_host_oracle(cuda_device):
    runs = {}
    for name, verifier in (("cuda", cuda_backend), ("cpu", "cpu")):
        c = Cluster(n=4, verifier=verifier)
        req = c.submit("hello pbft")
        c.run()
        assert c.committed_result(req.timestamp) == "awesome!"
        runs[name] = (c.replies_for(req.timestamp), c.sig_verifications)
    assert runs["cuda"] == runs["cpu"]
    assert runs["cuda"][1] > 0 and len(runs["cuda"][0]) == 4
