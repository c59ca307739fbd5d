"""The port's health detectors (pbft_tpu_torch/analysis/health.py) against
the JAX package's (pbft_tpu/analysis/health.py), and the port's pbft_top
gate on live clusters of the port's asyncio replicas.

1. Every scenario of tests/test_health.py: the same seeded synthetic
   histories (the /status health-document shape) go through both
   packages' detectors, which must return equal verdict lists — and each
   scenario must trip (or stay quiet) as the reference's test says, so a
   scenario that silently stopped exercising its detector fails here too.
   The thresholds of both modules are equal.
2. Live: ``python -m pbft_tpu_torch.scripts.pbft_top --gate --once``
   exits 0 on a healthy loaded cluster of the port's replicas (host
   verify pools), and 1 with a silent-stall verdict naming replica 0 when
   the primary is muted and holds sealed work it can never execute.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from pbft_tpu.analysis import health as jax_health
from pbft_tpu_torch.analysis import health

REPO = pathlib.Path(__file__).resolve().parent.parent


# -- synthetic histories (tests/test_health.py's builders) --------------------

def _doc(executed=0, committed=None, inbox=0, sealed=0, waiting=0,
         view=0, in_vc=False, rss=100 << 20, fds=20, wal=4096,
         digest="aa" * 32):
    return {
        "health_version": 1,
        "executed_upto": executed,
        "committed_upto": executed if committed is None else committed,
        "inbox_depth": inbox,
        "sealed_unexecuted": sealed,
        "waiting_requests": waiting,
        "view": view,
        "in_view_change": in_vc,
        "rss_bytes": rss,
        "open_fds": fds,
        "wal_disk_bytes": wal,
        "chain_digest": digest,
    }


def _history(per_tick, ticks, n=4, dt=1.0):
    """history from per_tick(t_index, rid) -> doc (or None to omit)."""
    out = []
    for i in range(ticks):
        docs = {}
        for rid in range(n):
            doc = per_tick(i, rid)
            if doc is not None:
                docs[rid] = doc
        out.append({"t": i * dt, "replicas": docs})
    return out


def _jitter(history, seed):
    """The same history with seeded sub-tick jitter on the timestamps and
    the resource readings (allocator breathing), so the parity holds off
    the round numbers too."""
    rng = np.random.default_rng(seed)
    out = []
    for snap in history:
        docs = {}
        for rid, doc in snap["replicas"].items():
            doc = dict(doc)
            doc["rss_bytes"] += int(rng.integers(0, 1 << 18))
            docs[rid] = doc
        out.append({"t": snap["t"] + float(rng.uniform(0, 0.05)), "replicas": docs})
    return out


def _stall(i, rid):
    return _doc(executed=30, sealed=4) if rid == 2 else _doc(executed=30 + 10 * i)


def _fd_ramp(i, rid):
    return _doc(executed=10 * i, fds=20 + (6 * i if rid == 1 else 0))


def _dead(i, rid):
    if rid == 3 and i >= 3:
        return None
    return _doc(executed=10 * i, inbox=1)


# name -> (detector, history, kwargs, replicas the verdicts must name)
SCENARIOS = {
    "healthy": ("run_detectors", _history(
        lambda i, rid: _doc(executed=10 * i, inbox=2 if i % 3 else 0), 12), {}, []),
    "stall": ("detect_silent_stall", _history(_stall, 10), {"stall_seconds": 5}, [2]),
    "idle": ("detect_silent_stall", _history(lambda i, rid: _doc(executed=30), 10), {"stall_seconds": 5}, []),
    "idle-blips": ("detect_silent_stall", _history(
        lambda i, rid: _doc(executed=30, inbox=1 if i % 2 else 0), 10), {"stall_seconds": 5}, []),
    "fd-ramp": ("detect_resource_leak", _history(_fd_ramp, 12), {}, [1]),
    "noise-breathing": ("detect_resource_leak", _history(
        lambda i, rid: _doc(executed=10 * i, rss=(100 << 20) + (i % 3) * (1 << 20)), 12), {}, []),
    "noise-spike": ("detect_resource_leak", _history(
        lambda i, rid: _doc(executed=10 * i, fds=200 if i == 6 else 20), 12), {}, []),
    "noise-zeros": ("detect_resource_leak", _history(
        lambda i, rid: _doc(executed=10 * i, rss=0, wal=0), 12), {}, []),
    "divergence": ("detect_divergence", _history(
        lambda i, rid: _doc(executed=50, digest="bb" * 32 if rid == 3 else "aa" * 32), 6), {}, [None]),
    "lag": ("detect_divergence", _history(
        lambda i, rid: _doc(executed=20 if rid == 3 else 50, digest="cc" * 32 if rid == 3 else "aa" * 32), 6),
        {}, []),
    "stuck-view-change": ("detect_stuck_view_change", _history(
        lambda i, rid: _doc(executed=30, view=4, in_vc=(rid == 0)), 10), {"stall_seconds": 5}, [0]),
    "advancing-view-change": ("detect_stuck_view_change", _history(
        lambda i, rid: _doc(executed=30, view=i // 2, in_vc=True), 10), {"stall_seconds": 5}, []),
    "saturation": ("detect_queue_saturation", _history(
        lambda i, rid: _doc(executed=10 * i, inbox=600 if rid == 1 else 3), 10), {}, [1]),
    "saturation-dip": ("detect_queue_saturation", _history(
        lambda i, rid: _doc(executed=10 * i, inbox=600 if i % 3 else 10), 10), {}, []),
    "stall-and-fork": ("run_detectors", _history(
        lambda i, rid: _doc(executed=30, sealed=2 if rid == 0 else 0, digest="dd" * 32 if rid == 1 else "aa" * 32),
        10), {"stall_seconds": 5}, [0, None]),
    "stall-and-fork-loose": ("run_detectors", _history(
        lambda i, rid: _doc(executed=30, sealed=2 if rid == 0 else 0, digest="dd" * 32 if rid == 1 else "aa" * 32),
        10), {"stall_seconds": 100}, [None]),
    "dead-replica": ("run_detectors", _history(_dead, 10), {}, []),
    "fd-ramp-jittered": ("run_detectors", _jitter(_history(_fd_ramp, 12), seed=16), {}, [1]),
    "stall-jittered": ("run_detectors", _jitter(_history(_stall, 10), seed=17), {"stall_seconds": 5}, [2]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_detectors_match_the_reference(name):
    detector, history, kwargs, replicas = SCENARIOS[name]
    got = getattr(health, detector)(history, **kwargs)
    want = getattr(jax_health, detector)(history, **kwargs)
    assert got == want
    assert [v["replica"] for v in got] == replicas, got


@pytest.mark.parametrize("points", [
    [], [(0, 1)], [(0, 0), (1, 2), (2, 4), (3, 6)], [(0, 0), (1, 1), (2, 2), (3, 3), (4, 1000)],
    [(float(t), float(v)) for t, v in enumerate(np.random.default_rng(9).normal(0, 5, 20).cumsum())],
])
def test_theil_sen_matches_the_reference(points):
    assert health.theil_sen_slope(points) == jax_health.theil_sen_slope(points)


def test_thresholds_match_the_reference():
    names = [n for n in dir(jax_health) if n.isupper() and n != "ALL_DETECTORS"]
    assert names == [n for n in dir(health) if n.isupper() and n != "ALL_DETECTORS"]
    for n in names:
        assert getattr(health, n) == getattr(jax_health, n), n
    assert health.HEALTH_STALL_SECONDS == 5 and health.HEALTH_SNAPSHOT_INTERVAL_S == 2
    assert [d.__name__ for d in health.ALL_DETECTORS] == [d.__name__ for d in jax_health.ALL_DETECTORS]


def _sim_history(mute_primary, ticks=60):
    """The port's simulator with the reference test's schedule: a request
    targeted at replica 0, snapshotted in the health-document shape."""
    from pbft_tpu_torch.consensus.simulation import Cluster

    c = Cluster(n=4, seed=16, app=lambda op, seq: op)
    if mute_primary:
        c.set_fault(0, "mute")
    c.submit("sim-doomed", to_replica=0)
    history = []
    for t in range(ticks):
        c.run(max_steps=5)
        history.append({
            "t": float(t),
            "replicas": {
                r.id: {
                    "executed_upto": r.executed_upto,
                    "committed_upto": r.committed_upto,
                    "inbox_depth": r.pending_count(),
                    "sealed_unexecuted": max(0, r.seq_counter - r.executed_upto),
                    "waiting_requests": 0,
                    "chain_digest": r.committed_chain.hex(),
                }
                for r in c.replicas
            },
        })
    return history


@pytest.mark.parametrize("mute", [True, False])
def test_simulated_muted_primary_matches_the_reference(mute):
    hist = _sim_history(mute)
    got = health.detect_silent_stall(hist, stall_seconds=20)
    assert got == jax_health.detect_silent_stall(hist, stall_seconds=20)
    assert any(v["replica"] == 0 for v in got) == mute, got
    assert health.detect_divergence(hist) == jax_health.detect_divergence(hist) == []


# -- live: the port's pbft_top gate on the port's replicas ---------------------

def _run_top_gate(ports, stall_seconds=2, window_s=4):
    targets = ",".join(f"127.0.0.1:{p}" for p in ports)
    return subprocess.run(
        [sys.executable, "-m", "pbft_tpu_torch.scripts.pbft_top", "--targets", targets,
         "--gate", "--once", "--interval", "0.5",
         "--stall-seconds", str(stall_seconds), "--window-s", str(window_s)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )


def test_pbft_top_gate_passes_a_healthy_cluster():
    from pbft_tpu_torch.net.client import PbftClient
    from pbft_tpu_torch.net.launcher import LocalCluster

    with LocalCluster(n=4, impl="py", verifier="cpu", metrics_ports=True) as c:
        cl = PbftClient(c.config)
        try:
            for k in range(3):
                req = cl.request(f"health-smoke-{k}")
                assert cl.wait_result(req.timestamp, timeout=30) is not None
        finally:
            cl.close()
        proc = _run_top_gate(c.metrics_ports)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    assert verdict["ok"] is True and verdict["verdicts"] == []
    assert verdict["snapshots"] >= 2


def test_pbft_top_gate_catches_a_muted_primary():
    from pbft_tpu_torch.net.client import PbftClient
    from pbft_tpu_torch.net.launcher import LocalCluster

    with LocalCluster(n=4, impl="py", verifier="cpu", metrics_ports=True, faults={0: "mute"}) as c:
        cl = PbftClient(c.config)
        try:
            cl.request("doomed", to_replica=0)  # sealed by 0, never executed
            proc = _run_top_gate(c.metrics_ports)
        finally:
            cl.close()
    assert proc.returncode == 1, proc.stdout + proc.stderr
    verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    assert verdict["ok"] is False
    stalls = [v for v in verdict["verdicts"] if v["detector"] == "silent-stall"]
    assert any(str(v["replica"]) == "0" for v in stalls), verdict


def test_status_document_is_built_on_the_replicas_loop():
    """C5: /status (and a thread replica's metrics()) build the health
    document on the replica's event loop, never on the scrape thread, so
    committed_upto and chain_digest are one moment of the replica."""
    import threading
    import urllib.request

    from pbft_tpu_torch.net.client import PbftClient
    from pbft_tpu_torch.net.launcher import LocalCluster

    with LocalCluster(n=4, impl=["thread", "py", "py", "py"], verifier="cpu", metrics_ports=True) as c:
        replica = c.threads[0]
        server = replica.server
        built_on = []
        metrics = server.metrics

        def recording():
            built_on.append(threading.current_thread().name)
            return metrics()

        server.metrics = recording
        cl = PbftClient(c.config)
        try:
            req = cl.request("torn")
            assert cl.wait_result(req.timestamp, timeout=30) is not None
        finally:
            cl.close()
        with urllib.request.urlopen(f"http://127.0.0.1:{c.metrics_ports[0]}/status", timeout=5) as resp:
            doc = json.loads(resp.read().decode())
        line = replica.metrics()
    assert doc["replica"] == 0 and doc["committed_upto"] >= 1 and line["replica"] == 0
    assert built_on == ["replica-0", "replica-0"], built_on


def _server(vc_timeout=0.6, tentative=False):
    """An unstarted AsyncReplicaServer (replica 3 of 4) on the host pool."""
    import dataclasses

    from pbft_tpu_torch.consensus.config import make_local_cluster
    from pbft_tpu_torch.net.server import AsyncReplicaServer

    config, seeds = make_local_cluster(4, base_port=0)
    config = dataclasses.replace(config, tentative=tentative)
    return AsyncReplicaServer(config, 3, seeds[3], verifier="cpu", vc_timeout=vc_timeout)


def test_gap_commits_credit_the_view_timer_up_to_the_checkpoint():
    """C6: a replica revived with fresh state holds sequences committed in
    its view above a gap it cannot execute until the next checkpoint's
    state transfer. Each newly committed sequence there counts as progress
    for the view timer, up to that checkpoint and no further (a primary
    that skips a sequence delays the view change by at most one
    checkpoint interval); without a gap, and in tentative mode, only the
    progress marker counts."""
    server = _server()
    replica = server.replica
    assert replica.config.checkpoint_interval == 16 and replica.executed_upto == 0
    ticks = [server._timer_progress()]
    for seq in range(54, 70):  # revived at seq 54: 1-53 missing, checkpoint 64 closes the gap
        replica.pending_execution[seq] = (0, "d")
        ticks.append(server._timer_progress())
    assert server._gap_commits() == 64
    steps = [b - a for a, b in zip(ticks, ticks[1:])]
    assert steps == [1] * 11 + [0] * 5, steps  # 54..64 credited, 65..69 not
    assert server._timer_progress() == ticks[-1]  # nothing new: no progress
    # execution advancing is progress; no gap, no credit
    replica.pending_execution.clear()
    replica.executed_upto = 69
    assert server._timer_progress() == ticks[-1] + 1 and server._gap_commits() == 0
    replica.pending_execution[71] = (0, "d")  # a gap of one sequence: credit up to 80
    assert server._gap_commits() == 71
    replica.in_view_change = True
    assert server._gap_commits() == 0
    tentative = _server(tentative=True)
    tentative.replica.pending_execution[54] = (0, "d")
    assert tentative._gap_commits() == 0


def test_requests_executed_by_the_state_release_the_view_timer():
    """C6: a request this replica forwarded and the replicated state has
    executed (here: last_timestamp says so, as after a state transfer)
    leaves the progress timer's waiting set at the next tick, and the
    replica does not start a view change over it; a request that is not
    executed still escalates."""
    import asyncio
    import time as _time

    async def drive(executed):
        server = _server(vc_timeout=0.2)
        server._loop = asyncio.get_running_loop()
        server.replica.last_timestamp["gw/client"] = 5 if executed else 2
        server._waiting_requests[("gw/client", 3)] = _time.monotonic() + 0.2
        task = asyncio.get_running_loop().create_task(server._timer_loop())
        await asyncio.sleep(1.2)
        server._stopping = True
        await asyncio.sleep(0.1)
        task.cancel()
        return dict(server._waiting_requests), server.replica.in_view_change

    waiting, vc = asyncio.run(drive(executed=True))
    assert waiting == {} and vc is False
    waiting, vc = asyncio.run(drive(executed=False))
    assert ("gw/client", 3) in waiting and vc is True
