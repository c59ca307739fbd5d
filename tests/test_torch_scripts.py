"""The port's operator scripts (pbft_tpu_torch/scripts/) against the
reference's (scripts/), on the CPU, and the build cache's host key.

- chaos_bench: the fault-free arm end to end on the port's asyncio
  replicas (n = 4, 4 clients x 15 requests): each replica's host verify
  pool (``--verifier cpu``), and a verify daemon on the native backend,
  whose items must equal the replicas' signature checks with no fallback.
  Its pure parts (the view-change latency join, the arms and their
  completion bars) equal the reference's on the same events.
- trace_report, consensus_timeline and flight_dump, run as subprocesses
  over the traces and flight dumps of one small cluster of the port's
  replicas made here, print what the reference scripts print; the
  waterfall join and its render equal the reference's.
- verify_status against a port daemon on the native backend.
- utils/cache.py: host_cache_key is stable, equals the reference's and
  honours PBFT_CACHE_HOST_KEY; the daemon's --cache-dir roots the kernel
  build at the keyed directory (the path only: no nvcc here).
- ``-m cuda``: chaos_bench's fault-free arm on the card's daemon (skips
  without a card).

Reference modules are imported inside the tests that compare with them,
so the ``-m cuda`` case runs on the card's machine with ``--noconftest``.
"""

from __future__ import annotations

import json
import os
import pathlib
import random
import subprocess
import sys

import pytest

from pbft_tpu_torch import native
from pbft_tpu_torch.scripts import chaos_bench

REPO = pathlib.Path(__file__).resolve().parent.parent



@pytest.fixture
def native_core():
    """The C++ core (the gateway, pbftd, the native pool), built here once."""
    if not native.available():
        pytest.skip("the C++ core cannot be built here")


def _reference_script(name: str):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(REPO / "scripts"))


def _run_arm(arm="fault-free", verifier="cpu", **kw):
    args = dict(
        n=4, clients=4, requests_each=15, window=8, batch=32, batch_flush_us=2000, impl="py", gateways=1,
        vc_timeout_ms=500, admission_inflight=0, admission_backlog=0, fault_at_s=0.5, heal_at_s=1.5,
        deadline_s=150.0, seed=7, blackbox_dir=None,
    )
    args.update(kw)
    return chaos_bench.run_arm_traced(arm=arm, verifier=verifier, **args)


# -- chaos_bench --------------------------------------------------------------

def _check_fault_free(row):
    assert row["ok"] and row["completed_pct"] == 100.0, row
    assert row["requests"] == 4 * 15
    for field in ("requests_per_sec", "rounds_per_sec", "reply_p50_ms", "reply_p99_ms", "view_changes_started",
                  "overload_rejections", "gateway_failovers", "client_failovers", "vc_latency_ms"):
        assert field in row, field
    assert row["view_changes_started"] == 0


@pytest.mark.parametrize("where", ["cpu", "native-daemon"])
def test_chaos_bench_fault_free_arm_on_the_ports_replicas(native_core, where):
    if where == "cpu":
        row = _run_arm(verifier="cpu")
        _check_fault_free(row)
        assert row["verify_on"] == "cpu" and "verify_accounting" not in row
        return
    from pbft_tpu_torch.bench.harness import start_daemon

    daemon = start_daemon("native")
    try:
        row = _run_arm(verifier=daemon.address)
    finally:
        daemon.stop()
    _check_fault_free(row)
    acc = row["verify_accounting"]
    assert acc["service_items"] == acc["replica_sig_checks"] > 0, acc
    assert acc["unaccounted_items"] == 0 and len(acc["replica_checks"]) == 4 and min(acc["replica_checks"]) > 0
    assert acc["service_fallback_items"] == acc["replica_service_fallbacks"] == 0, acc


def test_chaos_bench_pure_parts_match_the_reference():
    ref = _reference_script("chaos_bench")
    assert chaos_bench.ARMS == ref.ARMS
    assert chaos_bench.COMPLETION_BAR == ref.COMPLETION_BAR
    rng = random.Random(12)
    for _ in range(20):
        events = [
            {"ts": rng.uniform(0, 30), "ev": rng.choice(("view_timer_fired", "new_view_installed", "verify_batch")),
             "replica": rng.randrange(4)}
            for _ in range(rng.randrange(0, 40))
        ]
        assert chaos_bench.view_change_latencies_ms(events) == ref.view_change_latencies_ms(events)
    join = [
        {"ts": 10.0, "ev": "view_timer_fired"}, {"ts": 10.1, "ev": "view_timer_fired"},
        {"ts": 10.5, "ev": "new_view_installed"}, {"ts": 10.6, "ev": "new_view_installed"},
        {"ts": 20.0, "ev": "view_timer_fired"}, {"ts": 20.25, "ev": "new_view_installed"},
    ]
    assert chaos_bench.view_change_latencies_ms(join) == pytest.approx([500.0, 250.0])


# -- the trace and flight tools -------------------------------------------------

@pytest.fixture(scope="module")
def cluster_artifacts(tmp_path_factory):
    """Traces (replicas' and the client's) and flight dumps of four of the
    port's asyncio replicas after eight requests, one of them batched."""
    if not native.available():
        pytest.skip("the C++ core cannot be built here")
    from pbft_tpu_torch.net.client import PbftClient
    from pbft_tpu_torch.net.launcher import LocalCluster

    root = tmp_path_factory.mktemp("artifacts")
    traces, flights = root / "traces", root / "flight"
    traces.mkdir()
    with LocalCluster(n=4, impl="py", verifier="cpu", trace_dir=str(traces), flight_dir=str(flights),
                      batch_max_items=4, batch_flush_us=2000) as c:
        cl = PbftClient(c.config)
        try:
            for k in range(4):
                req = cl.request(f"trace-{k}")
                assert cl.wait_result(req.timestamp, timeout=30) is not None
            assert len(cl.request_many([f"batched-{k}" for k in range(4)])) == 4
            cl.write_trace(str(traces / "client.jsonl"))
        finally:
            cl.close()
    return traces, sorted(flights.glob("replica-*.flight"))


def _both(script: str, *args):
    """(reference's stdout, port's stdout); each must exit 0."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    ref = subprocess.run([sys.executable, str(REPO / "scripts" / f"{script}.py"), *map(str, args)],
                         capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    mine = subprocess.run([sys.executable, "-m", f"pbft_tpu_torch.scripts.{script}", *map(str, args)],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    assert mine.returncode == 0, mine.stdout + mine.stderr
    return ref.stdout, mine.stdout


@pytest.mark.parametrize("script,args", [
    ("trace_report", ()),
    ("consensus_timeline", ()),
    ("consensus_timeline", ("--json", "--waterfall", "--check-invariants")),
    ("consensus_timeline", ("--waterfall", "--limit", "0")),
])
def test_trace_tools_print_what_the_reference_prints(cluster_artifacts, script, args):
    traces, _ = cluster_artifacts
    ref, mine = _both(script, traces, *args)
    assert mine == ref
    if script == "trace_report":
        assert "cluster:" in mine and "verifications in" in mine
    elif "--json" in args:
        out = json.loads(mine)
        assert out["slots"] and out["invariant_problems"] == [] and out["waterfall"]["requests"] > 0


@pytest.mark.parametrize("args", [(), ("--json",), ("--tail", "5")])
def test_flight_dump_prints_what_the_reference_prints(cluster_artifacts, args):
    _, flights = cluster_artifacts
    assert len(flights) == 4
    ref, mine = _both("flight_dump", *flights, *args)
    assert mine == ref
    if "--json" in args:
        assert all(len(recs) > 0 for recs in json.loads(mine).values())


def test_waterfall_render_equals_the_reference(cluster_artifacts):
    from pbft_tpu.utils import waterfall as jax_waterfall
    from pbft_tpu_torch.utils import waterfall

    traces, _ = cluster_artifacts
    wf = waterfall.from_trace_dir([traces])
    assert wf == jax_waterfall.from_trace_dir([traces]) and wf["requests"] > 0
    assert waterfall.render(wf) == jax_waterfall.render(wf)
    events = waterfall.load_jsonl(sorted(traces.glob("*.jsonl")))
    assert waterfall.client_records_from_events(events) == jax_waterfall.client_records_from_events(events)


# -- verify_status --------------------------------------------------------------

def test_verify_status_reads_a_port_daemon(native_core):
    from pbft_tpu_torch.net.verify_service import VerifyServiceDaemon

    daemon = VerifyServiceDaemon(backend="native").start()
    try:
        def run(*args):
            return subprocess.run([sys.executable, "-m", "pbft_tpu_torch.scripts.verify_status", *args],
                                  capture_output=True, text=True, cwd=REPO, timeout=60)

        text = run(daemon.address)
        js = run(daemon.address, "--json")
    finally:
        daemon.stop()
    assert text.returncode == 0 and js.returncode == 0, text.stdout + text.stderr
    assert f"verify service @ {daemon.address}" in text.stdout and "state           cpu-only" in text.stdout
    status = json.loads(js.stdout)
    assert status["state"] == "cpu-only" and status["backend"] == "native" and "kernel_launches" not in status
    gone = run(daemon.address, "--timeout", "0.5")
    assert gone.returncode == 1 and "no JSON status" in gone.stderr


# -- the host-keyed build cache ---------------------------------------------------

def test_host_cache_key_is_stable_and_honours_the_override(monkeypatch, tmp_path):
    from pbft_tpu.utils import cache as jax_cache
    from pbft_tpu_torch.utils import cache

    monkeypatch.delenv("PBFT_CACHE_HOST_KEY", raising=False)
    key = cache.host_cache_key()
    assert key == cache.host_cache_key() == jax_cache.host_cache_key()
    assert len(key) == 12 and int(key, 16) >= 0
    assert cache.host_keyed_cache_dir(str(tmp_path)) == os.path.join(str(tmp_path), key)
    monkeypatch.setenv("PBFT_CACHE_HOST_KEY", "pinned-host")
    assert cache.host_cache_key() == "pinned-host"
    assert cache.host_keyed_cache_dir("c") == os.path.join("c", "pinned-host")


def test_daemon_cache_dir_roots_the_kernel_build(monkeypatch, tmp_path):
    from pbft_tpu_torch.crypto import kernels
    from pbft_tpu_torch.net import verify_service as VS

    monkeypatch.setenv("PBFT_CACHE_HOST_KEY", "pinned-host")
    assert kernels.build_root() == REPO / "build" / "pbft_tpu_torch"
    assert kernels.build_root(tmp_path) == tmp_path / "pinned-host"
    assert kernels.build_root(str(tmp_path)) == tmp_path / "pinned-host"
    assert VS.CudaVerifyEngine(device="cpu", cache_dir=str(tmp_path)).cache_dir == str(tmp_path)

    seen = {}

    class Stub:
        def __init__(self, **kwargs):
            seen.update(kwargs)

        def start(self, wait_ready=False):
            raise RuntimeError("stub daemon")

        def stop(self):
            seen["stopped"] = True

    monkeypatch.setattr(VS, "VerifyServiceDaemon", Stub)
    assert VS.main(["--port", "0", "--cache-dir", str(tmp_path)]) == 1
    assert seen["cache_dir"] == str(tmp_path) and seen["stopped"]
    seen.clear()
    assert VS.main(["--port", "0"]) == 1
    assert seen["cache_dir"] is None


# -- on the card --------------------------------------------------------------------

@pytest.mark.cuda
def test_chaos_bench_fault_free_arm_on_the_card_daemon():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from pbft_tpu_torch.bench.harness import start_daemon

    daemon = start_daemon("cuda")
    try:
        row = _run_arm(verifier=daemon.address)
    finally:
        daemon.stop()
    _check_fault_free(row)
    acc = row["verify_accounting"]
    assert acc["service_items"] == acc["replica_sig_checks"] > 0, acc
    assert acc["service_fallback_items"] == acc["replica_service_fallbacks"] == 0, acc
    assert set(acc["kernel_launches"].values()) == {acc["service_windows"] * acc["service_devices"]}, acc
