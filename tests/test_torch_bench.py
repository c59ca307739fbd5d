"""The port's bench entry (``python -m pbft_tpu_torch.bench``,
``pbft_tpu_torch/bench/verify_bench.py``) on the CPU: its pool against the
root ``bench.py``'s, each arm's JSON line (native, plain CPU, service,
consensus) against the reference arm's keys, and the failure lines that
replace ``bench.py``'s silent fallbacks (no card, no service, a daemon
whose warm fails). The card's arm is a ``cuda`` case that skips here.

JAX is imported only inside the ``slow`` parity case, so that the ``cuda``
case runs on a machine without it (``--noconftest``)."""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pbft_tpu_torch.bench import verify_bench
from pbft_tpu_torch.crypto import batch as B
from pbft_tpu_torch.net.verify_service import VerifyServiceDaemon

REPO = pathlib.Path(__file__).resolve().parent.parent
KNOBS = ("PBFT_BENCH_", "PBFT_VERIFY_SERVICE", "PBFT_VERIFY_THREADS", "PBFT_BATCH_", "PBFT_SERVICE_WARM_BUDGET_S")


def _clean_env(monkeypatch=None) -> dict:
    """The environment without any of the entry's knobs (removed from this
    process's too when ``monkeypatch`` is given)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(KNOBS)}
    if monkeypatch is not None:
        for k in set(os.environ) - set(env):
            monkeypatch.delenv(k)
    return env


def _run(*args, script=None, **knobs) -> tuple:
    """The entry (or ``script``) in a process of its own: (exit code, its
    last line of standard output, its standard error)."""
    env = _clean_env()
    env.update(PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""), **knobs)
    cmd = [sys.executable, str(script)] if script else [sys.executable, "-m", "pbft_tpu_torch.bench"]
    proc = subprocess.run([*cmd, *args], cwd=REPO, capture_output=True, text=True, env=env, timeout=300)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, json.loads(lines[-1]) if lines else {}, proc.stderr


def _main(capsys, *args) -> tuple:
    """The entry in this process: (exit code, its last line)."""
    rc = verify_bench.main(list(args))
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _closed_address() -> str:
    """An address where nothing listens."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _reference_bench(monkeypatch, tmp_path):
    """The root ``bench.py``, loaded unedited under a name of its own (its
    import-time settings kept inside the test)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax-cache"))
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location("reference_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Feed:
    """An rng stand-in whose ``bytes(n)`` hands out given chunks in order."""

    def __init__(self, chunks):
        self._chunks = iter(chunks)

    def bytes(self, n: int) -> bytes:
        chunk = next(self._chunks)
        assert len(chunk) == n
        return chunk


def test_signed_pool_matches_bench_py_on_the_same_messages(monkeypatch, tmp_path):
    ref_bench = _reference_bench(monkeypatch, tmp_path)
    batch = 150  # two whole tiles of the 64 signers and a partial one
    msgs = [bytes(m) for m in np.random.default_rng(7).integers(0, 256, (verify_bench.POOL, 32), dtype=np.uint8)]
    feed = iter(msgs)
    monkeypatch.setattr(os, "urandom", lambda n: next(feed))
    want = ref_bench._signed_pool(batch)
    monkeypatch.undo()
    got = verify_bench._signed_pool(batch, _Feed(msgs))
    for name, a, b in zip(("pubs", "msgs", "sigs"), got, want):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert got[2][batch // 2, 7] != got[2][batch // 2 - verify_bench.POOL, 7]  # the corrupted row
    # The entry's own messages come from PBFT_BENCH_SEED: a run repeats.
    again = [verify_bench._signed_pool(batch, np.random.default_rng(0)) for _ in range(2)]
    assert all(np.array_equal(a, b) for a, b in zip(*again))


def test_native_arm_reports_the_reference_arms_keys():
    knobs = dict(PBFT_BENCH_NATIVE="1", PBFT_BENCH_SECS="0.2", PBFT_BENCH_BATCH="64", PBFT_VERIFY_THREADS="2")
    rc, line, err = _run(**knobs)
    assert rc == 0, err
    ref_rc, ref_line, ref_err = _run(script=REPO / "bench.py", **knobs)
    assert ref_rc == 0, ref_err
    assert set(line) == set(ref_line)
    for result in (line, ref_line):
        assert result["backend"] == "cpu-native"
        assert result["metric"] == "ed25519_sig_verifies_per_sec"
        assert result["threads"] == 2
        assert result["single_thread_per_sec"] > 0
        assert result["pooled_per_sec"] == result["value"]
        assert result["pool_speedup"] > 0
        assert result["vs_baseline"] == round(result["value"] / 50_000, 3)


def test_plain_cpu_arm_runs_the_chain_with_checked_verdicts(monkeypatch, capsys):
    _clean_env(monkeypatch)
    for k, v in dict(PBFT_BENCH_CPU="1", PBFT_BENCH_SECS="0", PBFT_BENCH_BATCH="16", PBFT_BENCH_CHAIN="2").items():
        monkeypatch.setenv(k, v)
    rc, line = _main(capsys)
    assert rc == 0, line
    assert line["backend"] == "cpu" and line["value"] > 0
    assert (line["batch"], line["chain"], line["chains"], line["applications"]) == (16, 2, 1, 2)
    assert line["capture_s"] == 0.0 and line["window_ms"] > 0
    assert line["launches"] == {"inv": 0, "p58": 0, "ladder": 0, "sha512": 0}  # plain versions: no kernel launched
    assert "card" not in line


@pytest.mark.slow
def test_plain_cpu_pool_bitmap_equals_the_jax_verify_batch():
    import jax  # noqa: F401 - the conftest keeps it on the CPU

    from pbft_tpu.crypto.batch import verify_batch

    pubs, msgs, sigs = verify_bench._signed_pool(16, np.random.default_rng(0))
    port = B.verify_many(verify_bench._items(pubs, msgs, sigs), device="cpu")
    assert sum(port) == 15 and not port[8]
    assert np.asarray(verify_batch(pubs, msgs, sigs)).tolist() == port


def test_service_arm_drives_a_cpu_only_daemon(monkeypatch, capsys):
    daemon = VerifyServiceDaemon(port=0, backend="native").start()
    try:
        _clean_env(monkeypatch)
        knobs = dict(PBFT_VERIFY_SERVICE=daemon.address, PBFT_BENCH_SERVICE_CONNS="1", PBFT_BENCH_BATCH="64",
                     PBFT_BENCH_SECS="0.2")
        for k, v in knobs.items():
            monkeypatch.setenv(k, v)
        rc, line = _main(capsys)
        status = daemon.status_json()
    finally:
        daemon.stop()
    assert rc == 0, line
    assert line["backend"] == "verify-service" and line["service_state"] == "cpu-only"
    assert line["steady_state_per_sec"] == line["value"] > 0
    assert (line["connections"], line["batch"], line["devices"]) == (1, 64, 0)
    # The warmup round trip and the timed ones, every item on the daemon.
    assert line["service_items"] == 64 * line["service_windows"] == status["items"] >= 128
    assert "cold_start_s" not in line and "service_pid" not in line and "card" not in line


def test_cuda_worker_without_a_card_reports_backend_init():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, line, _ = _run("--cuda-worker", PBFT_BENCH_BATCH="16")
    assert rc == 1
    assert line["value"] == 0.0 and line["error"].startswith("backend-init")
    assert "backend" not in line


def test_no_card_no_service_no_arm_fails_rather_than_measure_the_host():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, line, err = _run(PBFT_VERIFY_SERVICE=_closed_address())
    assert rc == 1, err
    assert line["value"] == 0.0 and line["error"].startswith("backend-init")
    assert "PBFT_BENCH_NATIVE=1" in line["error"] and "backend" not in line


def test_spawned_daemon_whose_warm_fails_ends_the_run():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, line, err = _run(PBFT_VERIFY_SERVICE=_closed_address(), PBFT_BENCH_LAUNCH_SERVICE="1")
    assert rc == 1, err
    assert line["value"] == 0.0 and line["error"].startswith("service-warm")
    assert "CUDA is not available" in line["error"] and "backend" not in line


def test_an_unnamed_failure_still_ends_in_the_one_line():
    rc, line, err = _run(PBFT_BENCH_CONSENSUS="1", PBFT_BENCH_REQUESTS="many")
    assert rc == 1
    assert line["value"] == 0.0 and line["error"].startswith("unexpected: ValueError")
    assert "Traceback" in err


def test_consensus_arm_commits_every_request():
    rc, line, err = _run(PBFT_BENCH_CONSENSUS="1", PBFT_BENCH_REQUESTS="32", PBFT_BENCH_PIPELINE="8")
    assert rc == 0, err
    assert line["metric"] == "pbft_requests_per_sec" and line["backend"] == "consensus-native"
    assert line["requests"] == 32 and line["value"] > 0
    assert line["segments_ms"]["reply"]["count"] == 32


@pytest.mark.cuda
def test_cuda_worker_times_one_graph_of_the_chain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rc, line, err = _run("--cuda-worker", PBFT_BENCH_BATCH="64", PBFT_BENCH_CHAIN="2", PBFT_BENCH_SECS="0.5")
    assert rc == 0, err
    assert line["backend"] == "cuda" and line["value"] > 0 and line["card"]
    assert (line["batch"], line["chain"]) == (64, 2) and line["capture_s"] > 0
    assert line["applications"] == 2 * line["chains"]
    assert line["launches"] == dict.fromkeys(("inv", "p58", "ladder", "sha512"), line["applications"])
