"""Whole runs of a cell without the card: the harness's look for a chip is
skipped and the verify service serves from the host's native pool
(``backend="native"``), at a small load. A sound run comes out correct;
with the timed path broken underneath (the control and each fault a run of
this system can have, ``deploy.FAULTS``) ``correct`` comes out false. The
card's own run of a cell is marked ``cuda`` and skips here."""

import json
import subprocess
import sys
import time

import pytest

from cardbench import deploy, manifest, run

SMALL = {"clients": 4, "outstanding_per_client": 2, "client_processes": 2, "ramp_s": 0.5, "drain_s": 8.0}


def _run(workload, fault=None, seed=2**31 + 12345, seconds=2.0):
    return run.run(workload, seed, seconds, False, time.monotonic(), backend="native", fault=fault,
                   traffic_override=SMALL)


def test_sound_run_is_correct_and_reports_the_cell_metrics():
    res = _run("pbft-n4-f1.closed16")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"commit_rps", "reply_p50_ms", "setup_s"}
    assert list(res)[-2:] == ["checks", "info"]
    assert all(c["limit"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("fault", sorted(deploy.FAULTS))
def test_broken_timed_path_is_not_correct(fault):
    res = _run("pbft-n4-f1.closed16", fault=fault)
    assert not res["correct"], res["checks"]


def test_no_card_exits_nonzero_without_a_result():
    proc = subprocess.run([sys.executable, "-m", "cardbench", "--workload", "pbft-n4-f1.closed16", "--seed",
                           str(2**31 + 7), "--seconds", "1", "--trace", "0"],
                          cwd=manifest.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_card_run_and_control(card):
    """On the card, at a short window: a sound run of the smallest cell is
    correct, and the control (every signature accepted) is not."""
    out = subprocess.run([sys.executable, "-m", "cardbench.control", "--workload", "pbft-n4-f1.closed16",
                          "--seeds", "5,6", "--seconds", "3", "--fault", "accept_all"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 2 and not any(x["correct"] for x in lines), out.stderr[-2000:]
    sound = subprocess.run([sys.executable, "-m", "cardbench", "--workload", "pbft-n4-f1.closed16", "--seed",
                            str(2**31 + 99), "--seconds", "3", "--trace", "0"],
                           cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert sound.returncode == 0 and json.loads(sound.stdout.splitlines()[-1])["correct"], sound.stderr[-2000:]
