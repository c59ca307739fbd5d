"""The port's quorum certification over two processes on torch.distributed
(gloo), each process verifying its own rows (partition_items) on its own
shards and the per-round counts all-reduced over the group.

This file is also its own worker:

    python tests/test_torch_multihost.py <port> <rank> <world> <device> <verdicts>

where <device> is cpu or cuda and <verdicts> is ``standin`` (sig[0] odd
decides a row, so no verify runs) or ``real`` (the port's verify_kernel:
the plain versions on the CPU, the CUDA kernels on a card). The worker
prints one JSON line with its counts, certified and valid.

- tier 1: two CPU workers with the stand-in verdicts agree on counts and
  certified with each other and with one process over the whole window.
- slow: the same with the real plain verify.
- cuda: both workers on the one card (gloo; NCCL refuses two ranks on a
  card) with the CUDA kernels, against the RFC 8032 oracle. It imports no
  JAX: run it with ``--noconftest``.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

B, R, SHARDS = 16, 4, 2  # rows, rounds, shards per process
THRESHOLDS = np.full(R, 3, np.int32)


def _standin(pubs, msgs, sigs):
    return (sigs[..., 0] & 1) == 1


def _window(verdicts: str):
    """(pubs, msgs, sigs, round_ids) of the whole window, the same in every
    process. Real: 16 signed rows, rows 2 and 6 (round 2) zeroed, so round
    2 has 2 valid of 4 and misses the threshold of 3. Stand-in: seeded
    random rows."""
    round_ids = np.arange(B, dtype=np.int32) % R
    if verdicts == "standin":
        rng = np.random.default_rng(7)
        pubs, msgs = (rng.integers(0, 256, (B, 32), dtype=np.uint8) for _ in range(2))
        return pubs, msgs, rng.integers(0, 256, (B, 64), dtype=np.uint8), round_ids
    from pbft_tpu_torch.crypto import ref

    rows = []
    for i in range(B):
        seed = bytes([i + 1]) * 32
        msg = bytes([0xA5 ^ i]) * 32
        sig = bytes(64) if i in (2, 6) else ref.sign(seed, msg)
        rows.append(np.frombuffer(ref.public_key(seed) + msg + sig, np.uint8))
    rows = np.stack(rows)
    return rows[:, :32], rows[:, 32:64], rows[:, 64:], round_ids


def _use_standin():
    import pbft_tpu_torch.parallel.verifier as V

    V.verify_kernel = _standin


def worker(port: int, rank: int, world: int, device: str, verdicts: str) -> dict:
    import torch.distributed as dist

    from pbft_tpu_torch.parallel import (
        global_mesh,
        host_shard_to_global,
        initialize_distributed,
        partition_items,
        quorum_certify,
    )

    if verdicts == "standin":
        _use_standin()
    if device == "cpu":
        torch.set_num_threads(1)  # two processes of 8 intra-op threads each on 8 cores crawl
    initialize_distributed(f"127.0.0.1:{port}", num_processes=world, process_id=rank, backend="gloo")
    try:
        mesh = global_mesh(devices=[device] * SHARDS)
        rows = partition_items(list(range(B)))
        pubs, msgs, sigs, round_ids = (a[rows] for a in _window(verdicts))
        res = quorum_certify(mesh, R)(
            *(host_shard_to_global(mesh, a) for a in (pubs, msgs, sigs, round_ids)), THRESHOLDS
        )
        return {
            "rank": rank, "size": mesh.size, "rows": rows, "counts": res.counts.tolist(),
            "certified": res.certified.tolist(), "valid": res.valid.tolist(),
            "device": res.counts.device.type,
        }
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two(tmp_path, device: str, verdicts: str, timeout: float):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=_REPO)
    procs, logs = [], []
    for rank in range(2):
        # Output to files, not pipes: a full pipe would block one worker
        # while the other waits for it in the rendezvous.
        out = open(tmp_path / f"worker-{rank}.out", "w+")
        logs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(port), str(rank), "2", device, verdicts],
            stdout=out, stderr=subprocess.STDOUT, env=env, text=True,
        ))
    try:
        results = []
        for proc, out in zip(procs, logs):
            rc = proc.wait(timeout=timeout)
            out.seek(0)
            text = out.read()
            assert rc == 0, f"worker failed:\n{text[-4000:]}"
            results.append(json.loads(text.strip().splitlines()[-1]))
        return results
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for out in logs:
            out.close()


def _check_agreement(results, device: str, want_counts=None):
    """Both ranks read the same counts and certified, equal to one process
    over the whole window; each rank's valid covers its own rows."""
    import pbft_tpu_torch.parallel.verifier as V

    verdicts = "real" if want_counts is not None else "standin"
    pubs, msgs, sigs, round_ids = _window(verdicts)
    one = V.quorum_certify(V.make_mesh(devices=[device] * SHARDS), R)(pubs, msgs, sigs, round_ids, THRESHOLDS)
    for res in results:
        assert res["size"] == 2 * SHARDS and res["device"] == device
        assert res["counts"] == one.counts.tolist()
        assert res["certified"] == one.certified.tolist()
        assert res["valid"] == [one.valid.tolist()[i] for i in res["rows"]]
    assert results[0]["rows"] == list(range(0, B, 2)) and results[1]["rows"] == list(range(1, B, 2))
    if want_counts is not None:
        assert one.counts.tolist() == want_counts
        assert one.certified.tolist() == [c >= 3 for c in want_counts]


def test_two_processes_agree_with_one(tmp_path, monkeypatch):
    results = _run_two(tmp_path, "cpu", "standin", timeout=120)
    import pbft_tpu_torch.parallel.verifier as V

    monkeypatch.setattr(V, "verify_kernel", _standin)
    _check_agreement(results, "cpu")
    assert any(results[0]["certified"]) and not all(results[0]["certified"])


@pytest.mark.slow
def test_two_processes_agree_with_the_real_plain_verify(tmp_path):
    _check_agreement(_run_two(tmp_path, "cpu", "real", timeout=600), "cpu", want_counts=[4, 4, 2, 4])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
def test_two_processes_on_the_card_agree_with_the_oracle(tmp_path, cuda_device):
    _check_agreement(_run_two(tmp_path, cuda_device, "real", timeout=600), cuda_device, want_counts=[4, 4, 2, 4])


if __name__ == "__main__":
    port_arg, rank_arg, world_arg, device_arg, verdicts_arg = sys.argv[1:6]
    print(json.dumps(worker(int(port_arg), int(rank_arg), int(world_arg), device_arg, verdicts_arg)), flush=True)
