"""The port's in-memory simulation and the harness's simulation arms against
the JAX package's: BASELINE's configs 0-4 through both packages' ``Cluster``
with the same host verifier (every replica ends alike), the ``cpu`` arm's
rows equal to the JAX ``cpu`` arm's in every field but times and rates, the
``cuda`` arm's verifier on the CPU (the kernels' plain versions) against the
oracle on config 4's items, Byzantine signatures included, and the arms'
refusals: no card, no ``jax`` verifier."""

import dataclasses

import numpy as np
import pytest

from pbft_tpu.bench import harness as jax_harness
from pbft_tpu.consensus import invariants as jax_invariants
from pbft_tpu.consensus import simulation as jax_simulation
from pbft_tpu_torch import native
from pbft_tpu_torch.bench import harness
from pbft_tpu_torch.consensus import invariants, simulation
from pbft_tpu_torch.crypto import ref

SEED = 0x51A
# Requests per config for the Cluster comparison: the harness's depth cut
# so that both packages run every config in a few seconds together.
DEPTH = {0: 1, 1: 40, 2: 24, 3: 8, 4: 4}
# The rows' depth: the harness's own (None), cut for the two widest
# configs so that this file stays well inside half a minute.
ROW_DEPTH = {0: None, 1: None, 2: None, 3: 24, 4: 6}
TIMES_AND_RATES = {"seconds", "rounds_per_sec", "sig_verifies_per_sec", "requests_per_sec"}


def _lockstep(sim, inv, index: int, requests: int, verify) -> tuple:
    """The harness's lockstep drive of config ``index`` on ``sim.Cluster``,
    with an invariant checker checked at every quiescence."""
    name, n, clients, _, byzantine = harness.CONFIGS[index]
    cluster = sim.Cluster(n=n, verifier=verify)
    checker = inv.InvariantChecker(cluster)
    if byzantine:
        cluster.outbound_mutator = lambda src, msg: (
            dataclasses.replace(msg, sig="ff" * 64) if src == n - 1 and getattr(msg, "sig", "") else msg)
    ts, inflight, submitted, executed = [0] * clients, {}, 0, 0
    while executed < requests:
        for c in range(clients):
            if c not in inflight and submitted < requests:
                ts[c] += 1
                inflight[c] = cluster.submit(f"op-{submitted}", client=f"127.0.0.1:{9000 + c}", timestamp=ts[c]).timestamp
                submitted += 1
        if not cluster.step():
            checker.check()
            for c, t in list(inflight.items()):
                cluster.committed_result(t)
                del inflight[c]
                executed += 1
    return cluster, checker


@pytest.mark.parametrize("index", sorted(DEPTH))
def test_every_replica_ends_alike_in_both_packages(index):
    calls = []

    def verify(items):  # one host verifier for both packages, recording each call
        calls.append(len(items))
        return native.verify_batch(items)

    port, port_checker = _lockstep(simulation, invariants, index, DEPTH[index], verify)
    port_calls, calls[:] = list(calls), []
    jax, jax_checker = _lockstep(jax_simulation, jax_invariants, index, DEPTH[index], verify)
    assert port_calls == calls and port.sig_verifications == jax.sig_verifications == sum(calls) > 0
    for p, j in zip(port.replicas, jax.replicas, strict=True):
        assert (p.view, p.executed_upto, p.state_digest, dict(p.counters)) == (
            j.view, j.executed_upto, j.state_digest, dict(j.counters))
        assert p.executed_upto == DEPTH[index] and p.view == 0
    assert [r.canonical() for r in port.client_replies] == [r.canonical() for r in jax.client_replies]
    assert port_checker.violations == jax_checker.violations == []
    rejected = sum(r.counters.get("sig_rejected", 0) for r in port.replicas)
    assert (rejected > 0) == harness.CONFIGS[index][4]


@pytest.mark.parametrize("index", sorted(ROW_DEPTH))
def test_cpu_arm_rows_equal_the_jax_cpu_arm(index):
    port = dataclasses.asdict(harness.run_config("cpu", index, requests=ROW_DEPTH[index], invariants=True))
    jax = dataclasses.asdict(jax_harness.run_config(index, arm="cpu", requests=ROW_DEPTH[index]))
    for key in set(jax) - TIMES_AND_RATES - {"mean_batch"}:
        assert port[key] == jax[key], key
    assert round(port["mean_batch"], 2) == jax["mean_batch"]  # the JAX row rounds it
    acc = port["accounting"]
    assert acc["items"] == acc["replica_sig_checks"] == port["sig_verifications"]
    assert "windows" not in acc and acc["verifier_calls"] > 0 and acc["view_changes_started"] == 0
    assert acc["rejected"] == acc["replica_sig_rejected"] and (acc["rejected"] > 0) == port["byzantine"]
    assert port["capture_s"] == 0.0 and port["verifier"] == "cpu" and acc["invariant_checks"] > 0
    assert 0 < port["invariant_s"] and 0 < port["seconds"]


def test_the_cuda_arms_verifier_on_the_cpu_equals_the_oracle_on_config_4(monkeypatch):
    """Config 4's items (one request: its Byzantine replica's "ff" * 64
    signatures among them), 256 of them through the cuda arm's verifier on
    the CPU, one window of the kernels' plain versions."""
    recorded = []
    real_verify = native.verify_batch
    monkeypatch.setattr(native, "verify_batch", lambda items: recorded.extend(items) or real_verify(items))
    harness.run_config("cpu", 4, requests=1)
    monkeypatch.undo()
    bad = [it for it in recorded if it[2] == b"\xff" * 64]
    good = [it for it in recorded if it[2] != b"\xff" * 64]
    rng = np.random.default_rng(SEED)
    pick = bad[:64] + [good[i] for i in rng.choice(len(good), size=256 - min(64, len(bad)), replace=False)]
    items = [pick[i] for i in rng.permutation(len(pick))]
    want = [ref.verify(*it) for it in items]
    assert len(items) == 256 and want.count(False) == min(64, len(bad)) > 0
    windows = []
    verify = harness._verifier("cuda", 256, device="cpu")
    from pbft_tpu_torch.crypto import batch

    real_many = batch.verify_many
    monkeypatch.setattr(batch, "verify_many", lambda chunk, **kw: (windows.append((len(chunk), kw)),
                                                                  real_many(chunk, **kw))[1])
    assert verify(items) == want
    assert windows == [(256, {"pad_to": 256, "device": "cpu"})]


def test_the_cuda_arm_needs_a_card_and_the_jax_verifier_is_gone(monkeypatch):
    import torch

    with pytest.raises(ValueError, match="unknown verifier 'jax'"):
        simulation.Cluster(n=4, verifier="jax")
    with pytest.raises(ValueError, match="unknown simulation arm"):
        harness.run_sim_config(0, "jax")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        harness.run_config("cuda", 0)
    cluster = simulation.Cluster(n=4, verifier="cuda")
    cluster.submit("x")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cluster.run()
    assert harness.ARMS == ("cpu", "cuda", "native", "native-cuda")
