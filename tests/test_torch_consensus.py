"""The port's Python replica core (``pbft_tpu_torch.consensus``) against
the JAX package's, on the same inputs made from a numpy seed: every message
type's bytes under every codec, ``network.json`` with every key set, the
write-ahead log's file bytes and recovery across the packages, one seeded
fault schedule per fast-path mode with the WAL on, and the native signer the
replicas sign with. Nothing here runs torch's device code."""

import dataclasses

import numpy as np
import pytest

from pbft_tpu import native as jax_native
from pbft_tpu.consensus import config as jax_config
from pbft_tpu.consensus import faults as jax_faults
from pbft_tpu.consensus import invariants as jax_invariants
from pbft_tpu.consensus import messages as jax_messages
from pbft_tpu.consensus import simulation as jax_simulation
from pbft_tpu.consensus import wal as jax_wal
from pbft_tpu_torch import native
from pbft_tpu_torch.consensus import config, faults, invariants, messages, simulation, wal
from pbft_tpu_torch.crypto import ref

SEED = 0x7C0
TYPES = sorted(jax_messages.Message._REGISTRY)
STRINGS = ["op", "", "awesome!", 'quote " and \\ backslash', "unicode é ☃", "<null>", "a" * 300]


def _int(rng, hi=2**40):
    return int(rng.integers(0, hi))


def _request(rng) -> dict:
    return {"operation": STRINGS[_int(rng, len(STRINGS))], "timestamp": _int(rng, 2**62),
            "client": f"127.0.0.1:{_int(rng, 65536)}", "type": "client-request"}


def _signed(rng, typ: str, **fields) -> dict:
    return {**fields, "replica": _int(rng, 31), "sig": rng.bytes(64).hex(), "type": typ}


def _vote(rng, typ: str) -> dict:
    return _signed(rng, typ, view=_int(rng), seq=_int(rng), digest=rng.bytes(32).hex())


def _pre_prepare(rng, batch: int) -> dict:
    reqs = [_request(rng) for _ in range(batch)]
    body = {"request": reqs[0]} if batch == 1 else {"requests": reqs}
    return _signed(rng, "pre-prepare", view=_int(rng), seq=_int(rng), digest=rng.bytes(32).hex(), **body)


def _checkpoint(rng) -> dict:
    return _signed(rng, "checkpoint", seq=_int(rng), digest=rng.bytes(32).hex())


def _view_change(rng) -> dict:
    proofs = [{"pre_prepare": _pre_prepare(rng, _int(rng, 3)), "prepares": [_vote(rng, "prepare") for _ in range(2)]}
              for _ in range(_int(rng, 3))]
    return _signed(rng, "view-change", new_view=_int(rng), last_stable_seq=_int(rng),
                   checkpoint_proof=[_checkpoint(rng) for _ in range(3)], prepared_proofs=proofs)


def _message_dict(rng, typ: str, k: int) -> dict:
    """A seeded message of ``typ`` as its canonical dict; ``k`` varies the
    shape (pre-prepare batches of 0, 1 and several requests)."""
    if typ == "client-request":
        return _request(rng)
    if typ == "client-reply":
        return {"view": _int(rng), "timestamp": _int(rng, 2**62), "client": f"127.0.0.1:{_int(rng, 65536)}",
                "replica": _int(rng, 31), "result": STRINGS[k % len(STRINGS)], "sig": rng.bytes(64).hex(),
                "tentative": k % 2, "type": typ}
    if typ == "pre-prepare":
        return _pre_prepare(rng, (0, 1, 1, 3)[k % 4])
    if typ in ("prepare", "commit"):
        return _vote(rng, typ)
    if typ == "checkpoint":
        return _checkpoint(rng)
    if typ == "state-request":
        return _signed(rng, typ, seq=_int(rng))
    if typ == "state-response":
        return _signed(rng, typ, seq=_int(rng), snapshot=STRINGS[k % len(STRINGS)])
    if typ == "view-change":
        return _view_change(rng)
    if typ == "new-view":
        return _signed(rng, typ, new_view=_int(rng), view_changes=[_view_change(rng) for _ in range(2)],
                       pre_prepares=[_pre_prepare(rng, 1 + k % 2) for _ in range(2)])
    raise AssertionError(f"no recipe for message type {typ!r}")


def test_both_registries_hold_the_same_types():
    assert sorted(messages.Message._REGISTRY) == TYPES
    assert all(cls.__module__ == messages.__name__ for cls in messages.Message._REGISTRY.values())


@pytest.mark.parametrize("typ", TYPES)
def test_message_bytes_equal_the_jax_package_under_every_codec(typ):
    rng = np.random.default_rng(SEED + TYPES.index(typ))
    for k in range(8):
        d = _message_dict(rng, typ, k)
        pm, jm = messages.Message.from_dict(d), jax_messages.Message.from_dict(d)
        assert pm.canonical() == jm.canonical()
        assert pm.signable() == jm.signable()
        if callable(getattr(pm, "digest", None)):
            assert pm.digest() == jm.digest()
        wire = messages.to_wire(pm)
        assert wire == jax_messages.to_wire(jm)
        assert messages.from_wire(wire[4:]) == pm and jax_messages.from_wire(wire[4:]) == jm
        assert messages.signable_from_payload(wire[4:], pm) == jax_messages.signable_from_payload(wire[4:], jm)
        if "sig" in d:
            resigned = rng.bytes(64).hex()
            assert messages.with_sig(pm, resigned).canonical() == jax_messages.with_sig(jm, resigned).canonical()
        binary = messages.to_binary(pm)
        assert binary == jax_messages.to_binary(jm)
        if binary is None:
            continue
        got, want = messages.decode_payload(binary), jax_messages.decode_payload(binary)
        assert got.canonical() == want.canonical() and (got == pm) == (want == jm)
        assert messages.signable_from_payload(binary, pm) == jax_messages.signable_from_payload(binary, jm)
        lanes = [(rid, rng.bytes(16)) for rid in rng.choice(31, size=1 + k % 4, replace=False).tolist()]
        mac = messages.to_binary_mac(pm, lanes)
        assert mac == jax_messages.to_binary_mac(jm, lanes)
        assert messages.payload_is_mac_frame(binary) == jax_messages.payload_is_mac_frame(binary)
        if mac is not None:
            assert messages.payload_is_mac_frame(mac) and jax_messages.payload_is_mac_frame(mac)
            for rid in range(32):
                assert messages.mac_frame_lane(mac, rid) == jax_messages.mac_frame_lane(mac, rid)
            assert messages.decode_payload(mac).canonical() == jax_messages.decode_payload(mac).canonical()


def _random_config(pkg, rng, n: int):
    cfg, _ = pkg.make_local_cluster(n)
    knobs = dict(
        watermark_window=_int(rng, 4096), checkpoint_interval=1 + _int(rng, 64), batch_pad=1 + _int(rng, 4096),
        verify_flush_us=_int(rng, 10**6), verify_flush_items=_int(rng, 4097), batch_max_items=1 + _int(rng, 64),
        batch_flush_us=_int(rng, 10**4), admission_inflight=_int(rng, 64), admission_backlog=_int(rng, 4096),
        net_threads=1 + _int(rng, 16), fastpath=("sig", "mac")[_int(rng, 2)], tentative=bool(_int(rng, 2)),
        wal_dir=f"/var/lib/pbft/{_int(rng, 100)}", wal_fsync=bool(_int(rng, 2)),
        verifier=f"127.0.0.1:{1024 + _int(rng, 60000)}", secure=bool(_int(rng, 2)),
    )
    assert set(knobs) == {f.name for f in dataclasses.fields(pkg.ClusterConfig)} - {"replicas"}
    return dataclasses.replace(cfg, **knobs)


@pytest.mark.parametrize("n", [4, 7, 16])
def test_network_json_sets_and_round_trips_every_key(n):
    seed = SEED + n
    port_cfg = _random_config(config, np.random.default_rng(seed), n)
    jax_cfg = _random_config(jax_config, np.random.default_rng(seed), n)
    text = port_cfg.to_json()
    assert text == jax_cfg.to_json()
    assert config.ClusterConfig.from_json(text) == port_cfg
    assert config.ClusterConfig.from_json(text).to_json() == text
    assert jax_config.ClusterConfig.from_json(text) == jax_cfg
    # Absent keys take the same defaults in both packages.
    bare = '{"replicas": %s}' % text.split('"replicas": ', 1)[1][:-1]
    assert config.ClusterConfig.from_json(bare).to_json() == jax_config.ClusterConfig.from_json(bare).to_json()


def _wal_ops(rng, count: int) -> list:
    """A seeded record sequence: views, votes (some repeated, some
    contradicting a held vote), checkpoints that prune and compact, flushes."""
    ops, votes = [], []
    for _ in range(count):
        roll = rng.random()
        if roll < 0.15:
            ops.append(("view", _int(rng, 50), bool(_int(rng, 2)), _int(rng, 50)))
        elif roll < 0.65:
            if votes and rng.random() < 0.3:
                kind, view, seq, digest = votes[_int(rng, len(votes))]
                if rng.random() < 0.5:
                    digest = rng.bytes(32).hex()  # a contradiction: refused, not logged
            else:
                kind, view, seq, digest = 1 + _int(rng, 3), _int(rng, 8), _int(rng, 200), rng.bytes(32).hex()
                votes.append((kind, view, seq, digest))
            ops.append(("vote", kind, view, seq, digest))
        elif roll < 0.75:
            cert = [{"seq": _int(rng, 200), "digest": rng.bytes(32).hex(), "replica": r} for r in range(3)]
            ops.append(("checkpoint", _int(rng, 200), STRINGS[_int(rng, len(STRINGS))], cert))
        else:
            ops.append(("flush",))
    return ops + [("flush",)]


def _apply(log, op):
    if op[0] == "view":
        return log.note_view(*op[1:])
    if op[0] == "vote":
        return log.note_vote(*op[1:])
    if op[0] == "checkpoint":
        return log.note_checkpoint(*op[1:])
    return log.flush()


@pytest.mark.parametrize("fsync", [True, False])
def test_wal_file_bytes_and_cross_recovery_equal_the_jax_package(tmp_path, fsync):
    rng = np.random.default_rng(SEED + fsync)
    port_path, jax_path = tmp_path / "port.wal", tmp_path / "jax.wal"
    port_log, jax_log = wal.WriteAheadLog(str(port_path), fsync), jax_wal.WriteAheadLog(str(jax_path), fsync)
    memory_log = wal.WriteAheadLog()
    for op in _wal_ops(rng, 300):
        assert _apply(port_log, op) == _apply(jax_log, op) == _apply(memory_log, op)
        if op[0] == "flush":
            assert port_path.read_bytes() == jax_path.read_bytes()
    assert port_path.read_bytes()[:8] == wal.WAL_MAGIC == b"PBFTWAL1"
    assert (port_log.appends, port_log.bytes_written) == (jax_log.appends, jax_log.bytes_written)
    live = dataclasses.asdict(port_log.state)
    assert live == dataclasses.asdict(jax_log.state) == dataclasses.asdict(memory_log.state)
    # Each package recovers the other's file to an equal state.
    assert dataclasses.asdict(wal.replay(str(jax_path))) == dataclasses.asdict(jax_wal.replay(str(port_path))) == live
    reopened = wal.WriteAheadLog(str(jax_path), fsync)
    assert dataclasses.asdict(reopened.recovered) == live
    torn = port_path.read_bytes()[:-3]  # a torn tail record: replay stops before it
    assert dataclasses.asdict(wal.decode_bytes(torn)) == dataclasses.asdict(jax_wal.decode_bytes(torn))


def _echo(operation, seq):
    return operation


@pytest.mark.parametrize("mode", ["sig", "mac"])
def test_a_seeded_fault_schedule_with_the_wal_ends_alike_in_both_packages(mode):
    """Schedule seed 21 at n = 4 (a crash, its restart from the WAL, a
    partition, link chaos, an equivocating replica), with the same host
    verifier in both packages and the same drive loop: the schedules, the
    invariant checkers' outcomes and every replica's end state are equal."""
    verify = native.verify_batch
    outcomes = []
    for cfg_mod, sim, inv, flt in ((config, simulation, invariants, faults),
                                   (jax_config, jax_simulation, jax_invariants, jax_faults)):
        cfg, seeds = cfg_mod.make_local_cluster(4)
        if mode == "mac":
            cfg = dataclasses.replace(cfg, fastpath="mac", tentative=True)
        cluster = sim.Cluster(config=cfg, seeds=seeds, seed=21, shuffle=True, verifier=verify, app=_echo, mode=mode,
                              wal=True)
        checker = inv.InvariantChecker(cluster)
        schedule = flt.random_schedule(21, 4, 120, restart_from_disk=True)
        out = faults.run_schedule(cluster, checker, schedule, 120, view_change_at=40 if mode == "mac" else None)
        out.update(schedule=schedule.to_json(), violations=[str(v) for v in checker.violations],
                   counters=[dict(r.counters) for r in cluster.replicas], sig_verifications=cluster.sig_verifications,
                   faults_injected=cluster.faults_injected, chaos_dropped=cluster.chaos_dropped,
                   restarts=dict(cluster.restart_epochs))
        outcomes.append(out)
    port, jax = outcomes
    assert port == jax
    actions = {ev.action for ev in faults.FaultSchedule.from_json(port["schedule"]).events}
    assert {"crash", "restart", "partition", "set_fault", "chaos"} <= actions
    assert port["answered"] and not port["violations"] and port["restarts"] == {3: 1}
    assert port["requests"] > 20 and port["sig_verifications"] > 0


def test_native_signer_and_verifier_equal_the_oracle_and_the_jax_package():
    rng = np.random.default_rng(SEED)
    for k in range(6):
        seed, msg = rng.bytes(32), rng.bytes(32 if k % 2 else 5 + k)
        pub = native.public_key(seed)
        sig = native.sign(seed, msg)
        assert pub == ref.public_key(seed) == jax_native.public_key(seed)
        assert sig == ref.sign(seed, msg) == jax_native.sign(seed, msg)
        bad = sig[:-1] + bytes([sig[-1] ^ 1])
        for p, m, s in ((pub, msg, sig), (pub, msg, bad), (pub, rng.bytes(len(msg)), sig), (pub, msg, sig[:63])):
            assert native.verify(p, m, s) == ref.verify(p, m, s) == jax_native.verify(p, m, s)
    with pytest.raises(ValueError, match="32 bytes"):
        native.sign(b"short", b"msg")
    from pbft_tpu_torch.consensus import replica  # its host signer is the native one here

    assert replica._host_sign(seed, msg) == sig and replica._HOST_SIGNER is native.sign
