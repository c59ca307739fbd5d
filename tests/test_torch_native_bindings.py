"""The port's ctypes bindings of the C++ core (pbft_tpu_torch/native.py)
beside the JAX package's (pbft_tpu/native.py): both load the one
build-core/libpbftcore.so, so each binding must give the reference's bytes
on the same seeded inputs, and the hashes, the secure channel's
primitives, the wire codec and the flight recorder must agree with their
Python counterparts."""

import hashlib
import json

import numpy as np
import pytest

from pbft_tpu import native as jax_native
from pbft_tpu_torch import native
from pbft_tpu_torch.consensus import messages as M
from pbft_tpu_torch.crypto import ref
from pbft_tpu_torch.net import secure
from pbft_tpu_torch.scripts import flight_dump
from pbft_tpu_torch.utils import flight, trace_schema


@pytest.fixture(scope="module", autouse=True)
def _core():
    if not native.available():
        pytest.skip("the native core cannot be built here")


def _bytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_hashes_match_hashlib_and_the_reference():
    rng = np.random.default_rng(1)
    for n in (0, 1, 63, 64, 111, 112, 127, 128, 129, 1000):
        data = _bytes(rng, n)
        assert native.sha512(data) == jax_native.sha512(data) == hashlib.sha512(data).digest()
        for size in (1, 16, 20, 32, 48, 64):
            want = hashlib.blake2b(data, digest_size=size).digest()
            assert native.blake2b(data, size) == jax_native.blake2b(data, size) == want
        for klen in (1, 32, 64):
            key = _bytes(rng, klen)
            want = hashlib.blake2b(data, key=key, digest_size=32).digest()
            assert native.blake2b_keyed(key, data) == jax_native.blake2b_keyed(key, data) == want
    for bad in (0, 65):
        with pytest.raises(ValueError):
            native.blake2b(b"x", bad)
    with pytest.raises(ValueError):
        native.blake2b_keyed(bytes(65), b"x")


def test_secure_channel_primitives_match_the_reference():
    rng = np.random.default_rng(2)
    for _ in range(4):
        a, b = _bytes(rng, 32), _bytes(rng, 32)
        pa, pb = native.dh_public(a), native.dh_public(b)
        assert pa == jax_native.dh_public(a) and pb == jax_native.dh_public(b)
        shared = native.dh_shared(a, pb)
        assert shared is not None and shared == native.dh_shared(b, pa) == jax_native.dh_shared(a, pb)
        key, ctr = _bytes(rng, 64), int(rng.integers(0, 2**62))
        for n in (0, 1, 100):
            plain = _bytes(rng, n)
            sealed = native.aead_seal(key, ctr, plain)
            assert sealed == jax_native.aead_seal(key, ctr, plain) and len(sealed) == n + 16
            assert native.aead_open(key, ctr, sealed) == plain == jax_native.aead_open(key, ctr, sealed)
            flipped = bytearray(sealed)
            flipped[int(rng.integers(0, len(sealed)))] ^= 0x20
            assert native.aead_open(key, ctr, bytes(flipped)) is None
            assert jax_native.aead_open(key, ctr, bytes(flipped)) is None
            assert native.aead_open(key, ctr + 1, sealed) is None
        mkey, signable = _bytes(rng, 32), _bytes(rng, 32)
        assert native.mac_tag(mkey, signable) == jax_native.mac_tag(mkey, signable) == secure.mac_tag(mkey, signable)
    # A peer value of small order, or not on the curve, gives no secret.
    off_curve = next(k.to_bytes(32, "little") for k in range(2, 1000)
                     if ref.point_decompress(k.to_bytes(32, "little")) is None)
    for peer in ((1).to_bytes(32, "little"), bytes(32), off_curve):
        assert native.dh_shared(a, peer) is None and jax_native.dh_shared(a, peer) is None
    for call in (lambda: native.dh_public(bytes(31)), lambda: native.dh_shared(a, bytes(33)),
                 lambda: native.aead_seal(bytes(32), 0, b"x"), lambda: native.aead_open(bytes(63), 0, bytes(16)),
                 lambda: native.mac_tag(bytes(32), bytes(31))):
        with pytest.raises(ValueError):
            call()


def _every_type(rng):
    hexs = lambda n: _bytes(rng, n).hex()  # noqa: E731
    req = M.ClientRequest(operation='op "q" \\ é', timestamp=int(rng.integers(0, 2**40)), client="127.0.0.1:9000")
    cp = M.Checkpoint(seq=16, digest=hexs(32), replica=1, sig=hexs(64))
    pp = M.PrePrepare(view=0, seq=1, digest=req.digest(), requests=(req,), replica=0, sig=hexs(64))
    pp2 = M.PrePrepare(view=2, seq=9, digest=hexs(32), requests=(req, req), replica=2, sig=hexs(64))
    prep = M.Prepare(view=0, seq=1, digest=req.digest(), replica=2, sig=hexs(64))
    return [
        req, pp, pp2, prep, cp,
        M.Commit(view=0, seq=1, digest=req.digest(), replica=3, sig=hexs(64)),
        M.ClientReply(view=0, timestamp=3, client="127.0.0.1:9000", replica=1, result="res", sig=hexs(64)),
        M.ViewChange(new_view=1, last_stable_seq=16, checkpoint_proof=(cp.to_dict(),),
                     prepared_proofs=({"pre_prepare": pp.to_dict(), "prepares": [prep.to_dict()]},),
                     replica=2, sig=hexs(64)),
        M.NewView(new_view=1, view_changes=(cp.to_dict(),), pre_prepares=(pp.to_dict(),), replica=1, sig=hexs(64)),
        M.StateRequest(seq=16, replica=3, sig=hexs(64)),
        M.StateResponse(seq=16, snapshot='snap "sig":"', replica=0, sig=hexs(64)),
    ]


def test_wire_codec_bindings_match_the_reference_and_the_python_codec():
    rng = np.random.default_rng(3)
    binary = 0
    for msg in _every_type(rng):
        payload = msg.canonical()
        assert native.signable_from_payload(payload) == jax_native.signable_from_payload(payload) == msg.signable()
        got = native.message_to_binary(payload)
        assert got == jax_native.message_to_binary(payload) == M.to_binary(msg), type(msg).__name__
        if got is None:
            continue
        binary += 1
        assert native.message_from_binary(got) == jax_native.message_from_binary(got) == (payload, msg.signable())
        assert native.signable_from_payload(got) == msg.signable()
        for bad in (got[:-1], got + b"\x00", bytes([M.WIRE_BINARY_MAGIC, 0x7F])):
            assert native.message_from_binary(bad) is None and jax_native.message_from_binary(bad) is None
        if isinstance(msg, M.ClientRequest):
            continue  # no signature, no MAC form
        rids = sorted(int(r) for r in rng.choice(64, 3, replace=False))
        lanes = [(rid, _bytes(rng, 16)) for rid in rids]
        frame = native.message_to_binary_mac(payload, lanes)
        assert frame is not None and frame == jax_native.message_to_binary_mac(payload, lanes)
        assert frame == M.to_binary_mac(msg, lanes)
        assert native.message_from_binary(frame) == (payload, msg.signable())
        for rid, tag in lanes:
            assert native.mac_frame_lane(frame, rid) == jax_native.mac_frame_lane(frame, rid) == tag
        absent = next(r for r in range(70) if r not in rids)
        assert native.mac_frame_lane(frame, absent) is None and jax_native.mac_frame_lane(frame, absent) is None
    assert binary >= 6
    assert native.signable_from_payload(b"not a message") is None
    assert native.message_to_binary(b"{}") is None and jax_native.message_to_binary(b"{}") is None


def test_flight_recorder_bindings_decode_with_the_port_script(tmp_path, capsys):
    executed = trace_schema.FLIGHT_EVENT_IDS["executed"]
    try:
        native.flight_configure(0)  # disabled: a record is a no-op
        native.flight_record(executed, 0, 1, -1)
        assert native.flight_total() == jax_native.flight_total() == 0
        native.flight_configure(8)
        for i in range(1, 13):  # wraps the ring: only the last 8 survive
            native.flight_record(executed, 1, i, i % 4)
        assert native.flight_total() == jax_native.flight_total() == 12
        ours, theirs = tmp_path / "port.flight", tmp_path / "jax.flight"
        assert native.flight_dump(str(ours)) == 8 == jax_native.flight_dump(str(theirs))
        assert ours.read_bytes() == theirs.read_bytes()
        assert flight_dump.main([str(ours), "--json"]) == 0
        records = json.loads(capsys.readouterr().out)[str(ours)]
        assert [(r["event"], r["view"], r["seq"], r["peer"]) for r in records] == [
            ("executed", 1, i, i % 4) for i in range(5, 13)]
        assert records == flight.decode_file(str(ours))
        native.flight_reset()
        assert native.flight_dump(str(ours)) == 0 and flight.decode_file(str(ours)) == []
        assert native.flight_dump(str(tmp_path / "no-such-dir" / "x.flight")) == -1
    finally:
        native.flight_configure(0)


def test_verifier_test_hooks_match_the_reference():
    """Each hook set through the port gives the verdicts the same hook set
    through the JAX package gives (one library, one pool), all equal to the
    oracle on honest and corrupted rows."""
    rng = np.random.default_rng(4)
    items = []
    for _ in range(12):
        seed, msg = _bytes(rng, 32), _bytes(rng, 32)
        sig = native.sign(seed, msg)
        items += [(native.public_key(seed), msg, sig), (native.public_key(seed), msg, bytes([sig[0] ^ 1]) + sig[1:])]
    want = [ref.verify(*it) for it in items]
    try:
        for port_hook, jax_hook in ((native.force_entropy_exhaustion, jax_native.force_entropy_exhaustion),
                                    (native.pubkey_cache_disable, jax_native.pubkey_cache_disable)):
            for on in (True, False):
                port_hook(on)
                ours = native.verify_batch(items)
                jax_hook(on)
                assert ours == jax_native.verify_batch(items) == want
        native.pubkey_cache_clear()
        cold = native.verify_batch(items)
        jax_native.pubkey_cache_clear()
        assert cold == jax_native.verify_batch(items) == want
    finally:
        native.force_entropy_exhaustion(False)
        native.pubkey_cache_disable(False)
