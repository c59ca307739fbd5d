"""The port's Ed25519 verifier (pbft_tpu_torch.crypto.ed25519) against the
RFC 8032 oracle in ONE batched plain-path call on the CPU (one plain verify
costs seconds whatever the batch), on the cases of
tests/test_ed25519_jax.py plus small-order A and R; and, in the slow tier,
the same arrays through the JAX verify_kernel (the whole-slice comparison).
Tolerance: exact verdict bits (a verdict difference splits quorums)."""

import functools

import numpy as np
import pytest
import torch

from pbft_tpu_torch.crypto import ed25519 as E
from pbft_tpu_torch.crypto import field as F
from pbft_tpu_torch.crypto import ref
from tests.test_crypto_ref import RFC8032_VECTORS

_RNG = np.random.default_rng(0xED)

_SMALL_ORDER = [
    (1).to_bytes(32, "little"),
    (F.P - 1).to_bytes(32, "little"),
    bytes(32),
    bytes(31) + b"\x80",
]


@functools.lru_cache(maxsize=1)
def _cases():
    """(pubs, msgs, sigs) uint8 arrays and the oracle's verdicts."""
    items = []
    # RFC 8032 seeds re-signed over 32-byte digests, valid and corrupted.
    for seed_hex, _, _, _ in RFC8032_VECTORS[:2]:
        seed = bytes.fromhex(seed_hex)
        pub, digest = ref.public_key(seed), _RNG.bytes(32)
        good = ref.sign(seed, digest)
        items += [(pub, digest, good), (pub, digest, bytes([good[0] ^ 1]) + good[1:])]
    # Random keys: valid, corrupted R, corrupted message.
    for _ in range(4):
        seed, pub = ref.keygen(_RNG.bytes(32))
        msg = _RNG.bytes(32)
        sig = ref.sign(seed, msg)
        items += [(pub, msg, sig), (pub, msg, bytes([sig[0] ^ 0x40]) + sig[1:]), (pub, _RNG.bytes(32), sig)]
    # Malleated S + L.
    seed, pub = ref.keygen(_RNG.bytes(32))
    msg = _RNG.bytes(32)
    sig = ref.sign(seed, msg)
    s = int.from_bytes(sig[32:], "little")
    items.append((pub, msg, sig[:32] + int.to_bytes(s + ref.L, 32, "little")))
    # Bad public keys: y = p, and an off-curve y.
    off_curve = next(
        k.to_bytes(32, "little") for k in range(2, 1000) if ref.point_decompress(k.to_bytes(32, "little")) is None
    )
    items += [(int.to_bytes(F.P, 32, "little"), msg, bytes(64)), (off_curve, msg, bytes(64))]
    # A mixed batch: odd entries with a corrupted S byte.
    for i in range(5):
        seed, pub = ref.keygen(_RNG.bytes(32))
        m = _RNG.bytes(32)
        sg = ref.sign(seed, m)
        if i % 2:
            sg = sg[:32] + bytes([sg[32] ^ 1]) + sg[33:]
        items.append((pub, m, sg))
    # Small-order A (with R = [S]B, which the cofactorless equation
    # accepts, and with a real signature's R), and small-order R.
    seed, pub = ref.keygen(_RNG.bytes(32))
    msg = _RNG.bytes(32)
    sig = ref.sign(seed, msg)
    for enc in _SMALL_ORDER:
        k = int.from_bytes(_RNG.bytes(32), "little") % ref.L
        r_enc = ref.point_compress(ref.scalar_mult(k, ref.BASE))
        items += [(enc, msg, r_enc + k.to_bytes(32, "little")), (enc, msg, sig), (pub, msg, enc + sig[32:])]
    want = [ref.verify(*it) for it in items]
    arrs = tuple(np.stack([np.frombuffer(it[k], np.uint8) for it in items]) for k in range(3))
    return arrs, want


def test_verify_kernel_matches_oracle_in_one_batch():
    (pubs, msgs, sigs), want = _cases()
    assert True in want and False in want
    got = E.verify_kernel(*(torch.from_numpy(a) for a in (pubs, msgs, sigs)))
    assert got.dtype == torch.bool
    assert got.tolist() == want


def test_points_compress_decompress_and_identity():
    seed, pub = ref.keygen(b"\x11" * 32)
    a = ref.point_decompress(pub)
    ok, pt = E.decompress(torch.from_numpy(np.frombuffer(pub, np.uint8).copy()).unsqueeze(0))
    assert bool(ok.all())
    ident = E.identity((1,), "cpu")
    base = E.base_point((1,), "cpu")
    enc = torch.cat(
        [
            E.compress(pt),
            E.compress(E.point_add(pt, pt)),
            E.compress(E.point_double(pt)),
            E.compress(E.point_add(pt, base)),
            E.compress(ident),  # Z = 1, inv(1) through compress
            E.compress(E.point_add(base, ident)),
            E.compress(tuple(torch.zeros_like(c) for c in ident)),  # Z = 0: inv(0) = 0
        ]
    )
    want = [
        pub,
        ref.point_compress(ref.point_add(a, a)),
        ref.point_compress(ref.point_add(a, a)),
        ref.point_compress(ref.point_add(a, ref.BASE)),
        ref.point_compress((0, 1)),
        ref.point_compress(ref.BASE),
        bytes(32),
    ]
    assert [bytes(row.numpy()) for row in enc] == want


@pytest.mark.slow
def test_verify_kernel_matches_jax_verify_kernel():
    import jax

    from pbft_tpu.crypto import ed25519 as JE

    (pubs, msgs, sigs), want = _cases()
    got = E.verify_kernel(*(torch.from_numpy(a) for a in (pubs, msgs, sigs))).tolist()
    jax_got = np.asarray(jax.jit(JE.verify_kernel)(pubs, msgs, sigs)).tolist()
    assert got == jax_got == want
