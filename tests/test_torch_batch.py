"""The port's batch layer (pbft_tpu_torch.crypto.batch) and every static
table the port must share bit for bit with the JAX package: curve
constants, the ladder constant block, SHA-512 constants, the mod-L fold
constants, the pad triple and ladder, and the service's wire constants."""

import numpy as np
import pytest
import torch

from pbft_tpu.crypto import batch as JB
from pbft_tpu.crypto import ed25519 as JE
from pbft_tpu.crypto import field as JF
from pbft_tpu.crypto import pallas_kernels as JPK
from pbft_tpu.crypto import sha512 as JS
from pbft_tpu.net import service as JSV
from pbft_tpu_torch.crypto import batch as B
from pbft_tpu_torch.crypto import ed25519 as E
from pbft_tpu_torch.crypto import field as F
from pbft_tpu_torch.crypto import kernels as K
from pbft_tpu_torch.crypto import ref
from pbft_tpu_torch.crypto import sha512 as S
from pbft_tpu_torch.net import service as SV


def _same(port, jax_side, what):
    want = F.from_numpy(jax_side, "cpu")
    got = F.from_numpy(port, "cpu")
    if isinstance(want, tuple):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            assert torch.equal(g, w), what
    else:
        assert torch.equal(got, want), what


def test_static_tables_equal_the_jax_package():
    for name in ("_D", "_D2", "_SQRT_M1", "_BX", "_BY", "_BT", "_ONE", "_ZERO", "_ROW0"):
        _same(getattr(E, name), getattr(JE, name), name)
    _same(K.LADDER_CONSTS, JPK._LADDER_CONSTS, "_LADDER_CONSTS")
    for name in ("_H0_HI", "_H0_LO", "_K_HI", "_K_LO"):
        _same(getattr(S, name), getattr(JS, name), name)
    _same(tuple(F._FOLD_M), tuple(JF._FOLD_M), "_FOLD_M")
    for name in ("_DELTA_LIMBS", "_P_LIMBS", "_2P_LIMBS", "_L_LIMBS"):
        _same(getattr(F, name), getattr(JF, name), name)
    assert (F.P, F.L, F.NLIMBS, F.RADIX) == (JF.P, JF.L, JF.NLIMBS, JF.RADIX)
    assert (B._PAD_SEED, B._PAD_MSG, B._PAD_LADDER) == (JB._PAD_SEED, JB._PAD_MSG, JB._PAD_LADDER)
    for name in ("_PAD_PUB", "_PAD_SIG", "_PAD_MSG_ARR"):
        _same(getattr(B, name), getattr(JB, name), name)
    for name in (
        "STATUS_PROBE", "STATUS_JSON_PROBE", "STATUS_MAGIC", "STATUS_VERSION", "STATUS_LEN",
        "STATE_WARMING", "STATE_READY", "STATE_CPU_ONLY", "STATE_NAMES",
    ):
        assert getattr(SV, name) == getattr(JSV, name), name
    assert SV.VerifierService.MAX_WINDOW == JSV.VerifierService.MAX_WINDOW
    for args in ((0, 0, 0), (1, 1, 5), (2, 70000, 3)):
        assert SV.pack_status(*args) == JSV.pack_status(*args)
        assert SV.unpack_status(JSV.pack_status(*args)) == JSV.unpack_status(JSV.pack_status(*args))


def test_pad_size_and_size_multiple_match_the_jax_package():
    for n in list(range(0, 70)) + [255, 256, 257, 1024, 4095, 4096, 4097, 5000, 9000]:
        assert B.pad_size(n) == JB.pad_size(n), n
    items = [
        (bytes([i]) * 32, bytes([i ^ 0xFF]) * 32, bytes([i]) * 64) for i in range(1, 12)
    ]
    seen = {}

    def launch(tag):
        def run(pubs, msgs, sigs):
            seen[tag] = (np.array(pubs), np.array(msgs), np.array(sigs))
            return pubs[:, 0] == sigs[:, 0]
        return run

    for kwargs in ({}, {"size_multiple": 3}, {"pad_to": 64, "size_multiple": 5}):
        got = B.verify_many(items, launch=launch("port"), **kwargs)
        want = JB.verify_many(items, launch=launch("jax"), **kwargs)
        assert got == want == [True] * len(items)
        for a, b in zip(seen["port"], seen["jax"]):
            np.testing.assert_array_equal(a, b)
    assert B.verify_many([], device="cpu") == JB.verify_many([]) == []


def test_pad_slots_verify_true_and_verdicts_slice_back():
    seed, pub = ref.keygen(b"\x21" * 32)
    msg = b"\x42" * 32
    sig = ref.sign(seed, msg)
    items = [(pub, msg, sig), (pub, msg, bytes([sig[0] ^ 1]) + sig[1:]), (pub, b"\x43" * 32, sig)]
    pubs, msgs, sigs, n = B.pad_batch(items, 16)
    assert n == 3
    out = B.verify_batch(pubs, msgs, sigs, device="cpu")
    assert out.device.type == "cpu"
    assert out.tolist() == [True, False, False] + [True] * 13


_C1_SEED, _C1_PUB = ref.keygen(b"\x5a" * 32)
_C1_MSG = b"\x17" * 32
_C1_SIG = ref.sign(_C1_SEED, _C1_MSG)


@pytest.mark.parametrize(
    "items",
    [
        # The reported pair: a short key then a long one, the same total
        # length as two good keys.
        [(_C1_PUB[:31], _C1_MSG, _C1_SIG), (_C1_PUB + b"\x00", _C1_MSG, _C1_SIG)],
        [(_C1_PUB[:31], _C1_MSG, _C1_SIG)],
        [(_C1_PUB, _C1_MSG, _C1_SIG), (_C1_PUB + b"\x00", _C1_MSG, _C1_SIG)],
        [(_C1_PUB, _C1_MSG, _C1_SIG[:63])],
        [(_C1_PUB, _C1_MSG, _C1_SIG + b"\x00")],
        [(_C1_PUB, _C1_MSG[:31], _C1_SIG), (_C1_PUB, _C1_MSG + b"\x01", _C1_SIG)],
    ],
    ids=["short_then_long_key", "short_key", "long_key", "short_sig", "long_sig", "message_lengths"],
)
def test_wrong_length_items_raise_in_both_packages(items):
    """pad_batch and verify_many raise ValueError on an item whose key,
    message or signature has the wrong length, in the reference and in the
    port; the launch is never reached."""

    def launch(pubs, msgs, sigs):
        raise AssertionError("a malformed batch reached the launch")

    for pad_batch in (JB.pad_batch, B.pad_batch):
        with pytest.raises(ValueError):
            pad_batch(items, 16)
    for verify_many in (JB.verify_many, B.verify_many):
        with pytest.raises(ValueError):
            verify_many(items, launch=launch)
