"""The port's SHA-512 (pbft_tpu_torch.crypto.sha512) against hashlib at the
lengths of tests/test_sha512.py, and against the JAX sha512 on the same
(B, 96) batch the verifier hashes and on every case the card tests run the
kernel on (tests/test_torch_kernels.py ``SHA512_CASES``: the kernel equals
this plain version there, so it equals the JAX sha512 too). The kernel's
constant tables (``csrc/sha512.cu``) equal this module's. Tolerance: exact
digest bytes."""

import hashlib
import re

import jax
import numpy as np
import pytest
import torch

from pbft_tpu.crypto.sha512 import sha512 as jax_sha512
from pbft_tpu.crypto import sha512 as JS
from pbft_tpu_torch.crypto import kernels as K
from pbft_tpu_torch.crypto import sha512 as S
from tests.test_torch_kernels import SHA512_CASES, sha512_case

_RNG = np.random.default_rng(0x5A512)


@pytest.mark.parametrize("n", [0, 1, 3, 55, 95, 96, 111, 112, 127, 128, 129, 200, 256])
def test_sha512_matches_hashlib(n):
    msg = _RNG.bytes(n)
    got = bytes(S.sha512(torch.from_numpy(np.frombuffer(msg, np.uint8).copy())).numpy())
    assert got == hashlib.sha512(msg).digest()


def test_sha512_batch_of_96_matches_jax_and_hashlib():
    batch = _RNG.integers(0, 256, size=(9, 96), dtype=np.uint8)
    got = S.sha512(torch.from_numpy(batch)).numpy()
    want = np.asarray(jax.jit(jax_sha512)(batch))
    np.testing.assert_array_equal(got, want)
    for row, msg in zip(got, batch):
        assert bytes(row) == hashlib.sha512(bytes(msg)).digest()


def test_sha512_constants_match_jax():
    for name in ("_H0_HI", "_H0_LO", "_K_HI", "_K_LO"):
        np.testing.assert_array_equal(getattr(S, name), getattr(JS, name), err_msg=name)


@pytest.mark.parametrize("case", list(SHA512_CASES))
def test_plain_sha512_matches_jax_on_the_kernels_card_cases(case):
    x = sha512_case(case)
    got = S.sha512_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jax_sha512)(x)))
    assert bytes(got[0]) == hashlib.sha512(x[0].tobytes()).digest()


def test_kernel_constants_match_the_plain_version():
    src = (K._CSRC / "sha512.cu").read_text()

    def table(name):
        body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
        return [int(v, 16) for v in re.findall(r"0x([0-9a-f]{16})ULL", body)]

    assert table("SHA512_K") == S._K
    assert table("SHA512_H0") == S._H0


def test_second_call_on_a_device_uploads_nothing(monkeypatch):
    """The padding block and the byte shifts are per-device constants: after
    the first call on a device, sha512 makes no host-to-device upload (an
    upload blocks the host and cannot be captured into a CUDA graph)."""
    msg = torch.from_numpy(_RNG.integers(0, 256, size=(3, 96), dtype=np.uint8))
    first = S.sha512(msg)
    uploads = []

    def counting(real):
        def wrapper(*args, **kwargs):
            uploads.append(real.__name__)
            return real(*args, **kwargs)

        return wrapper

    for name in ("from_numpy", "tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, counting(getattr(torch, name)))
    again = S.sha512(msg)
    assert uploads == []
    assert torch.equal(first, again)
