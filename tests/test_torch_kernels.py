"""The port's three kernel wrappers (pbft_tpu_torch.crypto.kernels).

- tier-1: ladder_plain (the plain version of the ladder kernel) against a
  big-integer [S]B + [h](-A) from the port's oracle, compared compressed;
  the wrappers take the plain version only for CPU tensors and never fall
  back for anything else.
- slow: ladder_plain against the JAX shamir_ladder and against the Pallas
  ladder in interpret mode (narrow tiles, as tests/test_pallas_kernels.py).
- cuda: each CUDA kernel against its plain version on the card (skips on a
  machine without one).

Tolerance: exact equality (limbs after canon, compressed bytes)."""

import os

os.environ.setdefault("PBFT_PALLAS_TB", "8")  # before any pallas_kernels import

import numpy as np
import pytest
import torch

from pbft_tpu_torch.crypto import ed25519 as E
from pbft_tpu_torch.crypto import field as F
from pbft_tpu_torch.crypto import kernels as K
from pbft_tpu_torch.crypto import ref

_RNG = np.random.default_rng(0x1ADDE2)

# Small-order encodings: identity, (0, -1), and the two y = 0 points.
_SMALL_ORDER = [
    (1).to_bytes(32, "little"),
    (F.P - 1).to_bytes(32, "little"),
    bytes(32),
    bytes(31) + b"\x80",
]


def _ladder_case(n_keys: int = 3):
    """(pub encodings, s ints, h ints): real and small-order keys, random
    scalars below L plus zero scalars (identity accumulator)."""
    pubs = [ref.public_key(bytes([i + 7]) * 32) for i in range(n_keys)] + _SMALL_ORDER
    s = [int.from_bytes(_RNG.bytes(32), "little") % ref.L for _ in pubs]
    h = [int.from_bytes(_RNG.bytes(32), "little") % ref.L for _ in pubs]
    s[0] = h[0] = 0
    s[1] = 0
    h[2] = 0
    return pubs, s, h


def _scalar_bits(vals, device="cpu"):
    raw = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in vals])
    return F.scalar_bits(F.bytes_to_limbs(torch.from_numpy(raw).to(device)))


def _ladder_inputs(pubs, s, h, device="cpu"):
    arr = torch.from_numpy(np.stack([np.frombuffer(p, np.uint8) for p in pubs])).to(device)
    ok, a_pt = E.decompress(arr)
    assert bool(ok.all())
    return _scalar_bits(s, device), _scalar_bits(h, device), E.point_neg(a_pt)


def _oracle(pub: bytes, s: int, h: int) -> bytes:
    ax, ay = ref.point_decompress(pub)
    return ref.point_compress(
        ref.point_add(ref.scalar_mult(s, ref.BASE), ref.scalar_mult(h, ((-ax) % ref.P, ay)))
    )


def test_ladder_plain_matches_bigint_oracle():
    pubs, s, h = _ladder_case()
    sb, hb, a_neg = _ladder_inputs(pubs, s, h)
    before = dict(K.LAUNCHES)
    enc = E.compress(K.ladder(sb, hb, a_neg))  # CPU tensors: the plain path
    assert K.LAUNCHES == before, "a CPU call must not count as a kernel launch"
    for i, pub in enumerate(pubs):
        assert bytes(enc[i].numpy()) == _oracle(pub, s[i], h[i]), i


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version; anything else must launch
    the kernel or raise (here: a meta tensor is not a CUDA tensor)."""
    z = torch.empty((4, F.NLIMBS), dtype=torch.int32, device="meta")
    bits = torch.empty((4, 256), dtype=torch.int32, device="meta")
    for call in (lambda: K.inv(z), lambda: K.pow_p58(z), lambda: K.ladder(bits, bits, (z, z, z, z))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    x = torch.zeros((2, F.NLIMBS), dtype=torch.int32)
    assert torch.equal(K.inv(x), K.inv_plain(x))
    assert torch.equal(K.pow_p58(x), K.pow_p58_plain(x))


def test_ladder_digits_are_the_pallas_schedule():
    sb = torch.from_numpy(_RNG.integers(0, 2, size=(3, 256)).astype(np.int32))
    hb = torch.from_numpy(_RNG.integers(0, 2, size=(3, 256)).astype(np.int32))
    dig = K.ladder_digits(sb, hb).numpy()
    for k in range(128):  # step k consumes bit-pair 127 - k
        j = 127 - k
        want = sb[:, 2 * j] + 2 * sb[:, 2 * j + 1] + 4 * hb[:, 2 * j] + 8 * hb[:, 2 * j + 1]
        np.testing.assert_array_equal(dig[:, k], want.numpy())


@pytest.mark.slow
def test_ladder_plain_matches_jax_shamir_ladder_and_pallas_ladder():
    import jax
    import jax.numpy as jnp

    from pbft_tpu.crypto import ed25519 as JE
    from pbft_tpu.crypto import pallas_kernels as PK

    pubs, s, h = _ladder_case(n_keys=1)
    sb, hb, a_neg = _ladder_inputs(pubs, s, h)
    got = E.compress(K.ladder_plain(sb, hb, a_neg)).numpy()
    jsb, jhb = jnp.asarray(sb.numpy()), jnp.asarray(hb.numpy())
    ja = tuple(jnp.asarray(c.numpy()) for c in a_neg)
    want = np.asarray(jax.jit(lambda *a: JE.compress(JE.shamir_ladder(*a)))(jsb, jhb, ja))
    np.testing.assert_array_equal(got, want)
    # The Pallas kernel in interpret mode: one row (minutes-slow interpreter).
    pallas = np.asarray(JE.compress(PK.ladder(jsb[:1], jhb[:1], tuple(c[:1] for c in ja))))
    np.testing.assert_array_equal(got[:1], pallas)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_chain_kernels_match_plain_on_the_card(cuda_device):
    x = np.concatenate(
        [
            np.full((1, F.NLIMBS), 1023, np.int32),
            np.full((1, F.NLIMBS), -1023, np.int32),
            np.array([[1023 if i % 2 else -1023 for i in range(F.NLIMBS)]], np.int32),
            np.zeros((1, F.NLIMBS), np.int32),
            _RNG.integers(-(2**9) + 1, 2**9, size=(252, F.NLIMBS)).astype(np.int32),
        ]
    )
    xt = torch.from_numpy(x).to(cuda_device)
    for kernel, plain in ((K.inv, K.inv_plain), (K.pow_p58, K.pow_p58_plain)):
        n = dict(K.LAUNCHES)
        got = kernel(xt)
        torch.cuda.synchronize()
        assert sum(K.LAUNCHES.values()) == sum(n.values()) + 1
        assert torch.equal(F.canon(got), F.canon(plain(xt)))


@pytest.mark.cuda
def test_ladder_kernel_matches_plain_on_the_card(cuda_device):
    pubs, s, h = _ladder_case()
    sb, hb, a_neg = _ladder_inputs(pubs, s, h, device=cuda_device)
    got = E.compress(K.ladder(sb, hb, a_neg))
    want = E.compress(K.ladder_plain(sb, hb, a_neg))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for i, pub in enumerate(pubs):
        assert bytes(got[i].cpu().numpy()) == _oracle(pub, s[i], h[i]), i
