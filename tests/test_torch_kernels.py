"""The port's four kernel wrappers (pbft_tpu_torch.crypto.kernels).

- tier-1: ladder_plain (the plain version of the ladder kernel) against a
  big-integer [S]B + [h](-A) from the port's oracle, compared compressed;
  the wrappers take the plain version only for CPU tensors and never fall
  back for anything else.
- tier-1: a numpy model of how the CUDA kernels split a field multiply over
  a group of k lanes (``csrc/fe25519.cuh``): each lane's output columns
  from the extended operand, the dedicated squaring's paired columns, and
  the per-lane carry with the lane k-1 -> lane 0 (x 38) wrap, against
  ``field.mul`` and ``field.carry`` raw limb for raw limb, every partial
  sum inside int32.
- slow: ladder_plain against the JAX shamir_ladder and against the Pallas
  ladder in interpret mode (narrow tiles, as tests/test_pallas_kernels.py).
- tier-1: the SHA-512 wrapper takes its plain version on the CPU and raises
  on a non-uint8, non-contiguous or non-CUDA tensor; every C entry point's
  ctypes signature matches its declaration in ``csrc/``; the body of
  ``csrc/sha512.cu`` compiled as host C++ (a shim for the CUDA built-ins,
  one call a thread) against hashlib on every card case below.
- cuda: each CUDA kernel against its plain version on the card, raw limbs,
  at ragged sizes and on the hostile-bounds rows; the SHA-512 kernel
  against its plain version and hashlib at every window shape (16-8,192
  rows), at 1, 17 and 300 rows, at lengths across the one-to-two-block
  padding edge and on hostile rows (``SHA512_CASES``; the plain version
  equals the JAX sha512 on the same cases in tests/test_torch_sha512.py);
  verify_kernel on the card against the oracle (skips on a machine
  without one).

Tolerance: exact equality (raw limbs, digest bytes, verdict bits, and
compressed bytes against the big-integer oracle)."""

import hashlib
import os
import re
import shutil
import subprocess

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


# ---------------------------------------------------------------------------
# The lane split of csrc/fe25519.cuh, modelled in numpy (int64, so that an
# int32 overflow of the kernels' arithmetic would show instead of wrapping).
# ---------------------------------------------------------------------------

_LANE_WIDTHS = (4, 8, 16)  # the kernels use 8; the split keeps the integers at each width


def _hostile_rows():
    """+-1023 per limb, alternating, and zero: the loosest multiply inputs."""
    return np.stack(
        [
            np.full(F.NLIMBS, 1023),
            np.full(F.NLIMBS, -1023),
            np.array([1023 if i % 2 else -1023 for i in range(F.NLIMBS)]),
            np.zeros(F.NLIMBS, np.int64),
        ]
    ).astype(np.int64)


def _in_int32(x):
    assert np.all((x >= -(2**31)) & (x < 2**31)), "an int32 intermediate would overflow"
    return x


def _slot(a):
    """A group's exchange slot: words [0, 32) = 38 a (the extended operand
    a'_k = 38 a_{k+32} for k < 0), [32, 64) = a (a'_k = a_k)."""
    return np.concatenate([_in_int32(38 * a), a], axis=-1)


def _model_mul_columns(a, b, k):
    """Lane j of k owns columns c0 .. c0 + 32/k - 1 (c0 = j * 32/k) and
    forms column c0 + t = sum_m b_m a'_{c0+t-m}, m = 0 .. 31 in order, from
    the window W[q] = a'_{c0+q-32} of the slot."""
    lpl = F.NLIMBS // k
    slot = _slot(a)
    cols = np.empty_like(a)
    for j in range(k):
        c0 = j * lpl
        w = slot[:, c0 : c0 + 32 + lpl]
        for t in range(lpl):
            col = np.zeros(len(a), np.int64)
            for m in range(32):
                col = _in_int32(col + _in_int32(b[:, m] * w[:, t - m + 32]))
            cols[:, c0 + t] = col
    return cols


def _model_sq_columns(a, k):
    """The dedicated squaring: with h0 = c0 / 2 the lane reads
    V[r] = a'_{h0-16+r}; column n = c0 + t (u = t // 2) is
    2 sum_{q=1}^{15} V[u+q+16] V[u-q+16] + V[u+16]^2 + V[u+32] V[u] for even
    n and 2 sum_{q=1}^{16} V[u+q+16] V[u+17-q] for odd n: cross terms
    doubled plus the diagonal, 528 products for the 32 columns."""
    lpl = F.NLIMBS // k
    slot = _slot(a)
    cols = np.empty_like(a)
    products = 0
    for j in range(k):
        c0 = j * lpl
        v = slot[:, c0 // 2 + 16 : c0 // 2 + 48 + lpl // 2]
        for t in range(lpl):
            u = t // 2
            s = np.zeros(len(a), np.int64)
            if t % 2 == 0:
                for q in range(1, 16):
                    s = _in_int32(s + _in_int32(v[:, u + q + 16] * v[:, u - q + 16]))
                col = _in_int32(_in_int32(2 * s) + _in_int32(v[:, u + 16] * v[:, u + 16]))
                col = _in_int32(col + _in_int32(v[:, u + 32] * v[:, u]))
                products += 17
            else:
                for q in range(1, 17):
                    s = _in_int32(s + _in_int32(v[:, u + q + 16] * v[:, u + 17 - q]))
                col = _in_int32(2 * s)
                products += 16
            cols[:, c0 + t] = col
    assert products == 528
    return cols


def _model_lane_carry(x, k, passes):
    """Each pass: every limb keeps its low byte and takes the carry of the
    limb below; a lane's first limb gets it from the previous lane's top
    limb (a shuffle), and lane 0 from lane k - 1's times 38."""
    lpl = F.NLIMBS // k
    for _ in range(passes):
        hi = x >> 8
        out = x & 0xFF
        for j in range(k):
            c0 = j * lpl
            incoming = hi[:, (c0 - 1) % F.NLIMBS]
            out[:, c0] += 38 * incoming if j == 0 else incoming
            for t in range(1, lpl):
                out[:, c0 + t] += hi[:, c0 + t - 1]
        x = _in_int32(out)
    return x


def _model_operands():
    """(a, b): every pair of hostile rows, random carried limbs, and random
    limbs anywhere in [-1023, 1023]."""
    h = _hostile_rows()
    a = [np.repeat(h, len(h), axis=0), _RNG.integers(-(2**9) + 1, 2**9, size=(16, F.NLIMBS))]
    b = [np.tile(h, (len(h), 1)), _RNG.integers(-(2**9) + 1, 2**9, size=(16, F.NLIMBS))]
    a.append(_RNG.integers(-1023, 1024, size=(16, F.NLIMBS)))
    b.append(_RNG.integers(-1023, 1024, size=(16, F.NLIMBS)))
    return np.concatenate(a).astype(np.int64), np.concatenate(b).astype(np.int64)


@pytest.mark.parametrize("k", _LANE_WIDTHS)
def test_lane_split_multiply_and_square_equal_field_mul(k):
    a, b = _model_operands()
    want_ab = F.mul(torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32)))
    want_aa = F.mul(torch.from_numpy(a.astype(np.int32)), torch.from_numpy(a.astype(np.int32)))
    got_ab = _model_lane_carry(_model_mul_columns(a, b, k), k, 4)
    np.testing.assert_array_equal(got_ab, want_ab.numpy())
    sq_cols = _model_sq_columns(a, k)
    np.testing.assert_array_equal(sq_cols, _model_mul_columns(a, a, k))  # same column integers
    np.testing.assert_array_equal(_model_lane_carry(sq_cols, k, 4), want_aa.numpy())


@pytest.mark.parametrize("k", _LANE_WIDTHS)
def test_lane_carry_equals_field_carry(k):
    x = _RNG.integers(-(2**30), 2**30, size=(64, F.NLIMBS)).astype(np.int64)
    x[:4] = np.stack([np.full(F.NLIMBS, 2**31 - 1), np.full(F.NLIMBS, -(2**31)),
                      _hostile_rows()[2], np.zeros(F.NLIMBS)])
    for passes in (2, 4):
        want = F.carry(torch.from_numpy(x.astype(np.int32)), passes=passes).numpy()
        np.testing.assert_array_equal(_model_lane_carry(x, k, passes), want)


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


_CARD_SIZES = (1, 17, 256)  # ragged: fewer items than one block's groups, then several blocks


@pytest.mark.cuda
def test_chain_kernels_match_plain_on_the_card(cuda_device):
    x = np.concatenate(
        [_hostile_rows(), _RNG.integers(-(2**9) + 1, 2**9, size=(252, F.NLIMBS))]
    ).astype(np.int32)
    for n in _CARD_SIZES:
        xt = torch.from_numpy(x[:n].copy()).to(cuda_device)
        for kernel, plain in ((K.inv, K.inv_plain), (K.pow_p58, K.pow_p58_plain)):
            before = sum(K.LAUNCHES.values())
            got = kernel(xt)
            torch.cuda.synchronize()
            assert sum(K.LAUNCHES.values()) == before + 1
            assert torch.equal(got, plain(xt)), (kernel.__name__, n)  # raw limbs


@pytest.mark.cuda
def test_ladder_kernel_matches_plain_on_the_card(cuda_device):
    """Raw limbs at ragged sizes; compressed points against the oracle on
    curve rows. The hostile rows replace -A with limbs that are not a
    curve point (+-1023 per limb, alternating, zero): raw limbs only."""
    pubs, s, h = _ladder_case()
    for n in (1, 17):
        pick = [i % len(pubs) for i in range(n)]
        sb, hb, a_neg = _ladder_inputs([pubs[i] for i in pick], [s[i] for i in pick],
                                       [h[i] for i in pick], device=cuda_device)
        got = K.ladder(sb, hb, a_neg)
        want = K.ladder_plain(sb, hb, a_neg)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), n
        enc = E.compress(got)
        for row, i in enumerate(pick):
            assert bytes(enc[row].cpu().numpy()) == _oracle(pubs[i], s[i], h[i]), (n, row)
    hostile = torch.from_numpy(_hostile_rows().astype(np.int32)).to(cuda_device)
    bad = tuple(torch.cat([c[: len(hostile)], hostile]) for c in a_neg)
    m = len(bad[0])
    sb2, hb2 = sb[:1].expand(m, 256).contiguous(), hb[:1].expand(m, 256).contiguous()
    got = K.ladder(sb2, hb2, bad)
    want = K.ladder_plain(sb2, hb2, bad)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# The SHA-512 kernel.
# ---------------------------------------------------------------------------

# name -> (rows, bytes a row): every window shape a path forms, ragged row
# counts, lengths across the one-to-two-block padding edge (111 bytes pad
# to one block, 112 to two), and hostile rows at the window's 96 bytes.
SHA512_CASES = {
    **{f"rows{r}": (r, 96) for r in (16, 64, 256, 1024, 4096, 8192, 1, 17, 300)},
    **{f"len{n}": (17, n) for n in (0, 96, 111, 112, 128, 200)},
    "all_zero": (130, 96),
    "all_ff": (130, 96),
    "one_bit_apart": (1 + 96 * 8, 96),
}


def sha512_case(name: str) -> np.ndarray:
    """The (rows, n) uint8 rows of one case, the same on every machine:
    random rows with an all-0x00, an all-0xff and a one-bit-flipped row
    first, or the hostile case whole (``one_bit_apart``: a random row, then
    that row with each of its bits flipped in turn)."""
    rows, n = SHA512_CASES[name]
    rng = np.random.default_rng(list(SHA512_CASES).index(name))
    x = rng.integers(0, 256, size=(rows, n), dtype=np.uint8)
    if name == "all_zero":
        x[:] = 0
    elif name == "all_ff":
        x[:] = 0xFF
    elif name == "one_bit_apart":
        bit = np.arange(n * 8)
        x[1:] = x[0]
        x[1 + bit, bit // 8] ^= (1 << (bit % 8)).astype(np.uint8)
    elif n:
        x[: min(rows, 3)] = np.array([[0], [0xFF], [0]], np.uint8)[: min(rows, 3)]
        if rows > 2:
            x[2, n // 2] = 0x10
    return x


def _hashlib_rows(x: np.ndarray) -> np.ndarray:
    return np.stack([np.frombuffer(hashlib.sha512(r.tobytes()).digest(), np.uint8) for r in x])


def test_sha512_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(sha512_case("len111"))
    before = dict(K.LAUNCHES)
    got = K.sha512(x)
    assert K.LAUNCHES == before, "a CPU call must not count as a kernel launch"
    assert torch.equal(got, K.sha512_plain(x))
    np.testing.assert_array_equal(got.numpy(), _hashlib_rows(x.numpy()))


@pytest.mark.parametrize("what, msg", [
    ("int32", torch.empty((4, 96), dtype=torch.int32, device="meta")),
    ("contiguous", torch.empty((96, 4), dtype=torch.uint8, device="meta").t()),
    ("CUDA", torch.empty((4, 96), dtype=torch.uint8, device="meta")),
])
def test_sha512_wrapper_raises_on_what_the_kernel_does_not_take(what, msg):
    """Off the CPU the wrapper launches its kernel or raises: a wrong dtype,
    a strided view and a tensor on another device (here: meta) all raise
    before anything is launched."""
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match=what):
        K.sha512(msg)
    assert K.LAUNCHES == before


def test_entry_points_match_their_c_declarations():
    """Each wrapper's C entry point is declared in its library's source
    with as many parameters as its ctypes signature, and its kernel's name
    (the fragment ptxas reports are matched by) is a __global__ there."""
    for name, (lib, entry, frag) in K.KERNELS.items():
        src = (K._CSRC / K._SOURCES[lib]).read_text()
        decl = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
        assert decl, (name, entry)
        assert len(decl.group(1).split(",")) == len(K.ARGTYPES[entry]), name
        assert re.search(r"__global__[^;{]*\b" + frag.split("ILb")[0], src), (name, frag)


_SHIM = r"""
#include <cstdint>
#include <cstdio>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(n)
struct { unsigned x; } blockIdx, threadIdx;
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (s & 31));
}
static inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
"""

_DRIVER = r"""
int main(int argc, char** argv) {
  const int rows = atoi(argv[1]), n = atoi(argv[2]);
  std::vector<uint8_t> in((size_t)rows * n + 1), out((size_t)rows * 64);
  if (fread(in.data(), 1, (size_t)rows * n, stdin) != (size_t)rows * n) return 2;
  for (unsigned b = 0; b < (unsigned)(rows + SHA512_THREADS - 1) / SHA512_THREADS; ++b)
    for (unsigned t = 0; t < SHA512_THREADS; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      sha512_kernel(in.data(), out.data(), rows, n);
    }
  fwrite(out.data(), 1, out.size(), stdout);
  return 0;
}
"""


@pytest.fixture(scope="module")
def sha512_host_binary(tmp_path_factory):
    """csrc/sha512.cu's kernel compiled as host C++: its CUDA built-ins
    shimmed, its launcher left out, each CUDA thread one call."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the kernel's body for the host")
    src = (K._CSRC / "sha512.cu").read_text()
    body = src.replace("#include <cuda_runtime.h>", "").split('extern "C"')[0]
    path = tmp_path_factory.mktemp("sha512_host")
    (path / "sha512_host.cc").write_text(_SHIM + body + "#include <cstdlib>\n" + _DRIVER)
    binary = path / "sha512_host"
    subprocess.run([cxx, "-std=c++17", "-O1", "-fsanitize=undefined", "-fno-sanitize-recover=all",
                    "-o", str(binary), str(path / "sha512_host.cc")], check=True, capture_output=True, timeout=300)
    return binary


@pytest.mark.parametrize("case", list(SHA512_CASES))
def test_sha512_kernel_body_on_the_host_matches_hashlib(sha512_host_binary, case):
    x = sha512_case(case)
    run = subprocess.run([str(sha512_host_binary), str(x.shape[0]), str(x.shape[1])], input=x.tobytes(),
                         capture_output=True, check=True, timeout=120)
    got = np.frombuffer(run.stdout, np.uint8).reshape(x.shape[0], 64)
    np.testing.assert_array_equal(got, _hashlib_rows(x))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SHA512_CASES))
def test_sha512_kernel_matches_plain_and_hashlib_on_the_card(cuda_device, case):
    x = sha512_case(case)
    before = K.LAUNCHES["sha512"]
    got = K.sha512(torch.from_numpy(x).to(cuda_device)).cpu()
    assert K.LAUNCHES["sha512"] == before + 1
    assert torch.equal(got, K.sha512_plain(torch.from_numpy(x))), case
    np.testing.assert_array_equal(got.numpy(), _hashlib_rows(x))


def _verdict_batch():
    """Valid signatures beside bad signatures (R, S + L, message), bad keys
    (y = p, off the curve, small order) and the Byzantine signer's 0xff
    signatures."""
    items = []
    for i in range(6):
        seed = bytes([0x31 + i]) * 32
        pub, msg = ref.public_key(seed), bytes([i]) * 32
        sig = ref.sign(seed, msg)
        s = int.from_bytes(sig[32:], "little")
        items += [(pub, msg, sig), (pub, msg, bytes([sig[0] ^ 1]) + sig[1:]),
                  (pub, msg, sig[:32] + (s + ref.L).to_bytes(32, "little")),
                  (pub, bytes([i ^ 0x80]) * 32, sig), (pub, msg, b"\xff" * 64)]
    pub0, msg0, sig0 = items[0]
    off_curve = next(k.to_bytes(32, "little") for k in range(2, 1000)
                     if ref.point_decompress(k.to_bytes(32, "little")) is None)
    items += [((2**255 - 19).to_bytes(32, "little"), msg0, sig0), (off_curve, msg0, sig0)]
    items += [(enc, msg0, sig0) for enc in _SMALL_ORDER]
    return items


@pytest.mark.cuda
def test_verify_kernel_on_the_card_equals_the_oracle(cuda_device):
    items = _verdict_batch()
    arrays = [torch.from_numpy(np.stack([np.frombuffer(it[k], np.uint8) for it in items])).to(cuda_device)
              for k in range(3)]
    K.reset_launches()
    got = E.verify_kernel(*arrays).cpu().tolist()
    assert K.LAUNCHES == {name: 1 for name in K.KERNELS}
    want = [ref.verify(*it) for it in items]
    assert want.count(True) == 6 and got == want
