"""GF(2^255-19) and mod-L arithmetic on PyTorch int32 tensors.

The port of ``pbft_tpu/crypto/field.py``, integer for integer. Field
elements are (..., 32) **int32** tensors of signed radix-2^8 limbs,
little-endian (value = sum limb_i * 2^(8*i)), so the canonical byte
encoding and the limb vector coincide. Limbs may drift above 8 bits between
operations ("loose" form); every multiply renormalizes.

Bounds (the JAX module's proof carries over unchanged because the radix and
the carry schedule are the same): a carried limb is < 2^8 + 38, and every
mul input is a sum/difference of at most 4 carried values, so
|limb| < 2^10.3. Schoolbook columns are < 32 * 2^20.6 = 2^25.6 and the
38-fold (2^256 = 38 mod p) keeps every intermediate < 2^30.9, inside int32.
The CUDA kernels (``csrc/fe25519.cuh``) compute the same integers.

Everything is batch-agnostic (leading dims broadcast) and has no
data-dependent control flow. JAX's ``x.at[i].add(v)`` becomes
clone-and-update; ``fori_loop`` becomes a Python loop.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ..device import resolve_device

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
DELTA = L - 2**252
NLIMBS = 32
RADIX = 8
MASK = 0xFF

_DTYPE = torch.int32


def limbs_const(v: int, n: int = NLIMBS) -> np.ndarray:
    """Static Python int -> (n,) int32 limb array (8-bit, little-endian)."""
    return np.array([(v >> (RADIX * i)) & MASK for i in range(n)], dtype=np.int32)


def limbs_to_int(arr) -> int:
    """(…,32) limbs -> Python int (tests/debug only; takes the last axis)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    a = np.asarray(arr, dtype=object)
    return int(sum(int(x) << (RADIX * i) for i, x in enumerate(a)))


def from_numpy(x, device=None):
    """The JAX package's numpy limb arrays (or point tuples of them) -> the
    port's tensors on ``device`` (``None``: the card, see
    ``device.resolve_device``). Integer arrays keep their width (int32
    limbs, uint8 bytes); anything array-like goes through ``np.asarray``."""
    device = resolve_device(device)
    if isinstance(x, (tuple, list)):
        return tuple(from_numpy(c, device) for c in x)
    return torch.from_numpy(np.array(np.asarray(x))).to(device)


_CONST_CACHE: dict = {}


def _const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A module-level constant array as an int32 tensor on like's device,
    copied to each device once (a copy per call would stall the stream)."""
    key = (id(arr), like.device)
    t = _CONST_CACHE.get(key)
    if t is None:
        t = _CONST_CACHE.setdefault(key, torch.as_tensor(arr, dtype=_DTYPE, device=like.device))
    return t


_P_LIMBS = limbs_const(P)
_2P_LIMBS = limbs_const(2 * P)


def carry_seq(x):
    """One exact sequential carry pass; wraps the 2^256 overflow back as
    *38 (mod p). Limbs end in [0, 2^8) except limb 0, which keeps a small
    fold residue. Used by canon(); the hot path uses ``carry``."""
    out = []
    c = torch.zeros_like(x[..., 0])
    for i in range(NLIMBS):
        v = x[..., i] + c
        c = v >> RADIX
        out.append(v & MASK)
    out[0] = out[0] + 38 * c
    return torch.stack(out, dim=-1)


def carry(x, passes: int = 2):
    """Vectorized carry: each pass splits every limb into (low byte, carry)
    at once and shifts the carries up one limb; the carry leaving limb 31
    re-enters limb 0 as *38. 2 passes for sums/differences of carried
    values, 4 for mul's folded columns (same schedule as the JAX module)."""
    for _ in range(passes):
        lo = x & MASK
        hi = x >> RADIX  # arithmetic shift: exact floor even for negatives
        x = lo + torch.cat([38 * hi[..., NLIMBS - 1 :], hi[..., : NLIMBS - 1]], dim=-1)
    return x


def add(a, b):
    return carry(a + b)


def sub(a, b):
    return carry(a - b)


def neg(a):
    return carry(_const(_2P_LIMBS, a) - a)


def mul(a, b):
    """Field multiply, schoolbook. Inputs carried (|limb| < 2^10.3), output
    carried.

    cols[n] = sum_{i+j=n} a_i b_j for n < 63, built from the (…, 32, 32)
    outer product by shifting row i right by i (pad each row to 64, view the
    rows at stride 63) and summing over rows: the same columns as the JAX
    module's 32-step shifted accumulate, in a handful of tensor ops. Then
    the columns at 2^256 and up fold back as *38 and 4 carry passes follow.
    """
    a, b = torch.broadcast_tensors(a, b)
    lead = a.shape[:-1]
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)  # [..., i, j] = a_i * b_j
    rows = TF.pad(prod, (0, NLIMBS)).reshape(lead + (2 * NLIMBS * NLIMBS,))
    rows = rows[..., : NLIMBS * (2 * NLIMBS - 1)].reshape(lead + (NLIMBS, 2 * NLIMBS - 1))
    cols = rows.sum(dim=-2, dtype=_DTYPE)  # (…, 63)
    lo = cols[..., :NLIMBS] + 38 * TF.pad(cols[..., NLIMBS:], (0, 1))
    return carry(lo, passes=4)


def sqr(a):
    return mul(a, a)


def mul_small(a, k: int):
    """Multiply by a small static scalar (k*limb must stay inside int32)."""
    return carry(a * k, passes=4)


def pow2k(x, k: int):
    """x^(2^k) by k squarings."""
    for _ in range(k):
        x = sqr(x)
    return x


def _inv_chain(z, mul=None, sqr=None, pow2k=None):
    """Shared ladder: returns (z^(2^250-1), z^11).

    The classic curve25519 exponent chain, reused by inv() (exponent p-2)
    and pow_p58() (exponent (p-5)/8). The ops are parameters, as in the JAX
    module; ``csrc/chains.cu`` runs the same sequence of squarings and
    multiplies with its device functions."""
    mul = mul or globals()["mul"]
    sqr = sqr or globals()["sqr"]
    pow2k = pow2k or globals()["pow2k"]
    z2 = sqr(z)
    z8 = pow2k(z2, 2)
    z9 = mul(z, z8)
    z11 = mul(z2, z9)
    z22 = sqr(z11)
    z_5_0 = mul(z9, z22)  # 2^5 - 1
    z_10_0 = mul(pow2k(z_5_0, 5), z_5_0)  # 2^10 - 1
    z_20_0 = mul(pow2k(z_10_0, 10), z_10_0)  # 2^20 - 1
    z_40_0 = mul(pow2k(z_20_0, 20), z_20_0)  # 2^40 - 1
    z_50_0 = mul(pow2k(z_40_0, 10), z_10_0)  # 2^50 - 1
    z_100_0 = mul(pow2k(z_50_0, 50), z_50_0)  # 2^100 - 1
    z_200_0 = mul(pow2k(z_100_0, 100), z_100_0)  # 2^200 - 1
    z_250_0 = mul(pow2k(z_200_0, 50), z_50_0)  # 2^250 - 1
    return z_250_0, z11


def inv(z):
    """z^(p-2) = z^(2^255-21): the field inverse (inv(0) = 0)."""
    z_250_0, z11 = _inv_chain(z)
    return mul(pow2k(z_250_0, 5), z11)


def pow_p58(z):
    """z^((p-5)/8) = z^(2^252-3), used for the square-root-ratio."""
    z_250_0, _ = _inv_chain(z)
    return mul(pow2k(z_250_0, 2), z)


def _borrow_sub(x, limbs: np.ndarray, n: int):
    """Sequential x - limbs over n limbs: (digits, final borrow)."""
    b = torch.zeros_like(x[..., 0])
    digits = []
    for i in range(n):
        v = x[..., i] - int(limbs[i]) + b
        digits.append(v & MASK)
        b = v >> RADIX
    return torch.stack(digits, dim=-1), b


def canon(x):
    """Canonical form: limbs in [0, 2^8), value in [0, p)."""
    x = carry_seq(carry_seq(x))
    # Force non-negativity: add 2p (== 0 mod p).
    x = carry_seq(x + _const(_2P_LIMBS, x))
    # Fold bit 255+: value < 2^256 -> < 2^255 + 38.
    hi = x[..., NLIMBS - 1] >> (RADIX - 1)
    x = x.clone()
    x[..., NLIMBS - 1] -= hi << (RADIX - 1)
    x[..., 0] += 19 * hi
    x = carry_seq(x)
    # At most two conditional subtracts of p remain.
    for _ in range(2):
        y, b = _borrow_sub(x, _P_LIMBS, NLIMBS)
        x = torch.where((b == 0).unsqueeze(-1), y, x)  # no borrow -> x >= p
    return x


def eq(a, b):
    return torch.all(canon(a) == canon(b), dim=-1)


def is_zero(a):
    return torch.all(canon(a) == 0, dim=-1)


def bytes_to_limbs(b):
    """(…,n) uint8 little-endian -> (…,n) int32 limbs (a cast at radix 2^8)."""
    return b.to(_DTYPE)


def limbs_to_bytes(x):
    """Canonical limbs -> (…,32) uint8 little-endian."""
    return canon(x).to(torch.uint8)


# ---------------------------------------------------------------------------
# Scalar arithmetic mod L (group order), for the challenge hash and S check.
# ---------------------------------------------------------------------------

_L_LIMBS = limbs_const(L)

# 512-bit inputs are 64 limbs; all fold intermediates live in 65 limbs.
_NL512 = 65


def _plain_carry(x, n: int):
    """Carry pass without any modular fold (plain multi-precision integer)."""
    out = []
    c = torch.zeros_like(x[..., 0])
    for i in range(n):
        v = x[..., i] + c
        c = v >> RADIX
        out.append(v & MASK)
    out[-1] = out[-1] + (c << RADIX)  # keep any residue in the top limb
    return torch.stack(out, dim=-1)


def _mul_by_const(x, nx: int, const_limbs: np.ndarray, nout: int):
    """Multi-precision multiply of x (nx limbs) by a static constant."""
    cols = torch.zeros(x.shape[:-1] + (nout,), dtype=_DTYPE, device=x.device)
    for i in range(len(const_limbs)):
        ci = int(const_limbs[i])
        if ci == 0:
            continue
        hi = min(nx, nout - i)
        cols[..., i : i + hi] += ci * x[..., :hi]
    return cols


_FOLD_M: list[np.ndarray] = []


def _build_fold_constants():
    """Static M_k*L addends keeping each 2^252-fold non-negative (see the
    JAX module: M_k = floor(2^(S_k-127)/L) + 2 for S_k = 512, 390, 266)."""
    for s in (512, 390, 266):
        m = (1 << max(s - 127, 0)) // L + 2
        _FOLD_M.append(limbs_const(m * L, _NL512))


_build_fold_constants()
_DELTA_LIMBS = limbs_const(DELTA, 16)


def reduce512_mod_l(x):
    """(…,64) limbs (512-bit LE integer) -> (…,32) limbs in [0, L)."""
    x = x.to(_DTYPE)
    x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
    x = _plain_carry(x, _NL512)
    for m_l in _FOLD_M:
        # hi = x >> 252: bit 252 sits at limb 31 bit 4, so each hi limb
        # stitches the top nibble of x[31+i] to the low nibble of x[32+i].
        hi = (x[..., 31:64] >> 4) | ((x[..., 32:65] & 0xF) << 4)
        hi = torch.cat([hi, x[..., 64:65] >> 4], dim=-1)  # 34 limbs
        lo = x.clone()
        lo[..., 31] = x[..., 31] & 0xF
        lo[..., 32:] = 0
        prod = TF.pad(_mul_by_const(hi, 34, _DELTA_LIMBS, 50), (0, _NL512 - 50))
        x = _plain_carry(lo - prod + _const(m_l, lo), _NL512)
    # Value now < 2^254-ish: at most 3 conditional subtracts of L.
    x = x[..., : NLIMBS + 1]
    l_ext = np.concatenate([_L_LIMBS, np.zeros(1, np.int32)])
    for _ in range(4):
        y, b = _borrow_sub(x, l_ext, NLIMBS + 1)
        x = torch.where((b == 0).unsqueeze(-1), y, x)
    return x[..., :NLIMBS]


def scalar_lt_l(s):
    """(…,32) limbs -> bool: is the 256-bit scalar strictly below L?"""
    _, b = _borrow_sub(s, _L_LIMBS, NLIMBS)
    return b < 0


def scalar_bits(s, nbits: int = 256):
    """(…,32) limbs -> (…, nbits) int32 bit array, LSB first."""
    shifts = torch.arange(RADIX, dtype=_DTYPE, device=s.device)
    bits = (s.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(s.shape[:-1] + (NLIMBS * RADIX,))[..., :nbits].to(_DTYPE)
