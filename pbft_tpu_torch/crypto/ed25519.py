"""Ed25519 verification on PyTorch tensors: the port of
``pbft_tpu/crypto/ed25519.py``.

Per item (pub 32 B, msg 32 B digest, sig 64 B = R || S):
  1. h = SHA-512(R || pub || msg) reduced mod L      (sha512.py + field.py)
  2. decompress pub -> A (reject non-canonical y, off-curve, x = 0 & sign)
  3. P = [S]B + [h](-A) via the 2-bit-window Shamir ladder (128 steps over
     a 16-entry table, complete extended twisted-Edwards addition)
  4. valid = canonical(S) & ok(A) & (compress(P) == R)

Cofactorless, strict S < L: the accept set of the RFC 8032 oracle ``ref``.

Points are tuples (X, Y, Z, T) of (..., 32) int32 limb tensors. The three
long multiply chains go through ``kernels``: ``pow_p58`` (in sqrt_ratio),
``inv`` (in compress) and ``ladder``, and the challenge hash through
``sha512`` (``kernels.sha512``). On a CUDA tensor each launches its CUDA
kernel; on a CPU tensor each runs its plain version. There is no
environment switch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import field as F
from . import kernels
from . import ref
from .sha512 import sha512

# Static curve constants, as limb arrays (from the oracle's big ints).
_D = F.limbs_const(ref.D)
_D2 = F.limbs_const(2 * ref.D % F.P)
_SQRT_M1 = F.limbs_const(pow(2, (F.P - 1) // 4, F.P))
_BX = F.limbs_const(ref.BASE[0])
_BY = F.limbs_const(ref.BASE[1])
_BT = F.limbs_const(ref.BASE[0] * ref.BASE[1] % F.P)
_ONE = F.limbs_const(1)
_ZERO = F.limbs_const(0)

# [0]B, [1]B, [2]B, [3]B in extended coords (X, Y, Z=1, T=XY): the static
# row of the Shamir table (ref.shamir_row0, shared with kernels.LADDER_CONSTS).
_ROW0 = tuple(
    np.stack([F.limbs_const(v) for v in coords]) for coords in zip(*ref.shamir_row0())
)  # 4 arrays of shape (4, 32): X-row, Y-row, Z-row, T-row


def _full(arr: np.ndarray, shape, device) -> torch.Tensor:
    """A static limb vector broadcast to shape + (32,), materialized."""
    c = F._const(arr, torch.empty(0, device=device))
    return c.expand(tuple(shape) + (F.NLIMBS,)).contiguous()


def _identity(shape, device: torch.device):
    z = _full(_ZERO, shape, device)
    o = _full(_ONE, shape, device)
    return (z, o, o, z)


def identity(shape=(), device=None):
    """The neutral point (0, 1, 1, 0) on ``device`` (``None``: the card)."""
    return _identity(shape, resolve_device(device))


def base_point(shape=(), device=None):
    """The base point B on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    return tuple(_full(c, shape, device) for c in (_BX, _BY, _ONE, _BT))


def point_add(p, q):
    """Complete unified addition (a=-1 twisted Edwards, extended coords)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = F.mul(F.sub(y1, x1), F.sub(y2, x2))
    b = F.mul(F.add(y1, x1), F.add(y2, x2))
    c = F.mul(F.mul(t1, F._const(_D2, t1)), t2)
    d = F.mul_small(F.mul(z1, z2), 2)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def point_double(p):
    """Dedicated doubling (dbl-2008-hwcd, a=-1): 4M+4S."""
    x1, y1, z1, _ = p
    a = F.sqr(x1)
    b = F.sqr(y1)
    c = F.mul_small(F.sqr(z1), 2)
    d = F.neg(a)  # a = -1 twist
    e = F.sub(F.sub(F.sqr(F.add(x1, y1)), a), b)
    g = F.add(d, b)
    f = F.sub(g, c)
    h = F.sub(d, b)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def point_neg(p):
    x, y, z, t = p
    return (F.neg(x), y, z, F.neg(t))


def sqrt_ratio(u, v):
    """(ok, r) with v*r^2 == u when ok; the p = 5 (mod 8) method."""
    v2 = F.sqr(v)
    v3 = F.mul(v, v2)
    v7 = F.mul(v3, F.sqr(v2))
    r = F.mul(F.mul(u, v3), kernels.pow_p58(F.mul(u, v7)))
    check = F.mul(v, F.sqr(r))
    ok_plus = F.eq(check, u)
    ok_minus = F.eq(check, F.neg(u))
    r = torch.where(ok_minus.unsqueeze(-1), F.mul(r, F._const(_SQRT_M1, r)), r)
    return ok_plus | ok_minus, r


def decompress(ybytes):
    """(…,32) uint8 -> (ok, point). RFC 8032 §5.1.3 decoding."""
    ybytes = ybytes.to(torch.uint8)
    sign = (ybytes[..., 31] >> 7).to(torch.int32)
    masked = ybytes.clone()
    masked[..., 31] &= 0x7F
    y = F.bytes_to_limbs(masked)
    _, b = F._borrow_sub(y, F._P_LIMBS, F.NLIMBS)
    ok_canon = b < 0  # y < p
    one = _full(_ONE, y.shape[:-1], y.device)
    y2 = F.sqr(y)
    u = F.sub(y2, one)
    v = F.add(F.mul(y2, F._const(_D, y)), one)
    ok_sqrt, x = sqrt_ratio(u, v)
    x = F.canon(x)
    x_zero = torch.all(x == 0, dim=-1)
    ok = ok_canon & ok_sqrt & ~(x_zero & (sign == 1))
    flip = (x[..., 0] & 1) != sign
    x = torch.where(flip.unsqueeze(-1), F.neg(x), x)
    return ok, (x, y, one, F.mul(x, y))


def compress(p):
    """Point -> (…,32) uint8 canonical encoding."""
    x, y, z, _ = p
    zi = kernels.inv(z)
    xa = F.canon(F.mul(x, zi))
    out = F.limbs_to_bytes(F.mul(y, zi))
    out[..., 31] += ((xa[..., 0] & 1) << 7).to(torch.uint8)
    return out


def shamir_ladder(s_bits, h_bits, a_neg):
    """[S]B + [h](-A) with a joint 2-bit window: one 16-entry table lookup
    per pair of scalar bits, 128 steps of (2 doublings + 1 addition).

    The table E[s + 4h] = [s]B + [h](-A) is built exactly as the JAX module
    builds it (the static [s]B row, then one batched point_add of that row
    against [1..3](-A)); the step picks E[d] by direct indexing, which
    gives the values of the JAX module's 4-level select mux.

    s_bits, h_bits: (…,256) int32 LSB-first; a_neg: point with (…,32)
    coordinates. This is the plain version of ``kernels.ladder``.
    """
    lead = s_bits.shape[:-1]
    g = s_bits.numel() // 256
    dev = s_bits.device
    sb = s_bits.reshape(g, 256)
    hb = h_bits.reshape(g, 256)
    a1 = tuple(c.reshape(g, F.NLIMBS) for c in a_neg)
    row0 = tuple(F._const(c, sb).reshape(4, 1, F.NLIMBS).expand(4, g, F.NLIMBS) for c in _ROW0)
    a2 = point_double(a1)
    a3 = point_add(a2, a1)
    arows = tuple(torch.stack([a1[c], a2[c], a3[c]]).unsqueeze(1) for c in range(4))
    prods = point_add(tuple(r.unsqueeze(0) for r in row0), arows)  # (3, 4, g, 32)
    entries = tuple(
        torch.cat([row0[c].unsqueeze(0), prods[c]]).reshape(16, g, F.NLIMBS) for c in range(4)
    )  # index = 4h + s
    digits = kernels.ladder_digits(sb, hb)  # (g, 128), MSB-first
    rows = torch.arange(g, device=dev)
    acc = _identity((g,), dev)
    for k in range(128):
        d = digits[:, k]
        sel = tuple(e[d, rows] for e in entries)
        acc = point_add(point_double(point_double(acc)), sel)
    return tuple(c.reshape(lead + (F.NLIMBS,)) for c in acc)


def verify_kernel(pub, msg, sig):
    """(…,32),(…,32),(…,64) uint8 tensors -> (…,) bool. Batch-agnostic."""
    pub = pub.to(torch.uint8)
    msg = msg.to(torch.uint8)
    sig = sig.to(torch.uint8)
    r_bytes = sig[..., :32]
    s_bytes = sig[..., 32:]
    # Challenge hash: h = SHA512(R || A || M) mod L.
    h_raw = sha512(torch.cat([r_bytes, pub, msg], dim=-1))
    h = F.reduce512_mod_l(F.bytes_to_limbs(h_raw))
    s = F.bytes_to_limbs(s_bytes)
    s_ok = F.scalar_lt_l(s)
    ok_a, a_pt = decompress(pub)
    p = kernels.ladder(F.scalar_bits(s), F.scalar_bits(h), point_neg(a_pt))
    enc = compress(p)
    match = torch.all(enc == r_bytes, dim=-1)
    return ok_a & s_ok & match
