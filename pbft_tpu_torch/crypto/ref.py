"""Pure-Python reference Ed25519 (RFC 8032) on big ints.

The PyTorch port's own copy of ``pbft_tpu/crypto/ref.py`` (hashlib only),
kept so the port imports nothing of the JAX package. It is the port's
correctness oracle and host-side signer, and the single source of the
static Shamir-table row (``shamir_row0``) and the batch pad triple.
``tests/test_torch_batch.py`` pins the tables derived from it equal to the
JAX package's.

Implementation notes: textbook twisted-Edwards affine arithmetic over
GF(2^255-19); cofactorless verification equation [S]B == R + [h]A with strict
S < L (RFC 8032 §5.1.7).
"""

from __future__ import annotations

import hashlib
import secrets
from typing import Tuple

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
# Edwards curve constant d = -121665/121666 mod p.
D = (-121665 * pow(121666, P - 2, P)) % P

# Base point B: y = 4/5, x recovered with the even-x convention then negated
# to the canonical odd... (RFC 8032: base point has positive/even x? The
# canonical base point x is the one with x mod 2 == 0.)
_BY = (4 * pow(5, P - 2, P)) % P


def _sqrt_ratio(u: int, v: int) -> Tuple[bool, int]:
    """Return (ok, r) with r^2 * v == u (mod p) when ok.

    Uses the p ≡ 5 (mod 8) trick: candidate r = u * v^3 * (u*v^7)^((p-5)/8),
    correcting by sqrt(-1) when needed.
    """
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    if check == u % P:
        return True, r
    if check == (-u) % P:
        return True, r * pow(2, (P - 1) // 4, P) % P
    return False, 0


def _recover_x(y: int, sign: int) -> int | None:
    """x from y on -x^2 + y^2 = 1 + d x^2 y^2, choosing the given sign bit."""
    if y >= P:
        return None
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    ok, x = _sqrt_ratio(u, v)
    if not ok:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
assert _BX is not None
BASE = (_BX, _BY)


def point_add(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    x1, y1 = a
    x2, y2 = b
    den = D * x1 * x2 % P * y1 % P * y2 % P
    x3 = (x1 * y2 + x2 * y1) * pow(1 + den, P - 2, P)
    y3 = (y1 * y2 + x1 * x2) * pow(1 - den, P - 2, P)
    return x3 % P, y3 % P


def shamir_row0() -> list:
    """[0]B..[3]B as (x, y, z=1, t=xy) ints: the static h=0 row of the
    verifier's Shamir table. Single source for the plain ladder
    (ed25519.py) and the CUDA ladder's constant block (kernels.py) — two
    copies that drift would split replicas."""
    b2 = point_add(BASE, BASE)
    b3 = point_add(b2, BASE)
    rows = [(0, 1, 1, 0)]
    for p in (BASE, b2, b3):
        rows.append((p[0], p[1], 1, p[0] * p[1] % P))
    return rows


_D2 = 2 * D % P


def _ext_add(p, q):
    """Complete unified addition in extended coordinates (a=-1); avoids the
    per-addition inversions of the affine form — this is the host signer's
    hot loop."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * _D2 % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def scalar_mult(k: int, pt: Tuple[int, int]) -> Tuple[int, int]:
    acc = (0, 1, 1, 0)
    cur = (pt[0], pt[1], 1, pt[0] * pt[1] % P)
    while k:
        if k & 1:
            acc = _ext_add(acc, cur)
        cur = _ext_add(cur, cur)
        k >>= 1
    x, y, z, _ = acc
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def point_compress(pt: Tuple[int, int]) -> bytes:
    x, y = pt
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def point_decompress(data: bytes) -> Tuple[int, int] | None:
    if len(data) != 32:
        return None
    enc = int.from_bytes(data, "little")
    y = enc & ((1 << 255) - 1)
    x = _recover_x(y, enc >> 255)
    if x is None:
        return None
    return x, y


def _h512_int(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little")


def secret_expand(seed: bytes) -> Tuple[int, bytes]:
    """seed -> (clamped scalar a, hash prefix for nonce derivation)."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def keygen(seed: bytes | None = None) -> Tuple[bytes, bytes]:
    """Return (seed a.k.a. private key, 32-byte public key)."""
    if seed is None:
        seed = secrets.token_bytes(32)
    a, _ = secret_expand(seed)
    return seed, point_compress(scalar_mult(a, BASE))


def public_key(seed: bytes) -> bytes:
    a, _ = secret_expand(seed)
    return point_compress(scalar_mult(a, BASE))


def sign(seed: bytes, msg: bytes) -> bytes:
    a, prefix = secret_expand(seed)
    pub = point_compress(scalar_mult(a, BASE))
    r = _h512_int(prefix, msg) % L
    big_r = point_compress(scalar_mult(r, BASE))
    h = _h512_int(big_r, pub, msg) % L
    s = (r + h * a) % L
    return big_r + int.to_bytes(s, 32, "little")


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Cofactorless RFC 8032 verify: [S]B == R + [h]A, strict S < L."""
    if len(sig) != 64 or len(pub) != 32:
        return False
    a_pt = point_decompress(pub)
    if a_pt is None:
        return False
    r_pt = point_decompress(sig[:32])
    if r_pt is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    h = _h512_int(sig[:32], pub, msg) % L
    lhs = scalar_mult(s, BASE)
    rhs = point_add(r_pt, scalar_mult(h, a_pt))
    return lhs == rhs
