"""Plain RFC 8032 Ed25519 (section 5.1) in Python integers, the yardstick's
own verifier: it imports nothing of the system under test.

``verify`` follows section 5.1.7: decode A and R (a y of p or more, or x = 0
with the sign bit set, fails), reject S >= L, k = SHA-512(R || A || M) mod L,
and accept when the encoding of [S]B - [k]A equals R's bytes (the
cofactorless equation [S]B = R + [k]A, which section 5.1.7 allows). The
scalar products share one double-and-add pass (Straus), so one verify is a
few milliseconds.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

_BY = 4 * pow(5, P - 2, P) % P


def _recover_x(y: int, sign: int):
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
# Extended coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z, xy = T/Z.
B = (_BX, _BY, 1, _BX * _BY % P)
IDENTITY = (0, 1, 1, 0)


def point_add(p, q):
    a = (p[1] - p[0]) * (q[1] - q[0]) % P
    b = (p[1] + p[0]) * (q[1] + q[0]) % P
    c = 2 * p[3] * q[3] * D % P
    d = 2 * p[2] * q[2] % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_double(p):
    a = p[0] * p[0] % P
    b = p[1] * p[1] % P
    c = 2 * p[2] * p[2] % P
    h = a + b
    e = h - (p[0] + p[1]) ** 2
    g = a - b
    f = c + g
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_neg(p):
    return ((-p[0]) % P, p[1], p[2], (-p[3]) % P)


def double_scalar_mult(s: int, p, k: int, q):
    """[s]p + [k]q, one doubling pass over both scalars."""
    pq = point_add(p, q)
    acc = IDENTITY
    for i in range(max(s.bit_length(), k.bit_length()) - 1, -1, -1):
        acc = point_double(acc)
        bits = ((s >> i) & 1, (k >> i) & 1)
        if bits == (1, 1):
            acc = point_add(acc, pq)
        elif bits == (1, 0):
            acc = point_add(acc, p)
        elif bits == (0, 1):
            acc = point_add(acc, q)
    return acc


def encode(p) -> bytes:
    zinv = pow(p[2], P - 2, P)
    x, y = p[0] * zinv % P, p[1] * zinv % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def decode(s: bytes):
    if len(s) != 32:
        return None
    y = int.from_bytes(s, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _sha512_int(data: bytes) -> int:
    return int.from_bytes(hashlib.sha512(data).digest(), "little")


def _expand(secret: bytes):
    h = hashlib.sha512(secret).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key(secret: bytes) -> bytes:
    a, _ = _expand(secret)
    return encode(double_scalar_mult(a, B, 0, IDENTITY))


def sign(secret: bytes, msg: bytes) -> bytes:
    a, prefix = _expand(secret)
    pub = encode(double_scalar_mult(a, B, 0, IDENTITY))
    r = _sha512_int(prefix + msg) % L
    big_r = encode(double_scalar_mult(r, B, 0, IDENTITY))
    k = _sha512_int(big_r + pub + msg) % L
    return big_r + int.to_bytes((r + k * a) % L, 32, "little")


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    if len(pub) != 32 or len(sig) != 64:
        return False
    a_point = decode(pub)
    if a_point is None or decode(sig[:32]) is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = _sha512_int(sig[:32] + pub + msg) % L
    return encode(double_scalar_mult(s, B, k, point_neg(a_point))) == sig[:32]
