"""SHA-512 on PyTorch tensors, fixed-shape and batched.

The port of ``pbft_tpu/crypto/sha512.py``: the Ed25519 challenge hash
h = SHA-512(R || A || M) over a 96-byte input (one block after padding),
though any static length works.

Each 64-bit word is a (hi, lo) pair of 32-bit halves, as in the JAX module.
PyTorch has no ``>>``, ``<<``, ``+``, ``<`` or ``~`` on uint32, so each half
is held in an **int64** tensor masked to [0, 2^32): shifts of a non-negative
int64 are logical, sums cannot overflow, and the ``_add64`` carry keeps the
JAX module's unsigned-compare logic. The round constants and initial state
are derived from first principles (FIPS 180-4 §4.2.3/§5.3.5).

``sha512`` runs this plain version (``sha512_plain``) on a CPU tensor and
the CUDA kernel (``kernels.sha512``, ``csrc/sha512.cu``) on a card, with no
fallback: the plain version is the CPU path and the kernel's yardstick.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import kernels

_MASK64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF


def _primes(count: int) -> list[int]:
    out, n = [], 2
    while len(out) < count:
        if all(n % q for q in range(2, int(math.isqrt(n)) + 1)):
            out.append(n)
        n += 1
    return out


def _iroot(n: int, k: int) -> int:
    """Integer floor k-th root by Newton iteration."""
    x = 1 << ((n.bit_length() + k - 1) // k)
    while True:
        y = ((k - 1) * x + n // x ** (k - 1)) // k
        if y >= x:
            return x
        x = y


_PRIMES = _primes(80)
# H0_i = first 64 fractional bits of sqrt(prime_i); K_t likewise for cbrt.
_H0 = [math.isqrt(p << 128) & _MASK64 for p in _PRIMES[:8]]
_K = [_iroot(p << 192, 3) & _MASK64 for p in _PRIMES]
_H0_HI = np.array([h >> 32 for h in _H0], dtype=np.uint32)
_H0_LO = np.array([h & _M32 for h in _H0], dtype=np.uint32)
_K_HI = np.array([k >> 32 for k in _K], dtype=np.uint32)
_K_LO = np.array([k & _M32 for k in _K], dtype=np.uint32)


# A 64-bit lane is the pair (hi, lo) of int64 tensors in [0, 2^32).


def _add64(a, b):
    lo = (a[1] + b[1]) & _M32
    hi = (a[0] + b[0] + (lo < a[1]).to(torch.int64)) & _M32
    return hi, lo


def _rotr(x, n: int):
    hi, lo = x
    if n >= 32:
        hi, lo = lo, hi
        n -= 32
    if n == 0:
        return hi, lo
    m = 32 - n
    return (((hi >> n) | (lo << m)) & _M32, ((lo >> n) | (hi << m)) & _M32)


def _shr(x, n: int):
    """Logical right shift by n < 32."""
    hi, lo = x
    return (hi >> n, ((lo >> n) | (hi << (32 - n))) & _M32)


def _xor(*xs):
    hi, lo = xs[0]
    for x in xs[1:]:
        hi = hi ^ x[0]
        lo = lo ^ x[1]
    return hi, lo


def _big_sigma0(x):
    return _xor(_rotr(x, 28), _rotr(x, 34), _rotr(x, 39))


def _big_sigma1(x):
    return _xor(_rotr(x, 14), _rotr(x, 18), _rotr(x, 41))


def _small_sigma0(x):
    return _xor(_rotr(x, 1), _rotr(x, 8), _shr(x, 7))


def _small_sigma1(x):
    return _xor(_rotr(x, 19), _rotr(x, 61), _shr(x, 6))


def _compress_block(state, whi, wlo):
    """One SHA-512 compression. state: 8-tuple of (hi, lo) pairs of (...,)
    int64; whi/wlo: (..., 16) int64 big-endian message word halves."""
    w = [(whi[..., t], wlo[..., t]) for t in range(16)]
    for t in range(16, 80):
        w.append(
            _add64(
                _add64(_small_sigma1(w[t - 2]), w[t - 7]),
                _add64(_small_sigma0(w[t - 15]), w[t - 16]),
            )
        )
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        kt = (int(_K_HI[t]), int(_K_LO[t]))
        ch = (
            (e[0] & f[0]) ^ ((e[0] ^ _M32) & g[0]),
            (e[1] & f[1]) ^ ((e[1] ^ _M32) & g[1]),
        )
        maj = (
            (a[0] & b[0]) ^ (a[0] & c[0]) ^ (b[0] & c[0]),
            (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]),
        )
        t1 = _add64(_add64(_add64(h, _big_sigma1(e)), _add64(ch, kt)), w[t])
        t2 = _add64(_big_sigma0(a), maj)
        a, b, c, d, e, f, g, h = _add64(t1, t2), a, b, c, _add64(d, t1), e, f, g
    out = (a, b, c, d, e, f, g, h)
    return tuple(_add64(s, o) for s, o in zip(state, out))


_CONSTS: dict = {}


def _consts(n: int, dev: torch.device):
    """The padding block of an n-byte message and the byte shifts, as
    tensors on ``dev``, uploaded once per device: a copy per call would
    block the host and cannot be captured into a CUDA graph."""
    key = (n, dev)
    out = _CONSTS.get(key)
    if out is None:
        nblocks = (n + 17 + 127) // 128
        pad = np.zeros(nblocks * 128 - n, np.uint8)
        pad[0] = 0x80
        pad[-16:] = np.frombuffer((n * 8).to_bytes(16, "big"), np.uint8)
        shifts = np.array([24, 16, 8, 0], np.int64)
        out = _CONSTS.setdefault(key, (torch.from_numpy(pad).to(dev), torch.from_numpy(shifts).to(dev)))
    return out


def sha512(msg) -> torch.Tensor:
    """SHA-512 of a fixed-length byte tensor: ``sha512_plain`` on the CPU,
    the CUDA kernel on a card (``kernels.sha512``, which raises on anything
    else).

    msg: (..., N) uint8. Returns (..., 64) uint8 digest on msg's device.
    """
    return kernels.sha512(msg)


def sha512_plain(msg) -> torch.Tensor:
    """SHA-512 of a fixed-length byte tensor, in plain PyTorch ops.

    msg: (..., N) uint8. Returns (..., 64) uint8 digest on msg's device.
    """
    dev = msg.device
    lead = msg.shape[:-1]
    pad, shifts = _consts(msg.shape[-1], dev)
    padded = torch.cat([msg.to(torch.uint8), pad.expand(lead + pad.shape)], dim=-1)
    nblocks = padded.shape[-1] // 128
    # Big-endian 64-bit words as (hi, lo) halves: bytes 0-3 / 4-7.
    grouped = padded.reshape(lead + (nblocks, 16, 2, 4)).to(torch.int64)
    halves = (grouped << shifts).sum(dim=-1)  # (..., nblocks, 16, 2)
    whi = halves[..., 0]
    wlo = halves[..., 1]

    state = tuple(
        (
            torch.full(lead, int(hi), dtype=torch.int64, device=dev),
            torch.full(lead, int(lo), dtype=torch.int64, device=dev),
        )
        for hi, lo in zip(_H0_HI, _H0_LO)
    )
    for blk in range(nblocks):
        state = _compress_block(state, whi[..., blk, :], wlo[..., blk, :])

    digest = torch.stack(
        [(half.unsqueeze(-1) >> shifts) & 0xFF for s in state for half in s],
        dim=-2,
    )
    return digest.reshape(lead + (64,)).to(torch.uint8)
