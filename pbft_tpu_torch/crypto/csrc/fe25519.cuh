// Per-thread GF(2^255-19) field and extended twisted-Edwards point
// arithmetic for the port's CUDA kernels (chains.cu, ladder.cu).
//
// Mirrors the in-kernel primitives of pbft_tpu/crypto/pallas_kernels.py
// (_carry, _mm/_sq, _madd/_msub/_mneg/_mul_small, _pdbl/_padd) and computes
// the same integers as pbft_tpu_torch/crypto/field.py: signed radix-2^8
// int32 limbs, the 2^256 = 38 (mod p) fold, 2 carry passes after an
// add/sub/neg and 4 after a multiply. The bounds proof of field.py holds
// unchanged: inputs to a multiply are carried (|limb| < 2^10.3), columns
// stay < 2^25.6 and lo + 38*hi < 2^30.9, so no signed int32 overflows (which
// would be undefined in C++). `>>` on a negative int32 is an arithmetic
// shift under nvcc, as the carry needs.
//
// One thread owns one field element (or one signature). Every 32-limb loop
// is fully unrolled so that limb indices are compile-time constants and the
// values stay in registers; the long loops of a chain are kept rolled
// (`#pragma unroll 1`) to bound code size.
#pragma once

#include <stdint.h>

#define FE_LIMBS 32

struct fe {
  int32_t v[FE_LIMBS];
};

struct ge {  // extended coordinates (X, Y, Z, T), T = XY/Z
  fe X, Y, Z, T;
};

// Vectorized carry: every limb splits into (low byte, carry) at once; the
// carry leaving limb 31 re-enters limb 0 times 38.
template <int PASSES>
__device__ __forceinline__ fe fe_carry(fe x) {
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int32_t top = x.v[FE_LIMBS - 1] >> 8;
#pragma unroll
    for (int l = FE_LIMBS - 1; l > 0; --l) {
      x.v[l] = (x.v[l] & 0xFF) + (x.v[l - 1] >> 8);
    }
    x.v[0] = (x.v[0] & 0xFF) + 38 * top;
  }
  return x;
}

// Schoolbook multiply, one output column at a time: lo = column n,
// hi = column n + 32, folded as lo + 38 * hi (the columns of field.mul).
__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int n = 0; n < FE_LIMBS; ++n) {
    int32_t lo = 0;
    int32_t hi = 0;
#pragma unroll
    for (int i = 0; i <= n; ++i) lo += a.v[i] * b.v[n - i];
#pragma unroll
    for (int i = n + 1; i < FE_LIMBS; ++i) hi += a.v[i] * b.v[n + FE_LIMBS - i];
    r.v[n] = lo + 38 * hi;
  }
  return fe_carry<4>(r);
}

__device__ __forceinline__ fe fe_sq(const fe& a) { return fe_mul(a, a); }

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int l = 0; l < FE_LIMBS; ++l) r.v[l] = a.v[l] + b.v[l];
  return fe_carry<2>(r);
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int l = 0; l < FE_LIMBS; ++l) r.v[l] = a.v[l] - b.v[l];
  return fe_carry<2>(r);
}

// 2p - a: limbs of 2p = 2^256 - 38 are 218, then 255 thirty-one times.
__device__ __forceinline__ fe fe_neg(const fe& a) {
  fe r;
  r.v[0] = 218 - a.v[0];
#pragma unroll
  for (int l = 1; l < FE_LIMBS; ++l) r.v[l] = 255 - a.v[l];
  return fe_carry<2>(r);
}

template <int K>
__device__ __forceinline__ fe fe_mul_small(const fe& a) {
  fe r;
#pragma unroll
  for (int l = 0; l < FE_LIMBS; ++l) r.v[l] = a.v[l] * K;
  return fe_carry<4>(r);
}

__device__ __forceinline__ fe fe_pow2k(fe x, int k) {
#pragma unroll 1
  for (int j = 0; j < k; ++j) x = fe_sq(x);
  return x;
}

// Limb-major global layout: limb l of item i at p[l * n + i], so the 32
// threads of a warp read 32 consecutive words per limb.
__device__ __forceinline__ fe fe_load(const int32_t* p, int n, int i) {
  fe r;
#pragma unroll
  for (int l = 0; l < FE_LIMBS; ++l) r.v[l] = p[(size_t)l * n + i];
  return r;
}

__device__ __forceinline__ void fe_store(int32_t* p, int n, int i, const fe& x) {
#pragma unroll
  for (int l = 0; l < FE_LIMBS; ++l) p[(size_t)l * n + i] = x.v[l];
}

// dbl-2008-hwcd (a = -1): mirrors ed25519.point_double / _pdbl.
__device__ __forceinline__ ge ge_dbl(const ge& p) {
  const fe a = fe_sq(p.X);
  const fe b = fe_sq(p.Y);
  const fe c = fe_mul_small<2>(fe_sq(p.Z));
  const fe d = fe_neg(a);
  const fe e = fe_sub(fe_sub(fe_sq(fe_add(p.X, p.Y)), a), b);
  const fe g = fe_add(d, b);
  const fe f = fe_sub(g, c);
  const fe h = fe_sub(d, b);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

// add-2008-hwcd-3 (complete, unified): mirrors ed25519.point_add / _padd.
// d2 = 2d mod p.
__device__ __forceinline__ ge ge_add(const ge& p, const ge& q, const fe& d2) {
  const fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  const fe b = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  const fe c = fe_mul(fe_mul(p.T, d2), q.T);
  const fe d = fe_mul_small<2>(fe_mul(p.Z, q.Z));
  const fe e = fe_sub(b, a);
  const fe f = fe_sub(d, c);
  const fe g = fe_add(d, c);
  const fe h = fe_add(b, a);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}
