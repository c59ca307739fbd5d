// Cooperative GF(2^255-19) field and extended twisted-Edwards point
// arithmetic for the port's CUDA kernels (chains.cu, ladder.cu): a group of
// FE_K lanes of one warp owns one field element, FE_L = 32 / FE_K limbs per
// lane, lane j holding limbs j*FE_L .. j*FE_L + FE_L - 1.
//
// Mirrors the in-kernel primitives of pbft_tpu/crypto/pallas_kernels.py
// (_carry, _mm/_sq, _madd/_msub/_mneg/_mul_small, _pdbl/_padd) and computes
// the same integers as pbft_tpu_torch/crypto/field.py: signed radix-2^8
// int32 limbs, the 2^256 = 38 (mod p) fold, 2 carry passes after an
// add/sub/neg and 4 after a multiply and after mul_small<2>.
//
// Multiply. Each lane computes its own FE_L output columns of the
// schoolbook product, column n = sum_{i+m=n} a_i b_m + 38 sum_{i+m=n+32}
// a_i b_m, the columns of field.mul. With the extended operand
// a'_k = a_k (k >= 0), a'_k = 38 a_{k+32} (k < 0) the column is
// sum_m b_m a'_{n-m}: the lane reads all of b and the window of a' that its
// columns need, and every register index is a compile-time constant. The
// squaring uses that the 32 terms of a column pair up (T_m = T_{n-m mod 32}):
// 2 * (sum over one term of each pair) + the terms that pair with
// themselves (a_h^2 and 38 a_{h+16}^2 for even n = 2h), 528 products a
// square instead of 1,024, and the same column integers.
//
// Bounds: the field.py proof holds unchanged. Inputs to a multiply are
// carried or sums of at most 4 carried values (|limb| < 2^10.3); every
// partial sum of a column is bounded by the sum of the absolute values of
// all its terms, 1,179 products of at most 38 |a_i| |b_m| (< 2^30.9), so
// no signed int32 overflows (which would be undefined in C++).
// tests/test_torch_kernels.py models this split column for column and
// checks every partial sum at |limb| = 1023. `>>` on a negative int32 is an
// arithmetic shift under nvcc, as the carry needs.
//
// Exchange. A multiply stores the lane's limbs of 38a, a and b in its
// group's slot in shared memory, __syncwarp, and reads the vectors back as
// 16-byte loads: a multiply moves 32 + 32 + FE_L = 68 words into each lane
// in 17 128-bit loads, where warp shuffles would take one instruction per
// word (68), plus a select between a and 38 a. The slot was chosen for
// that instruction count alone: shuffles were not built, so the choice is
// not measured. Both go through the SM's shared-memory pipe, and a warp's
// multiply keeps that pipe about as long as its multiply-adds keep the
// IMAD pipe (PERF.md), so the exchange is the first suspect for the gap to
// the bound. The carry needs one word from the neighbouring lane per
// pass, a shuffle. Every lane of the warp takes part in every exchange;
// lanes of groups past the batch compute on zeros and skip only their
// global loads and stores.
//
// FE_K = 8 lanes per element was chosen over 4 and 16 on an H100 at
// n = 4096 (PERF.md).
#pragma once

#include <stdint.h>

#define FE_K 8
#define FE_LIMBS 32
#define FE_L (FE_LIMBS / FE_K)

// A group's exchange slot (int32 words): [0, 32) = 38 a (a'_{k} for
// k = s - 32 < 0), [32, 64) = a, [64, 96) = b. 112 words, so that the
// 64-bit reads of two groups in one half-warp fall in different banks.
#define FE_SLOT 112
#define FE_FULL 0xffffffffu

struct fe {
  int32_t v[FE_L];
};

struct ge {  // extended coordinates (X, Y, Z, T), T = XY/Z
  fe X, Y, Z, T;
};

// A lane's place: its index in the group and its group's exchange slot.
struct lane_ctx {
  int j;
  int32_t* slot;
};

// N words from src to dst in VW-word vectors (src aligned to VW words).
template <int VW, int N>
__device__ __forceinline__ void ld_words(int32_t* dst, const int32_t* src) {
  static_assert((VW == 2 || VW == 4) && N % VW == 0, "2- or 4-word vectors that divide the count");
#pragma unroll
  for (int u = 0; u < N; u += VW) {
    if constexpr (VW == 4) {
      const int4 t = *reinterpret_cast<const int4*>(src + u);
      dst[u] = t.x, dst[u + 1] = t.y, dst[u + 2] = t.z, dst[u + 3] = t.w;
    } else {
      const int2 t = *reinterpret_cast<const int2*>(src + u);
      dst[u] = t.x, dst[u + 1] = t.y;
    }
  }
}

template <int VW, int N>
__device__ __forceinline__ void st_words(int32_t* dst, const int32_t* src) {
  static_assert((VW == 2 || VW == 4) && N % VW == 0, "2- or 4-word vectors that divide the count");
#pragma unroll
  for (int u = 0; u < N; u += VW) {
    if constexpr (VW == 4) {
      *reinterpret_cast<int4*>(dst + u) = make_int4(src[u], src[u + 1], src[u + 2], src[u + 3]);
    } else {
      *reinterpret_cast<int2*>(dst + u) = make_int2(src[u], src[u + 1]);
    }
  }
}

// This lane's limbs of the element at p (32 words, 16-byte aligned).
__device__ __forceinline__ fe fe_load(const lane_ctx& c, const int32_t* p) {
  fe r;
  ld_words<4, FE_L>(r.v, p + c.j * FE_L);
  return r;
}

__device__ __forceinline__ void fe_store(const lane_ctx& c, int32_t* p, const fe& x) {
  st_words<4, FE_L>(p + c.j * FE_L, x.v);
}

// Vectorized carry: every limb splits into (low byte, carry) at once and
// the carries move up one limb; limb 0 of each lane takes the carry of the
// previous lane's top limb, and the carry leaving limb 31 (lane FE_K - 1)
// re-enters limb 0 times 38.
template <int PASSES>
__device__ __forceinline__ fe fe_carry(const lane_ctx& c, fe x) {
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    int32_t hi[FE_L];
#pragma unroll
    for (int t = 0; t < FE_L; ++t) hi[t] = x.v[t] >> 8;
    int32_t in = __shfl_sync(FE_FULL, hi[FE_L - 1], c.j + FE_K - 1, FE_K);
    if (c.j == 0) in *= 38;
    x.v[0] = (x.v[0] & 0xFF) + in;
#pragma unroll
    for (int t = 1; t < FE_L; ++t) x.v[t] = (x.v[t] & 0xFF) + hi[t - 1];
  }
  return x;
}

// Put a' = (38 a, a) into the slot; b too when given.
__device__ __forceinline__ void fe_share(const lane_ctx& c, const fe& a, const fe* b) {
  const int c0 = c.j * FE_L;
  fe a38;
#pragma unroll
  for (int t = 0; t < FE_L; ++t) a38.v[t] = 38 * a.v[t];
  __syncwarp(FE_FULL);  // the previous exchange's reads are done
  st_words<4, FE_L>(c.slot + c0, a38.v);
  st_words<4, FE_L>(c.slot + 32 + c0, a.v);
  if (b) st_words<4, FE_L>(c.slot + 64 + c0, b->v);
  __syncwarp(FE_FULL);
}

// Schoolbook multiply: column c0 + t = sum_m b_m a'_{c0+t-m}, with
// W[q] = a'_{c0+q-32} (slot words c0 .. c0 + 31 + FE_L).
__device__ __forceinline__ fe fe_mul(const lane_ctx& c, const fe& a, const fe& b) {
  const int c0 = c.j * FE_L;
  fe_share(c, a, &b);
  int32_t B[32], W[32 + FE_L];
  ld_words<4, 32>(B, c.slot + 64);
  ld_words<4, 32 + FE_L>(W, c.slot + c0);
  fe r;
#pragma unroll
  for (int t = 0; t < FE_L; ++t) {
    int32_t col = 0;
#pragma unroll
    for (int m = 0; m < 32; ++m) col += B[m] * W[t - m + 32];
    r.v[t] = col;
  }
  return fe_carry<4>(c, r);
}

// Dedicated squaring. With h0 = c0 / 2 the lane reads V[r] = a'_{h0-16+r}
// (slot words h0 + 16 .. h0 + 47 + FE_L / 2). Column n = c0 + t, h = n / 2:
// even n: 2 sum_{q=1}^{15} a_{h+q} a'_{h-q} + a_h^2 + a_{h+16} a'_{h-16};
// odd n:  2 sum_{q=1}^{16} a_{h+q} a'_{h+1-q}.
__device__ __forceinline__ fe fe_sq(const lane_ctx& c, const fe& a) {
  const int c0 = c.j * FE_L;
  fe_share(c, a, nullptr);
  int32_t V[32 + FE_L / 2];
  ld_words<2, 32 + FE_L / 2>(V, c.slot + c0 / 2 + 16);
  fe r;
#pragma unroll
  for (int t = 0; t < FE_L; ++t) {
    const int u = t / 2;
    int32_t s = 0;
    if (t % 2 == 0) {
#pragma unroll
      for (int q = 1; q <= 15; ++q) s += V[u + q + 16] * V[u - q + 16];
      r.v[t] = 2 * s + V[u + 16] * V[u + 16] + V[u + 32] * V[u];
    } else {
#pragma unroll
      for (int q = 1; q <= 16; ++q) s += V[u + q + 16] * V[u + 17 - q];
      r.v[t] = 2 * s;
    }
  }
  return fe_carry<4>(c, r);
}

__device__ __forceinline__ fe fe_add(const lane_ctx& c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int t = 0; t < FE_L; ++t) r.v[t] = a.v[t] + b.v[t];
  return fe_carry<2>(c, r);
}

__device__ __forceinline__ fe fe_sub(const lane_ctx& c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int t = 0; t < FE_L; ++t) r.v[t] = a.v[t] - b.v[t];
  return fe_carry<2>(c, r);
}

// 2p - a: limbs of 2p = 2^256 - 38 are 218, then 255 thirty-one times.
__device__ __forceinline__ fe fe_neg(const lane_ctx& c, const fe& a) {
  fe r;
  r.v[0] = (c.j == 0 ? 218 : 255) - a.v[0];
#pragma unroll
  for (int t = 1; t < FE_L; ++t) r.v[t] = 255 - a.v[t];
  return fe_carry<2>(c, r);
}

template <int K>
__device__ __forceinline__ fe fe_mul_small(const lane_ctx& c, const fe& a) {
  fe r;
#pragma unroll
  for (int t = 0; t < FE_L; ++t) r.v[t] = a.v[t] * K;
  return fe_carry<4>(c, r);
}

__device__ __forceinline__ fe fe_pow2k(const lane_ctx& c, fe x, int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) x = fe_sq(c, x);
  return x;
}

// dbl-2008-hwcd (a = -1): mirrors ed25519.point_double / _pdbl.
__device__ __forceinline__ ge ge_dbl(const lane_ctx& c, const ge& p) {
  const fe a = fe_sq(c, p.X);
  const fe b = fe_sq(c, p.Y);
  const fe cc = fe_mul_small<2>(c, fe_sq(c, p.Z));
  const fe d = fe_neg(c, a);
  const fe e = fe_sub(c, fe_sub(c, fe_sq(c, fe_add(c, p.X, p.Y)), a), b);
  const fe g = fe_add(c, d, b);
  const fe f = fe_sub(c, g, cc);
  const fe h = fe_sub(c, d, b);
  return ge{fe_mul(c, e, f), fe_mul(c, g, h), fe_mul(c, f, g), fe_mul(c, e, h)};
}

// add-2008-hwcd-3 (complete, unified): mirrors ed25519.point_add / _padd.
// d2 = 2d mod p.
__device__ __forceinline__ ge ge_add(const lane_ctx& c, const ge& p, const ge& q, const fe& d2) {
  const fe a = fe_mul(c, fe_sub(c, p.Y, p.X), fe_sub(c, q.Y, q.X));
  const fe b = fe_mul(c, fe_add(c, p.Y, p.X), fe_add(c, q.Y, q.X));
  const fe cc = fe_mul(c, fe_mul(c, p.T, d2), q.T);
  const fe d = fe_mul_small<2>(c, fe_mul(c, p.Z, q.Z));
  const fe e = fe_sub(c, b, a);
  const fe f = fe_sub(c, d, cc);
  const fe g = fe_add(c, d, cc);
  const fe h = fe_add(c, b, a);
  return ge{fe_mul(c, e, f), fe_mul(c, g, h), fe_mul(c, f, g), fe_mul(c, e, h)};
}
