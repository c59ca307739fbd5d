// The Shamir double-scalar ladder: [S]B + [h](-A), one signature per group
// of FE_K lanes.
//
// Replaces: pbft_tpu/crypto/pallas_kernels.py _ladder_kernel (wrapper
// `ladder`), i.e. ed25519.shamir_ladder.
//
// What bounds it on the H100: the IMAD pipe. One signature is a doubling
// and 13 additions to build the table, then 128 steps of 2 doublings + 1
// addition: 3,325 field multiplies and squarings, at least 12.4 G int32
// multiply-adds (IMAD pipe) and 8.3 G masks, shifts and adds (ALU pipe) at
// n = 4096, against ~6 MB of inputs and outputs, which is negligible.
// Latency matters as much: each signature is one dependent chain of ~3,300
// products.
//
// Design:
// - a group of FE_K = 8 lanes per signature (fe25519.cuh): at
//   n = 4096 that is 1,024 warps, about 2 on each of the card's 528
//   schedulers, and each lane's 4 output columns are 4 independent
//   multiply-add chains. The accumulator and every temporary are spread
//   over the group, 4 limbs a lane per coordinate instead of 32, so they
//   fit in registers without spilling;
// - squarings are dedicated (528 products, not 1,024);
// - the 16-entry table E[s + 4h] = [s]B + [h](-A), 8 KB per signature, sits
//   in a global scratch buffer the wrapper allocates, laid out (n, 16, 4, 32)
//   so that a group reads one coordinate as contiguous 16-byte vectors; at
//   n = 4096 it is 32 MiB and stays in the 50 MB L2. Each lane reads back
//   only words it wrote itself;
// - verification handles public data only, so the step reads the table row
//   named by its digit directly instead of the TPU kernel's 4-level select
//   mux; the digits (MSB-first, d = s0 + 2 s1 + 4 h0 + 8 h1) come
//   precomputed from the wrapper as a batch-major (n, 128) array;
// - the static constants (2d and the [s]B row) arrive as the same (32, 32)
//   limb-major block the TPU kernel took and are staged once per block in
//   shared memory, transposed so that a lane reads its limbs of one column
//   as one vector.
// The table entries are computed exactly as ed25519.shamir_ladder computes
// them (point_add([s]B, [h](-A)) for all 12 data-dependent entries), so the
// output limbs equal the plain version's, not only its compressed point.
// The boundary is batch-major: (n, 32) coordinates in and out.
//
// Plain C interface (loaded with ctypes): pointers and the stream as void*,
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "fe25519.cuh"

#define LADDER_THREADS 128
#define LADDER_GROUPS (LADDER_THREADS / FE_K)
#define NCONST_COLS 32
#define ENTRY_WORDS (4 * FE_LIMBS)
#define TABLE_WORDS (16 * ENTRY_WORDS)  // per signature
#define LADDER_STEPS 128

// Column `col` of the constant block, staged as sct[col * 32 + limb].
__device__ __forceinline__ fe const_col(const lane_ctx& c, const int32_t* sct, int col) {
  return fe_load(c, sct + col * FE_LIMBS);
}

__device__ __forceinline__ ge row0(const lane_ctx& c, const int32_t* sct, int s) {
  return ge{const_col(c, sct, 3 + 4 * s + 0), const_col(c, sct, 3 + 4 * s + 1),
            const_col(c, sct, 3 + 4 * s + 2), const_col(c, sct, 3 + 4 * s + 3)};
}

// tab: this signature's 16 entries; entry e, coordinate q at tab[(4e + q) * 32].
__device__ __forceinline__ ge load_entry(const lane_ctx& c, const int32_t* tab, int e) {
  const int32_t* p = tab + e * ENTRY_WORDS;
  return ge{fe_load(c, p), fe_load(c, p + FE_LIMBS), fe_load(c, p + 2 * FE_LIMBS),
            fe_load(c, p + 3 * FE_LIMBS)};
}

__device__ __forceinline__ void store_entry(const lane_ctx& c, int32_t* tab, int e, const ge& x) {
  int32_t* p = tab + e * ENTRY_WORDS;
  fe_store(c, p, x.X);
  fe_store(c, p + FE_LIMBS, x.Y);
  fe_store(c, p + 2 * FE_LIMBS, x.Z);
  fe_store(c, p + 3 * FE_LIMBS, x.T);
}

__global__ void __launch_bounds__(LADDER_THREADS) ladder_kernel(
    const int32_t* __restrict__ consts, const int32_t* __restrict__ digits,
    const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
    const int32_t* __restrict__ az, const int32_t* __restrict__ at,
    int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
    int32_t* __restrict__ ot, int32_t* __restrict__ table, int n) {
  __shared__ __align__(16) int32_t sct[NCONST_COLS * FE_LIMBS];
  __shared__ __align__(16) int32_t slots[LADDER_GROUPS * FE_SLOT];
  for (int k = threadIdx.x; k < FE_LIMBS * NCONST_COLS; k += blockDim.x) {
    sct[(k % NCONST_COLS) * FE_LIMBS + k / NCONST_COLS] = consts[k];  // consts[limb][col]
  }
  __syncthreads();
  const int grp = threadIdx.x / FE_K;
  const lane_ctx c{(int)(threadIdx.x % FE_K), slots + grp * FE_SLOT};
  const int i = blockIdx.x * LADDER_GROUPS + grp;
  const bool live = i < n;  // groups past n still take part in every exchange
  const size_t item = live ? (size_t)i : 0;
  int32_t* tab = table + item * TABLE_WORDS;
  const fe d2 = const_col(c, sct, 1);

  // [1](-A), [2](-A), [3](-A), parked in E[4], E[8], E[12].
  ge a1{};
  if (live) {
    a1 = ge{fe_load(c, ax + item * FE_LIMBS), fe_load(c, ay + item * FE_LIMBS),
            fe_load(c, az + item * FE_LIMBS), fe_load(c, at + item * FE_LIMBS)};
  }
  const ge a2 = ge_dbl(c, a1);
  const ge a3 = ge_add(c, a2, a1, d2);
  if (live) {
    store_entry(c, tab, 4, a1);
    store_entry(c, tab, 8, a2);
    store_entry(c, tab, 12, a3);
  }
  // E[4h + s] = [s]B + [h](-A); s runs down so E[4h] (the source) is
  // overwritten last.
#pragma unroll 1
  for (int k = 0; k < 12; ++k) {
    const int h = 1 + k / 4;
    const int s = 3 - k % 4;
    ge ah{};
    if (live) ah = load_entry(c, tab, 4 * h);
    const ge e = ge_add(c, row0(c, sct, s), ah, d2);
    if (live) store_entry(c, tab, 4 * h + s, e);
  }
  if (live) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) store_entry(c, tab, s, row0(c, sct, s));
  }

  // acc = 4 acc + E[d_k], MSB-first; acc starts at the identity.
  const fe zero{};
  const fe one = const_col(c, sct, 2);
  ge acc{zero, one, one, zero};
  const int32_t* dig = digits + item * LADDER_STEPS;
#pragma unroll 1
  for (int k = 0; k < LADDER_STEPS; ++k) {
    const int d = live ? (dig[k] & 15) : 0;  // never index past the table
#pragma unroll 1
    for (int r = 0; r < 2; ++r) acc = ge_dbl(c, acc);
    ge e{};
    if (live) e = load_entry(c, tab, d);
    acc = ge_add(c, acc, e, d2);
  }
  if (live) {
    fe_store(c, ox + item * FE_LIMBS, acc.X);
    fe_store(c, oy + item * FE_LIMBS, acc.Y);
    fe_store(c, oz + item * FE_LIMBS, acc.Z);
    fe_store(c, ot + item * FE_LIMBS, acc.T);
  }
}

extern "C" int pbft_ladder(const void* consts, const void* digits, const void* ax,
                           const void* ay, const void* az, const void* at, void* ox, void* oy,
                           void* oz, void* ot, void* table, int n, void* stream) {
  if (n > 0) {
    ladder_kernel<<<(n + LADDER_GROUPS - 1) / LADDER_GROUPS, LADDER_THREADS, 0,
                    (cudaStream_t)stream>>>(
        (const int32_t*)consts, (const int32_t*)digits, (const int32_t*)ax, (const int32_t*)ay,
        (const int32_t*)az, (const int32_t*)at, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz,
        (int32_t*)ot, (int32_t*)table, n);
  }
  return (int)cudaGetLastError();
}
