// The Shamir double-scalar ladder: [S]B + [h](-A) for one signature per
// thread.
//
// Replaces: pbft_tpu/crypto/pallas_kernels.py _ladder_kernel (wrapper
// `ladder`), i.e. ed25519.shamir_ladder.
//
// What bounds it on the H100: int32 multiply-adds. One signature costs
// 3,325 field multiplies (125 to build the table, then 128 steps of 2
// doublings + 1 addition) of ~1,450 int32 operations each; the inputs and
// outputs are ~1.2 KB per signature, which is negligible. Design:
// - one thread per signature, the accumulator point and the field
//   temporaries in registers (spills go to local memory, which L1 caches);
// - the 16-entry table E[s + 4h] = [s]B + [h](-A) (8 KB per signature, far
//   more than a thread's registers) in a global scratch buffer the wrapper
//   allocates, laid out (16, 4, 32, n) so a warp's accesses to one limb are
//   contiguous words; at n = 4096 it is 32 MiB and stays in the 50 MB L2;
// - verification handles public data only, so the step reads the table row
//   named by its digit directly instead of the TPU kernel's 4-level select
//   mux; the digits (MSB-first, d = s0 + 2 s1 + 4 h0 + 8 h1) come
//   precomputed from the wrapper as a (128, n) array;
// - the static constants (2d and the [s]B row) arrive as the same (32, 32)
//   limb-major block the TPU kernel took, staged once per block in shared
//   memory (not __constant__: the row index differs across a warp, and
//   constant-cache reads with divergent addresses serialize).
// The table entries are computed exactly as ed25519.shamir_ladder computes
// them (point_add([s]B, [h](-A)) for all 12 data-dependent entries), so the
// output limbs equal the plain version's, not only its compressed point.
//
// Plain C interface (loaded with ctypes): pointers and the stream as void*,
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "fe25519.cuh"

#define NCONST_COLS 32

__device__ __forceinline__ fe const_col(const int32_t* sc, int col) {
  fe r;
#pragma unroll
  for (int l = 0; l < FE_LIMBS; ++l) r.v[l] = sc[l * NCONST_COLS + col];
  return r;
}

// Table scratch: entry e, coordinate c, limb l, item i.
__device__ __forceinline__ int32_t* entry_ptr(int32_t* table, int e, int c, int n) {
  return table + (size_t)(e * 4 + c) * FE_LIMBS * n;
}

__device__ __forceinline__ ge load_entry(int32_t* table, int e, int n, int i) {
  return ge{fe_load(entry_ptr(table, e, 0, n), n, i), fe_load(entry_ptr(table, e, 1, n), n, i),
            fe_load(entry_ptr(table, e, 2, n), n, i), fe_load(entry_ptr(table, e, 3, n), n, i)};
}

__device__ __forceinline__ void store_entry(int32_t* table, int e, int n, int i, const ge& p) {
  fe_store(entry_ptr(table, e, 0, n), n, i, p.X);
  fe_store(entry_ptr(table, e, 1, n), n, i, p.Y);
  fe_store(entry_ptr(table, e, 2, n), n, i, p.Z);
  fe_store(entry_ptr(table, e, 3, n), n, i, p.T);
}

__device__ __forceinline__ ge row0(const int32_t* sc, int s) {
  return ge{const_col(sc, 3 + 4 * s + 0), const_col(sc, 3 + 4 * s + 1),
            const_col(sc, 3 + 4 * s + 2), const_col(sc, 3 + 4 * s + 3)};
}

__global__ void __launch_bounds__(128) ladder_kernel(
    const int32_t* __restrict__ consts, const int32_t* __restrict__ digits,
    const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
    const int32_t* __restrict__ az, const int32_t* __restrict__ at,
    int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
    int32_t* __restrict__ ot, int32_t* __restrict__ table, int n) {
  __shared__ int32_t sc[FE_LIMBS * NCONST_COLS];
  for (int k = threadIdx.x; k < FE_LIMBS * NCONST_COLS; k += blockDim.x) sc[k] = consts[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const fe d2 = const_col(sc, 1);

  // [1](-A), [2](-A), [3](-A), parked in E[4], E[8], E[12].
  const ge a1{fe_load(ax, n, i), fe_load(ay, n, i), fe_load(az, n, i), fe_load(at, n, i)};
  const ge a2 = ge_dbl(a1);
  store_entry(table, 4, n, i, a1);
  store_entry(table, 8, n, i, a2);
  store_entry(table, 12, n, i, ge_add(a2, a1, d2));
  // E[4h + s] = [s]B + [h](-A); s runs down so E[4h] (the source) is
  // overwritten last.
#pragma unroll 1
  for (int j = 0; j < 12; ++j) {
    const int h = 1 + j / 4;
    const int s = 3 - j % 4;
    const ge ah = load_entry(table, 4 * h, n, i);
    store_entry(table, 4 * h + s, n, i, ge_add(row0(sc, s), ah, d2));
  }
#pragma unroll 1
  for (int s = 0; s < 4; ++s) store_entry(table, s, n, i, row0(sc, s));

  // acc = 4 acc + E[d_k], MSB-first; acc starts at the identity.
  const fe zero = fe{};
  const fe one = const_col(sc, 2);
  ge acc{zero, one, one, zero};
#pragma unroll 1
  for (int k = 0; k < 128; ++k) {
    const int d = digits[(size_t)k * n + i] & 15;  // never index past the table
#pragma unroll 1
    for (int r = 0; r < 2; ++r) acc = ge_dbl(acc);
    acc = ge_add(acc, load_entry(table, d, n, i), d2);
  }
  fe_store(ox, n, i, acc.X);
  fe_store(oy, n, i, acc.Y);
  fe_store(oz, n, i, acc.Z);
  fe_store(ot, n, i, acc.T);
}

extern "C" int pbft_ladder(const void* consts, const void* digits, const void* ax,
                           const void* ay, const void* az, const void* at, void* ox, void* oy,
                           void* oz, void* ot, void* table, int n, void* stream) {
  if (n > 0) {
    const int threads = 128;
    ladder_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)consts, (const int32_t*)digits, (const int32_t*)ax, (const int32_t*)ay,
        (const int32_t*)az, (const int32_t*)at, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz,
        (int32_t*)ot, (int32_t*)table, n);
  }
  return (int)cudaGetLastError();
}
