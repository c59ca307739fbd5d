// The two exponent-chain kernels: z^(p-2) (field inverse, inv(0) = 0) and
// z^((p-5)/8) (the square-root-ratio power).
//
// Replaces: pbft_tpu/crypto/pallas_kernels.py _inv_kernel and _p58_kernel
// (both driven by _run_chain), i.e. field.inv / field.pow_p58.
//
// What bounds it on the H100: the IMAD pipe. A chain is 254 (inv) or 251
// (p58) squarings and 11 multiplies, at least 0.63 G int32 multiply-adds
// (IMAD pipe) and 0.44-0.45 G masks, shifts and adds (ALU pipe) at n = 4096; it
// reads and writes 128 bytes per element, which is negligible. The work is
// one long dependent chain per element, so the card is filled only if
// there are enough chains in flight and each has independent work inside it.
//
// Design: a group of FE_K = 8 lanes per element (fe25519.cuh), 4 limbs per
// lane, so n = 4096 is 1,024 warps, about 2 on each of the card's
// 528 schedulers, and each lane's 4 output columns are 4 independent
// multiply-add chains. The squaring is dedicated (528 products, not 1,024).
// The whole chain stays in registers (no global traffic between the ~260
// products, the role VMEM residency played on the TPU); the boundary is
// batch-major (n, 32), one 16-byte load per lane. The chain is
// field._inv_chain's sequence, with one template argument choosing the
// tail.
//
// Plain C interface (loaded with ctypes): pointers and the stream as void*,
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "fe25519.cuh"

#define CHAIN_THREADS 128
#define CHAIN_GROUPS (CHAIN_THREADS / FE_K)

template <bool INV>
__global__ void __launch_bounds__(CHAIN_THREADS) chain_kernel(const int32_t* __restrict__ zin,
                                                              int32_t* __restrict__ out, int n) {
  __shared__ __align__(16) int32_t slots[CHAIN_GROUPS * FE_SLOT];
  const int grp = threadIdx.x / FE_K;
  const lane_ctx c{(int)(threadIdx.x % FE_K), slots + grp * FE_SLOT};
  const int i = blockIdx.x * CHAIN_GROUPS + grp;
  const bool live = i < n;  // groups past n still take part in every exchange
  fe z{};
  if (live) z = fe_load(c, zin + (size_t)i * FE_LIMBS);
  const fe z2 = fe_sq(c, z);
  const fe z8 = fe_pow2k(c, z2, 2);
  const fe z9 = fe_mul(c, z, z8);
  const fe z11 = fe_mul(c, z2, z9);
  const fe z22 = fe_sq(c, z11);
  const fe z_5_0 = fe_mul(c, z9, z22);                               // 2^5 - 1
  const fe z_10_0 = fe_mul(c, fe_pow2k(c, z_5_0, 5), z_5_0);         // 2^10 - 1
  const fe z_20_0 = fe_mul(c, fe_pow2k(c, z_10_0, 10), z_10_0);      // 2^20 - 1
  const fe z_40_0 = fe_mul(c, fe_pow2k(c, z_20_0, 20), z_20_0);      // 2^40 - 1
  const fe z_50_0 = fe_mul(c, fe_pow2k(c, z_40_0, 10), z_10_0);      // 2^50 - 1
  const fe z_100_0 = fe_mul(c, fe_pow2k(c, z_50_0, 50), z_50_0);     // 2^100 - 1
  const fe z_200_0 = fe_mul(c, fe_pow2k(c, z_100_0, 100), z_100_0);  // 2^200 - 1
  const fe z_250_0 = fe_mul(c, fe_pow2k(c, z_200_0, 50), z_50_0);    // 2^250 - 1
  const fe r = INV ? fe_mul(c, fe_pow2k(c, z_250_0, 5), z11)   // 2^255 - 21
                   : fe_mul(c, fe_pow2k(c, z_250_0, 2), z);    // 2^252 - 3
  if (live) fe_store(c, out + (size_t)i * FE_LIMBS, r);
}

template <bool INV>
static int launch_chain(const void* z, void* out, int n, void* stream) {
  if (n > 0) {
    chain_kernel<INV><<<(n + CHAIN_GROUPS - 1) / CHAIN_GROUPS, CHAIN_THREADS, 0,
                        (cudaStream_t)stream>>>((const int32_t*)z, (int32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int pbft_inv(const void* z, void* out, int n, void* stream) {
  return launch_chain<true>(z, out, n, stream);
}

extern "C" int pbft_pow_p58(const void* z, void* out, int n, void* stream) {
  return launch_chain<false>(z, out, n, stream);
}
