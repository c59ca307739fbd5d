// The two exponent-chain kernels: z^(p-2) (field inverse, inv(0) = 0) and
// z^((p-5)/8) (the square-root-ratio power).
//
// Replaces: pbft_tpu/crypto/pallas_kernels.py _inv_kernel and _p58_kernel
// (both driven by _run_chain), i.e. field.inv / field.pow_p58.
//
// What bounds it on the H100: int32 multiply-adds. A chain is 265 (inv) or
// 262 (p58) field multiplies of ~1,450 int32 operations each; it reads and
// writes 128 bytes per element, which is negligible. Design: one thread per
// field element, the whole chain in registers (no global traffic between
// the ~260 multiplies, the role VMEM residency played on the TPU), limb-major
// (32, n) input and output so each limb load/store is coalesced. The chain is
// field._inv_chain's sequence of squarings and multiplies, with one template
// argument choosing the tail. At the service's window (n = 4096) the grid is
// 32 blocks of 128 threads on 132 SMs: under-occupied, left for a later PR.
//
// Plain C interface (loaded with ctypes): pointers and the stream as void*,
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "fe25519.cuh"

template <bool INV>
__global__ void __launch_bounds__(128) chain_kernel(const int32_t* __restrict__ zin,
                                                    int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const fe z = fe_load(zin, n, i);
  const fe z2 = fe_sq(z);
  const fe z8 = fe_pow2k(z2, 2);
  const fe z9 = fe_mul(z, z8);
  const fe z11 = fe_mul(z2, z9);
  const fe z22 = fe_sq(z11);
  const fe z_5_0 = fe_mul(z9, z22);                            // 2^5 - 1
  const fe z_10_0 = fe_mul(fe_pow2k(z_5_0, 5), z_5_0);         // 2^10 - 1
  const fe z_20_0 = fe_mul(fe_pow2k(z_10_0, 10), z_10_0);      // 2^20 - 1
  const fe z_40_0 = fe_mul(fe_pow2k(z_20_0, 20), z_20_0);      // 2^40 - 1
  const fe z_50_0 = fe_mul(fe_pow2k(z_40_0, 10), z_10_0);      // 2^50 - 1
  const fe z_100_0 = fe_mul(fe_pow2k(z_50_0, 50), z_50_0);     // 2^100 - 1
  const fe z_200_0 = fe_mul(fe_pow2k(z_100_0, 100), z_100_0);  // 2^200 - 1
  const fe z_250_0 = fe_mul(fe_pow2k(z_200_0, 50), z_50_0);    // 2^250 - 1
  const fe r = INV ? fe_mul(fe_pow2k(z_250_0, 5), z11)   // 2^255 - 21
                   : fe_mul(fe_pow2k(z_250_0, 2), z);    // 2^252 - 3
  fe_store(out, n, i, r);
}

template <bool INV>
static int launch_chain(const void* z, void* out, int n, void* stream) {
  if (n > 0) {
    const int threads = 128;
    chain_kernel<INV><<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)z, (int32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int pbft_inv(const void* z, void* out, int n, void* stream) {
  return launch_chain<true>(z, out, n, stream);
}

extern "C" int pbft_pow_p58(const void* z, void* out, int n, void* stream) {
  return launch_chain<false>(z, out, n, stream);
}
