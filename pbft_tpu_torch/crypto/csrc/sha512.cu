// SHA-512 (FIPS 180-4) of fixed-length byte rows, one thread per row: the
// verify window's challenge hash h = SHA-512(R || A || M), 96 bytes a row,
// one 128-byte block after padding.
//
// Replaces: no TPU kernel. The JAX package hashes with plain jnp ops
// (pbft_tpu/crypto/sha512.py, uint32 halves). Its plain PyTorch port
// (crypto/sha512.py, the CPU path and this kernel's yardstick) holds each
// 64-bit word as two int64 tensors masked to 32 bits, so one round is ~180
// elementwise kernels and one hash ~14.5k: in a replayed window that was
// ~62% of the device time, at ~1.2 us a node whatever the row count.
//
// What bounds it on the H100: latency. A row is one dependent chain of 80
// rounds (a few 64-bit adds, rotations and logic ops each) and 64 schedule
// words: ~4,000 ALU operations a row (chip_smoke.py counts them), so 4,096
// rows need ~1 us of the ALU pipe and ~0.7 MB of traffic (~0.2 us), while
// one row's chain is ~80 rounds of ~8 dependent instructions. At 16-8,192
// rows every row's chain runs at once (at most 64 blocks on 132 SMs), so
// the kernel costs about one chain and its launch.
//
// Design: one thread per row, 128 threads a block and ceil(rows / 128)
// blocks at every shape. The 8-word state and a 16-word rolling message
// schedule stay in registers as native 64-bit words: the rounds and the
// schedule are fully unrolled, so every index is static; a rotation is two
// 32-bit funnel shifts; the round constants sit in constant memory. No
// shared memory. Padding, the big-endian word packing and the digest's byte
// order are done here: the kernel reads a row's n bytes and writes its 64
// digest bytes. Any n works, (n + 17 + 127) / 128 blocks of 128 bytes.
//
// Plain C interface (loaded with ctypes): pointers and the stream as void*,
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define SHA512_THREADS 128

__constant__ uint64_t SHA512_K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL, 0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL, 0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL, 0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL, 0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL, 0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL, 0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL, 0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
    0xca273eceea26619cULL, 0xd186b8c721c0c207ULL, 0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, 0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

__constant__ uint64_t SHA512_H0[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL, 0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

// x rotated right by N (0 < N < 64): two 32-bit funnel shifts.
template <int N>
__device__ __forceinline__ uint64_t rotr(uint64_t x) {
  uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  if (N >= 32) {
    const uint32_t t = lo;
    lo = hi;
    hi = t;
  }
  const uint32_t rlo = __funnelshift_r(lo, hi, N & 31);
  const uint32_t rhi = __funnelshift_r(hi, lo, N & 31);
  return ((uint64_t)rhi << 32) | rlo;
}

__device__ __forceinline__ uint64_t big_sigma0(uint64_t x) { return rotr<28>(x) ^ rotr<34>(x) ^ rotr<39>(x); }
__device__ __forceinline__ uint64_t big_sigma1(uint64_t x) { return rotr<14>(x) ^ rotr<18>(x) ^ rotr<41>(x); }
__device__ __forceinline__ uint64_t small_sigma0(uint64_t x) { return rotr<1>(x) ^ rotr<8>(x) ^ (x >> 7); }
__device__ __forceinline__ uint64_t small_sigma1(uint64_t x) { return rotr<19>(x) ^ rotr<61>(x) ^ (x >> 6); }

// The big-endian word at byte offset pos of a row's padded message, which
// is `total` bytes long: the row's n bytes, 0x80, zeros, then the 128-bit
// bit length, whose top 64 bits are 0 for any int n.
__device__ __forceinline__ uint64_t padded_word(const uint8_t* __restrict__ row, int n, int pos, int total) {
  if (pos == total - 8) return (uint64_t)n * 8;
  uint64_t w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int p = pos + k;
    const uint32_t b = p < n ? row[p] : (p == n ? 0x80u : 0u);
    w = (w << 8) | b;
  }
  return w;
}

// The 8 bytes of x in big-endian order, as a word stored little-endian.
__device__ __forceinline__ uint64_t byteswap(uint64_t x) {
  const uint32_t lo = __byte_perm((uint32_t)x, 0, 0x0123);
  const uint32_t hi = __byte_perm((uint32_t)(x >> 32), 0, 0x0123);
  return ((uint64_t)lo << 32) | hi;
}

__global__ void __launch_bounds__(SHA512_THREADS)
    sha512_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int rows, int n) {
  const int i = blockIdx.x * SHA512_THREADS + threadIdx.x;
  if (i >= rows) return;
  const uint8_t* row = in + (size_t)i * n;
  const int nblocks = (n + 17 + 127) / 128;
  const int total = nblocks * 128;
  uint64_t st[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = SHA512_H0[k];
  for (int blk = 0; blk < nblocks; ++blk) {
    uint64_t w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) w[t] = padded_word(row, n, blk * 128 + t * 8, total);
    uint64_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int t = 0; t < 80; ++t) {
      if (t >= 16) {  // w[t & 15] holds W[t - 16] until it becomes W[t]
        w[t & 15] += small_sigma1(w[(t - 2) & 15]) + w[(t - 7) & 15] + small_sigma0(w[(t - 15) & 15]);
      }
      const uint64_t t1 = h + big_sigma1(e) + ((e & f) ^ (~e & g)) + SHA512_K[t] + w[t & 15];
      const uint64_t t2 = big_sigma0(a) + ((a & b) ^ (a & c) ^ (b & c));
      h = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = b;
      b = a;
      a = t1 + t2;
    }
    st[0] += a;
    st[1] += b;
    st[2] += c;
    st[3] += d;
    st[4] += e;
    st[5] += f;
    st[6] += g;
    st[7] += h;
  }
  uint64_t* dst = reinterpret_cast<uint64_t*>(out + (size_t)i * 64);  // 8-byte aligned: the wrapper allocates it
#pragma unroll
  for (int k = 0; k < 8; ++k) dst[k] = byteswap(st[k]);
}

extern "C" int pbft_sha512_rows(const void* in, void* out, int rows, int n, void* stream) {
  if (rows > 0) {
    sha512_kernel<<<(rows + SHA512_THREADS - 1) / SHA512_THREADS, SHA512_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, (uint8_t*)out, rows, n);
  }
  return (int)cudaGetLastError();
}
