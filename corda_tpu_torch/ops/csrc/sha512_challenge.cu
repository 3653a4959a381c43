// Fused Ed25519 challenge h = SHA-512(R || A || M) mod L for 32-byte
// messages, one thread per signature.
//
// Replaces corda_tpu/ops/sha512_jax.py::challenge_words, an XLA graph on
// the TPU (sha512_96_words: one padded SHA-512 block in (hi, lo) uint32
// pairs; sc_reduce_words: 43 x 12-bit limbs). Same contract: (8, N) little-
// endian 32-bit words of R, A and M in (word-major, lanes minor, so a
// warp's loads coalesce), (8, N) little-endian words of h mod L out,
// bit-identical to hashlib.sha512 + int % L. N is any size.
//
// What bounds it on an H100: 64-bit integer ALU work. 96 bytes read and 32
// written per signature against at least 3,492 32-bit integer instructions
// for the hash alone (80 rounds and the message schedule on 32-bit halves:
// SHF funnel shifts for the rotates, LOP3 for the three-input logic,
// IADD3 pairs for the multi-operand adds; counted in chip_smoke.py), plus
// the reduction. Design:
//   * native uint64 words: the 80 rounds keep the 16-word message window
//     in registers (fully unrolled), and the round constants sit in
//     __constant__ memory, where every lane of a warp reads the same entry
//     (a broadcast);
//   * the digest, read little-endian, is reduced mod L = 2^252 + delta by
//     three folds x = lo + 2^252 hi == lo + k*L - delta*hi with 64-bit limbs
//     and 128-bit products (k*L > delta*hi keeps every step non-negative),
//     then conditional subtractions of L.
//
// Compiled without nvcc (as C++), the file exports sha512_challenge_host,
// which the CPU tests use to hold this exact code against hashlib.

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#define CONST_MEM __constant__
#else
#define HD static inline
#define CONST_MEM
#endif

typedef unsigned long long u64;
typedef unsigned __int128 u128;

static CONST_MEM const u64 K512[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

// L = 2^252 + delta and the fold guards 2^133 L, 2^7 L as 64-bit limbs
// (tests/test_torch_csrc.py checks them against the oracle's L).
#define SC_DELTA0 0x5812631a5cf5d3edULL
#define SC_DELTA1 0x14def9dea2f79cd6ULL
#define SC_L {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL, 0x0ULL, \
              0x1000000000000000ULL, 0x0ULL, 0x0ULL, 0x0ULL, 0x0ULL}
#define SC_L_2P133 {0x0ULL, 0x0ULL, 0x24c634b9eba7da0ULL, 0x9bdf3bd45ef39acbULL, \
                    0x2ULL, 0x0ULL, 0x2ULL, 0x0ULL}
#define SC_L_2P7 {0x9318d2e7ae9f680ULL, 0x6f7cef517bce6b2cULL, 0xaULL, 0x0ULL, \
                  0x8ULL, 0x0ULL, 0x0ULL, 0x0ULL}

HD u64 rotr64(u64 x, int n) { return (x >> n) | (x << (64 - n)); }

HD uint32_t bswap32(uint32_t x) {
  return (x << 24) | ((x & 0xFF00u) << 8) | ((x >> 8) & 0xFF00u) | (x >> 24);
}

HD u64 bswap64(u64 x) {
  return ((u64)bswap32((uint32_t)x) << 32) | bswap32((uint32_t)(x >> 32));
}

// SHA-512 of the one padded block R || A || M || 0x80 || 0... || len=768.
HD void sha512_96(u64 H[8], const uint32_t rw[8], const uint32_t aw[8],
                  const uint32_t mw[8]) {
  u64 W[16];
  const uint32_t* src[3] = {rw, aw, mw};
#if defined(__CUDACC__)
#pragma unroll
#endif
  for (int k = 0; k < 3; k++)
    for (int i = 0; i < 4; i++)  // big-endian 64-bit reads of LE words
      W[4 * k + i] = ((u64)bswap32(src[k][2 * i]) << 32) | bswap32(src[k][2 * i + 1]);
  W[12] = 0x8000000000000000ULL;
  W[13] = 0;
  W[14] = 0;
  W[15] = 96 * 8;
  const u64 H0[8] = {
      0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
      0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
      0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
  u64 a = H0[0], b = H0[1], c = H0[2], d = H0[3];
  u64 e = H0[4], f = H0[5], g = H0[6], h = H0[7];
#if defined(__CUDACC__)
#pragma unroll
#endif
  for (int t = 0; t < 80; t++) {
    u64 w;
    if (t < 16) {
      w = W[t];
    } else {
      const u64 w15 = W[(t - 15) & 15], w2 = W[(t - 2) & 15];
      const u64 s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
      const u64 s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
      w = W[t & 15] + s0 + W[(t - 7) & 15] + s1;
      W[t & 15] = w;
    }
    const u64 S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    const u64 ch = (e & f) ^ (~e & g);
    const u64 t1 = h + S1 + ch + K512[t] + w;
    const u64 S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    const u64 maj = (a & b) ^ (a & c) ^ (b & c);
    const u64 t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  H[0] = H0[0] + a; H[1] = H0[1] + b; H[2] = H0[2] + c; H[3] = H0[3] + d;
  H[4] = H0[4] + e; H[5] = H0[5] + f; H[6] = H0[6] + g; H[7] = H0[7] + h;
}

// x (8 limbs, x < 2^512) -> lo + guard - delta * (x >> 252), non-negative
// by the caller's choice of guard (a multiple of L above delta * hi).
HD void sc_fold(u64 x[8], const u64 guard[8]) {
  u64 hi[5];
  for (int i = 0; i < 5; i++)
    hi[i] = (x[i + 3] >> 60) | (i + 4 < 8 ? (x[i + 4] << 4) : 0);
  u64 prod[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // delta * hi, 7 limbs
  for (int i = 0; i < 5; i++) {
    u128 acc = (u128)hi[i] * SC_DELTA0 + prod[i];
    prod[i] = (u64)acc;
    acc = (u128)hi[i] * SC_DELTA1 + prod[i + 1] + (u64)(acc >> 64);
    prod[i + 1] = (u64)acc;
    prod[i + 2] += (u64)(acc >> 64);
  }
  x[3] &= (1ULL << 60) - 1;  // lo = x mod 2^252
  for (int i = 4; i < 8; i++) x[i] = 0;
  u64 carry = 0, borrow = 0;
  for (int i = 0; i < 8; i++) {
    u128 s = (u128)x[i] + guard[i] + carry;
    carry = (u64)(s >> 64);
    u64 v = (u64)s;
    u64 dlt = prod[i] + borrow;
    u64 nb = (dlt < borrow) || (v < dlt);  // dlt overflow only if prod = 2^64-1
    x[i] = v - dlt;
    borrow = nb;
  }
}

// x -= L where x >= L.
HD void sc_sub_l_if_ge(u64 x[8]) {
  const u64 l[8] = SC_L;
  u64 d[8], borrow = 0;
  for (int i = 0; i < 8; i++) {
    u64 dl = l[i] + borrow;
    u64 nb = (dl < borrow) || (x[i] < dl);
    d[i] = x[i] - dl;
    borrow = nb;
  }
  if (!borrow)
    for (int i = 0; i < 8; i++) x[i] = d[i];
}

HD void challenge_one(uint32_t out[8], const uint32_t rw[8],
                      const uint32_t aw[8], const uint32_t mw[8]) {
  u64 H[8], x[8];
  sha512_96(H, rw, aw, mw);
  for (int i = 0; i < 8; i++) x[i] = bswap64(H[i]);  // digest read LE
  const u64 g1[8] = SC_L_2P133, g2[8] = SC_L_2P7, g3[8] = SC_L;
  sc_fold(x, g1);  // < 2^386
  sc_fold(x, g2);  // < 2^260
  sc_fold(x, g3);  // < 2L
  sc_sub_l_if_ge(x);
  sc_sub_l_if_ge(x);
  for (int i = 0; i < 4; i++) {
    out[2 * i] = (uint32_t)x[i];
    out[2 * i + 1] = (uint32_t)(x[i] >> 32);
  }
}

#if defined(__CUDACC__)

#define THREADS 128

__global__ void __launch_bounds__(THREADS)
sha512_challenge_kernel(const uint32_t* __restrict__ r,
                        const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ m,
                        uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t rw[8], aw[8], mw[8], hw[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    rw[j] = r[(size_t)j * n + i];
    aw[j] = a[(size_t)j * n + i];
    mw[j] = m[(size_t)j * n + i];
  }
  challenge_one(hw, rw, aw, mw);
#pragma unroll
  for (int j = 0; j < 8; j++) out[(size_t)j * n + i] = hw[j];
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int sha512_challenge_launch(const void* r, const void* a,
                                       const void* m, void* out, int n,
                                       void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    sha512_challenge_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)r, (const uint32_t*)a, (const uint32_t*)m,
        (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

#else  // host build: the same arithmetic, for the CPU tests

extern "C" int sha512_challenge_host(const uint32_t* r, const uint32_t* a,
                                     const uint32_t* m, uint32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    uint32_t rw[8], aw[8], mw[8], hw[8];
    for (int j = 0; j < 8; j++) {
      rw[j] = r[(size_t)j * n + i];
      aw[j] = a[(size_t)j * n + i];
      mw[j] = m[(size_t)j * n + i];
    }
    challenge_one(hw, rw, aw, mw);
    for (int j = 0; j < 8; j++) out[(size_t)j * n + i] = hw[j];
  }
  return 0;
}

#endif
