// Batched SHA-256 for the resolve path: the component-leaf hash of many
// messages (sha256_many_kernel) and the Merkle node hash (sha256_pair_kernel),
// one thread per message or per node.
//
// Replaces two XLA graphs of corda_tpu/ops/sha256_jax.py:
//   * sha256_blocks (:90, its compression _compress at :66), driven by
//     sha256_many (:139): there the host pads each message in a Python loop
//     into (nblocks, 16, N) words and launches once per block-count bucket.
//     Here the host makes one byte buffer and N + 1 int64 offsets in a
//     single vectorized pass, and each thread pads its own message while it
//     reads it: any mix of lengths rides one launch. Out: (8, N) state words
//     (the big-endian digest words), word-major with lanes minor, so a
//     warp's stores coalesce.
//   * sha256_pair_words (:170), driven by merkle_roots_device (:209): a
//     level of m trees of `width` nodes, (8, m, width) words, reduces to
//     (8, m, ceil(width / 2)); one launch a level. The odd node is hashed
//     with itself by clamping the right child's index (the host
//     concatenate of sha256_jax.py:231-234 is gone). A node is two
//     compressions: the 64-byte data block, then the constant pad block of
//     a 64-byte message, whose whole schedule is constant: its 64 K[t] +
//     W[t] sums are KW_PAD64 below (tests/test_torch_csrc.py recomputes
//     them), so the second compression has no schedule work.
//
// What bounds it on an H100: 32-bit integer ALU work. A block is at least
// 64 rounds of 14 instructions (3 SHF rotates and a LOP3 for each Sigma,
// a LOP3 for Ch and for Maj, IADD3 pairs for t1 and one IADD3 each for the
// new a and e) and 48 schedule words of 10, plus 8 adds into the state:
// 1,384 (chip_smoke.py's SHA256_BLOCK_INT_OPS); the pad block 904. Against
// that a block moves at most 64 bytes. Design, simple first: the round
// constants in __constant__ memory, where every lane of a warp reads the
// same entry (a broadcast, folded into the IADD3's constant operand); the
// 16-word schedule window in registers (compressions fully unrolled); the
// message read a byte at a time through the read-only cache (messages lie
// at any byte offset). Threads of a warp whose messages differ in block
// count wait for the longest; the host does not sort.
//
// Compiled without nvcc (as C++), the file exports sha256_many_host and
// sha256_pair_host, which the CPU tests use to hold this exact code against
// hashlib.

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#define CONST_MEM __constant__
#define UNROLL _Pragma("unroll")
#define LOAD_BYTE(p) __ldg(p)
#else
#define HD static inline
#define CONST_MEM
#define UNROLL
#define LOAD_BYTE(p) (*(p))
#endif

static CONST_MEM const uint32_t K256[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

// K256[t] + W[t] (mod 2^32) for the pad block of a 64-byte message:
// W[0] = 0x80000000, W[1..14] = 0, W[15] = 512, W[16..63] its schedule.
static CONST_MEM const uint32_t KW_PAD64[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf374u, 0x649b69c1u, 0xf0fe4786u,
    0x0fe1edc6u, 0x240cf254u, 0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau,
    0xf2c65152u, 0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u, 0x9a1231c3u, 0xe70eeaa0u,
    0xfdb1232bu, 0xc7353eb0u, 0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu, 0xdc1eeefdu,
    0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u, 0x007f3e86u, 0x37088980u,
    0xa507ea32u, 0x6fab9537u, 0x17406110u, 0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u,
    0x83613bdau, 0xdb48a363u, 0x0b02e931u, 0x6fd15ca7u, 0x521afacau, 0x31338431u,
    0x6ed41a95u, 0x6d437890u, 0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu,
    0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u,
};

#define SHA256_H0 {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au, \
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u}

HD uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

// One round; kw = K[t] + W[t].
HD void sha256_round(uint32_t v[8], uint32_t kw) {
  const uint32_t a = v[0], b = v[1], c = v[2], e = v[4], f = v[5], g = v[6];
  const uint32_t t1 = v[7] + (rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25)) +
                      ((e & f) ^ (~e & g)) + kw;
  const uint32_t t2 = (rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22)) +
                      ((a & b) ^ (a & c) ^ (b & c));
  v[7] = g; v[6] = f; v[5] = e; v[4] = v[3] + t1;
  v[3] = c; v[2] = b; v[1] = a; v[0] = t1 + t2;
}

// st += the compression of the block W (W is the schedule window; clobbered).
HD void sha256_compress(uint32_t st[8], uint32_t W[16]) {
  uint32_t v[8];
  UNROLL for (int i = 0; i < 8; i++) v[i] = st[i];
  UNROLL for (int t = 0; t < 64; t++) {
    uint32_t w;
    if (t < 16) {
      w = W[t];
    } else {
      const uint32_t w15 = W[(t - 15) & 15], w2 = W[(t - 2) & 15];
      const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      w = W[t & 15] + s0 + W[(t - 7) & 15] + s1;
      W[t & 15] = w;
    }
    sha256_round(v, K256[t] + w);
  }
  UNROLL for (int i = 0; i < 8; i++) st[i] += v[i];
}

// st += the compression of the constant pad block of a 64-byte message.
HD void sha256_compress_pad64(uint32_t st[8]) {
  uint32_t v[8];
  UNROLL for (int i = 0; i < 8; i++) v[i] = st[i];
  UNROLL for (int t = 0; t < 64; t++) sha256_round(v, KW_PAD64[t]);
  UNROLL for (int i = 0; i < 8; i++) st[i] += v[i];
}

// Big-endian word at byte `pos` of the padded message of `len` bytes whose
// padded length is `total` (a multiple of 64): message bytes, then 0x80,
// zeros, and the bit length in the last 8 bytes.
HD uint32_t padded_word(const uint8_t* msg, int64_t len, int64_t pos,
                        int64_t total) {
  const uint64_t bits = (uint64_t)len * 8;
  if (pos == total - 8) return (uint32_t)(bits >> 32);
  if (pos == total - 4) return (uint32_t)bits;
  uint32_t w = 0;
  for (int k = 0; k < 4; k++) {
    const int64_t p = pos + k;
    const uint32_t byte = p < len ? (uint32_t)LOAD_BYTE(msg + p)
                                  : (p == len ? 0x80u : 0u);
    w = (w << 8) | byte;
  }
  return w;
}

HD void sha256_message(uint32_t st[8], const uint8_t* msg, int64_t len) {
  const uint32_t h0[8] = SHA256_H0;
  UNROLL for (int i = 0; i < 8; i++) st[i] = h0[i];
  const int64_t total = ((len + 8) / 64 + 1) * 64;
  for (int64_t base = 0; base < total; base += 64) {
    uint32_t W[16];
    UNROLL for (int k = 0; k < 16; k++)
      W[k] = padded_word(msg, len, base + 4 * k, total);
    sha256_compress(st, W);
  }
}

// Node j of tree t of a (8, m, width) level -> st: sha256(left || right),
// the right child clamped to the last node (the odd-node duplicate).
HD void sha256_pair_node(uint32_t st[8], const uint32_t* level, int m,
                         int width, int t, int j) {
  const int l = 2 * j, r = (2 * j + 1 < width) ? 2 * j + 1 : width - 1;
  uint32_t W[16];
  UNROLL for (int w = 0; w < 8; w++) {
    const size_t row = ((size_t)w * m + t) * width;
    W[w] = level[row + l];
    W[8 + w] = level[row + r];
  }
  const uint32_t h0[8] = SHA256_H0;
  UNROLL for (int i = 0; i < 8; i++) st[i] = h0[i];
  sha256_compress(st, W);
  sha256_compress_pad64(st);
}

#if defined(__CUDACC__)

#define THREADS 128

__global__ void __launch_bounds__(THREADS)
sha256_many_kernel(const uint8_t* __restrict__ data,
                   const int64_t* __restrict__ offsets,
                   uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t lo = offsets[i];
  uint32_t st[8];
  sha256_message(st, data + lo, offsets[i + 1] - lo);
  UNROLL for (int j = 0; j < 8; j++) out[(size_t)j * n + i] = st[j];
}

__global__ void __launch_bounds__(THREADS)
sha256_pair_kernel(const uint32_t* __restrict__ level,
                   uint32_t* __restrict__ out, int m, int width) {
  const int wout = (width + 1) / 2;
  const int nodes = m * wout;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nodes) return;
  uint32_t st[8];
  sha256_pair_node(st, level, m, width, i / wout, i % wout);
  UNROLL for (int j = 0; j < 8; j++) out[(size_t)j * nodes + i] = st[j];
}

// Launch on `stream`; return cudaGetLastError() (0 = launched).
extern "C" int sha256_many_launch(const void* data, const void* offsets,
                                  void* out, int n, void* stream) {
  if (n > 0) {
    sha256_many_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int64_t*)offsets, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int sha256_pair_launch(const void* level, void* out, int m,
                                  int width, void* stream) {
  const int nodes = m * ((width + 1) / 2);
  if (nodes > 0) {
    sha256_pair_kernel<<<(nodes + THREADS - 1) / THREADS, THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)level, (uint32_t*)out, m, width);
  }
  return (int)cudaGetLastError();
}

#else  // host build: the same arithmetic, for the CPU tests

extern "C" int sha256_many_host(const uint8_t* data, const int64_t* offsets,
                                uint32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    uint32_t st[8];
    sha256_message(st, data + offsets[i], offsets[i + 1] - offsets[i]);
    for (int j = 0; j < 8; j++) out[(size_t)j * n + i] = st[j];
  }
  return 0;
}

extern "C" int sha256_pair_host(const uint32_t* level, uint32_t* out, int m,
                                int width) {
  const int wout = (width + 1) / 2, nodes = m * wout;
  for (int i = 0; i < nodes; i++) {
    uint32_t st[8];
    sha256_pair_node(st, level, m, width, i / wout, i % wout);
    for (int j = 0; j < 8; j++) out[(size_t)j * nodes + i] = st[j];
  }
  return 0;
}

#endif
