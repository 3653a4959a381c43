// Batched SHA-256 for the resolve path: the component-leaf hash of many
// messages (sha256_many_kernel) and the reduction of many Merkle trees
// (sha256_pair_kernel).
//
// Replaces two XLA graphs of corda_tpu/ops/sha256_jax.py:
//   * sha256_blocks (:90, its compression _compress at :66), driven by
//     sha256_many (:139): there the host pads each message in a Python loop
//     into (nblocks, 16, N) words and launches once per block-count bucket.
//     Here the host makes one byte buffer and N + 1 int64 offsets in a
//     single vectorized pass, and the kernel pads each message itself: any
//     mix of lengths rides one launch. Out: (8, N) state words (the
//     big-endian digest words), word-major with lanes minor.
//   * sha256_pair_words (:170), driven by merkle_roots_device (:209), which
//     reduces m trees one level a launch. Here one launch reduces every
//     aligned chunk of 2^depth leaves of each tree to one node, level by
//     level in shared memory: (8, m, width) words -> (8, m, ceil(width /
//     2^depth)). The odd node is hashed with itself by clamping the right
//     child's index to the level's last node (the host concatenate of
//     sha256_jax.py:231-234 is gone). A node is two compressions: the
//     64-byte data block, then the constant pad block of a 64-byte message,
//     whose 64 K[t] + W[t] sums are KW_PAD64 below (tests/test_torch_csrc.py
//     recomputes them), so the second compression has no schedule work.
//
// What bounds both on an H100: 32-bit integer ALU work. A block is at least
// 64 rounds of 14 instructions (3 SHF rotates and a LOP3 for each Sigma, a
// LOP3 for Ch and for Maj, IADD3 pairs for t1 and one IADD3 each for the new
// a and e) and 48 schedule words of 10, plus 8 adds into the state: 1,384
// (chip_smoke.py's SHA256_BLOCK_INT_OPS); the pad block 904. Against that a
// block moves at most 64 bytes. So the design keeps every instruction that
// is not a round or a schedule word out of the block loop:
//   * sha256_many: a CTA owns MANY_THREADS consecutive messages, one thread
//     each; their bytes are one run of the buffer. At step k the whole CTA
//     copies block k of each of its messages into a ring of shared memory
//     with 16-byte cp.async: the block of a message at byte address a lies
//     inside the five aligned chunks from (a + 64k) & ~15, and consecutive
//     threads copy consecutive chunks of one message, so a warp's copy
//     touches a few sectors, not 32. The ring has MANY_STAGES stages: block
//     k + 2 is in flight while block k is compressed. The owning thread then
//     makes each big-endian word of its window with one PRMT
//     (window_words); only the last one or two blocks of a message pay for
//     the 0x80 byte and the bit length (tail_word). Offsets inside the CTA
//     are 32-bit, relative to its aligned base, computed once. Windows are
//     aligned on absolute addresses: an aligned chunk never starts before
//     the 16-byte-aligned storage that holds the buffer, and a chunk that
//     runs past the buffer's end is cut there (cp.async zero-fills the
//     rest). Lanes whose message has ended skip the compression; the CTA
//     steps to its longest message, so any length fits in bounded shared
//     memory.
//   * sha256_pair_kernel: a CTA takes consecutive chunks (several trees;
//     about one CTA an SM), loads their leaves with coalesced reads (for
//     each word row, a run of trees is contiguous) and reduces them level by
//     level in shared memory, one thread a node. A level's nodes are
//     numbered densely onto consecutive threads, so the upper levels keep
//     whole warps, and with one CTA an SM those warps spread over its four
//     schedulers (several CTAs an SM would each stack their few upper-level
//     warps on the same schedulers). Only the last level's nodes go back to
//     device memory.
// The round constants stay in __constant__ memory, indexed at compile time
// in the unrolled rounds (a broadcast folded into the IADD3's constant).
//
// Compiled without nvcc (as C++), the file exports sha256_many_host and
// merkle_reduce_host, which run the kernels' schedules (the copies, the
// windows, the masks, the dense node numbering and the clamps) CTA by CTA;
// the CPU tests hold them against hashlib. Only cp.async, the barriers and
// the shared-memory declarations are device-only.

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#define HOST_HD __host__ __device__ __forceinline__
#define CONST_MEM __constant__
#define UNROLL _Pragma("unroll")
#else
#include <stdlib.h>
#include <string.h>
#define HD static inline
#define HOST_HD static inline
#define CONST_MEM
#define UNROLL
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

// ---------------------------------------------------------------------------
// sha256_many: the staged-window schedule.

#define MANY_THREADS 64   // messages (and threads) a CTA
#define MANY_STAGES 3     // ring stages: copies run two blocks ahead
#define WINDOW_CHUNKS 5   // aligned 16-byte chunks that hold any 64 bytes
#define WINDOW_WORDS (4 * WINDOW_CHUNKS)
#define STAGE_BYTES (MANY_THREADS * WINDOW_WORDS * 4)

// Blocks of the padded message of `len` bytes (len < 2^31).
HD uint32_t nblocks_of(uint32_t len) { return (len + 8) / 64 + 1; }

// One of a thread's WINDOW_CHUNKS copies a step: the chunk's byte offset
// from the CTA's aligned base at block 0, and its message's block count
// (0 past the last message). Copy e of a CTA is chunk e % 5 of its message
// e / 5, and lands at byte 16 e of the stage: a message's five chunks are
// adjacent in the buffer and in the ring.
struct ManyCopy {
  uint32_t rel;
  uint32_t nb;
};

// The CTA's aligned base: its first message's address rounded down to 16.
HD uint64_t many_cta_base(uint64_t base, const int64_t* offsets, int first) {
  return (base + (uint64_t)offsets[first]) & ~(uint64_t)15;
}

HD ManyCopy many_copy(const int64_t* offsets, int n, int first, uint64_t base,
                      uint64_t cta_base, int e) {
  const int msg = e / WINDOW_CHUNKS, chunk = e - msg * WINDOW_CHUNKS;
  const int i = first + msg;
  ManyCopy cp = {0u, 0u};
  if (i < n) {
    const int64_t lo = offsets[i];
    cp.nb = nblocks_of((uint32_t)(offsets[i + 1] - lo));
    cp.rel = (uint32_t)(((base + (uint64_t)lo) & ~(uint64_t)15) - cta_base) +
             16u * (uint32_t)chunk;
  }
  return cp;
}

// Bytes of the copy's chunk at step k that lie in the buffer (which ends
// end_rel bytes past the CTA's base): 16, fewer at the buffer's end, 0 when
// there is nothing to copy (the message has fewer blocks, or the chunk lies
// past the end).
HD uint32_t many_copy_bytes(ManyCopy cp, uint32_t k, uint32_t end_rel) {
  if (k >= cp.nb) return 0u;
  const uint32_t r = cp.rel + 64u * k;
  if (r >= end_rel) return 0u;
  return end_rel - r >= 16u ? 16u : end_rel - r;
}

// PRMT selector of the big-endian word of bytes r .. r + 3 of {hi:lo}.
HD uint32_t be_selector(uint32_t r) {
  return (r << 12) | ((r + 1) << 8) | ((r + 2) << 4) | (r + 3);
}

HD uint32_t byte_perm(uint32_t lo, uint32_t hi, uint32_t sel) {
#if defined(__CUDACC__)
  return __byte_perm(lo, hi, sel);
#else
  const uint64_t x = ((uint64_t)hi << 32) | lo;
  uint32_t out = 0;
  for (int b = 0; b < 4; b++)
    out |= (uint32_t)((x >> (8 * ((sel >> (4 * b)) & 7))) & 0xff) << (8 * b);
  return out;
#endif
}

// The 16 big-endian words of the 64 bytes at byte s (0..15) of a staged
// window of WINDOW_WORDS little-endian words: word j is bytes s + 4j ..
// s + 4j + 3, one PRMT of window words q + j and q + j + 1 (q = s / 4).
HD void window_words(const uint32_t* row, uint32_t s, uint32_t W[16]) {
  const uint32_t q = s >> 2, sel = be_selector(s & 3);
  UNROLL for (int j = 0; j < 16; j++)
    W[j] = byte_perm(row[q + j], row[q + j + 1], sel);
}

// A word of the padded message from the raw word read at its place, where
// rel = len - (the word's byte position): message bytes, then 0x80, then
// zeros.
HD uint32_t tail_word(uint32_t raw, int32_t rel) {
  if (rel >= 4) return raw;
  if (rel < 0) return 0u;
  return (raw & ~(0xffffffffu >> (8 * rel))) | (0x80000000u >> (8 * rel));
}

// The 16 words of block k (of nb) of the padded message of `len` bytes,
// from its staged window at byte s. A block wholly inside the message takes
// the words as they are; only the last one or two are masked, and the last
// one carries the bit length in words 14 and 15.
HD void block_words(const uint32_t* row, uint32_t s, uint32_t len, uint32_t k,
                    uint32_t nb, uint32_t W[16]) {
  window_words(row, s, W);
  if (64u * (k + 1) > len) {
    UNROLL for (int j = 0; j < 16; j++)
      W[j] = tail_word(W[j], (int32_t)(len - (64u * k + 4u * j)));
    if (k + 1 == nb) {
      W[14] = len >> 29;
      W[15] = len << 3;
    }
  }
}

// ---------------------------------------------------------------------------
// sha256_pair: chunk-local reduction of Merkle trees.

#define MERKLE_MAX_DEPTH 5        // a launch reduces at most 32 leaves to one
#define MERKLE_MAX_THREADS 1024
#define MERKLE_SMEM_MAX 49152     // bytes of shared memory a CTA may take
#define MERKLE_LOADS 8            // leaf loads a thread keeps in flight

// The launch geometry is also computed on the host (HOST_HD).
// Width of level l of a tree of `width` leaves: ceil(width / 2^l).
HOST_HD int level_width(int width, int l) { return (width + (1 << l) - 1) >> l; }

// Slots a chunk takes in the leaf buffer and in a node buffer: at most
// 2^depth leaves and 2^(depth - 1) level-1 nodes, fewer in a narrower tree.
HOST_HD int leaf_stride(int width, int depth) {
  return width < (1 << depth) ? width : 1 << depth;
}
HOST_HD int node_stride(int width, int depth) {
  const int w1 = level_width(width, 1);
  return w1 < (1 << (depth - 1)) ? w1 : 1 << (depth - 1);
}

// Chunks a CTA takes. A level's nodes go to consecutive threads, so its
// warps are consecutive and spread over the SM's four schedulers only
// within one CTA: the chunks are shared out so that each SM holds about one
// CTA, within MERKLE_MAX_THREADS level-1 nodes and MERKLE_SMEM_MAX bytes.
HOST_HD int merkle_chunks_per_cta(int m, int width, int depth, int sms) {
  const int total = m * level_width(width, depth);
  const int ls = leaf_stride(width, depth), ns = node_stride(width, depth);
  int g = (total + sms - 1) / sms;
  if (g > MERKLE_MAX_THREADS / ns) g = MERKLE_MAX_THREADS / ns;
  if (g > MERKLE_SMEM_MAX / (32 * (ls + 2 * ns)))
    g = MERKLE_SMEM_MAX / (32 * (ls + 2 * ns));
  return g < 1 ? 1 : g;
}

// Threads of a CTA: the most level-1 nodes it holds, in whole warps.
HOST_HD int merkle_threads(int width, int depth, int chunks) {
  return (chunks * node_stride(width, depth) + 31) / 32 * 32;
}

// Shared memory of a CTA: the leaves, [8][chunks * leaf_stride] words, and
// two node buffers of [8][chunks * node_stride] words each.
HOST_HD int merkle_smem_bytes(int width, int depth, int chunks) {
  return 32 * chunks * (leaf_stride(width, depth) + 2 * node_stride(width, depth));
}

// The first node of chunk g at level l in the dense numbering of the
// level's nodes (tree-major: tree t's node j is t * w_l + j); chunk c of a
// tree covers its nodes [c << (depth - l), (c + 1) << (depth - l)) of level
// l, cut at w_l. g may be the chunk count: the level's node count.
HD int level_start(int g, int nchunks, int width, int depth, int l) {
  const int t = g / nchunks, c = g - t * nchunks;
  return t * level_width(width, l) + (c << (depth - l));
}

// Leaf word x of a CTA's run (x < 8 * nleaves): its index in the level
// and its slot in the leaf buffer. Row w of the level holds every tree's
// nodes in order, so the CTA's leaves are one run of each row.
HD void leaf_word(int x, int nleaves, int leaf_cap, int m, int width, int l0,
                  size_t* src, int* dst) {
  const int w = x / nleaves, j = x - w * nleaves;
  *src = (size_t)w * m * width + l0 + j;
  *dst = w * leaf_cap + j;
}

// Node f (dense numbering, level l >= 1) of the CTA whose first chunk is g0
// and whose leaves start at dense leaf l0: its slot in the level's node
// buffer, and its children's slots in the level below's buffer (the leaf
// buffer when l == 1). The right child is clamped to the level's last node
// (crypto/merkle.py's duplicate of the odd node); both children lie in the
// node's own chunk.
HD void merkle_node(int f, int l, int width, int depth, int nchunks, int g0,
                    int l0, int* slot, int* left, int* right) {
  const int wl = level_width(width, l), wp = level_width(width, l - 1);
  const int t = f / wl, j = f - t * wl;
  const int c = j >> (depth - l), g = t * nchunks + c - g0;
  const int ns = node_stride(width, depth);
  const int jl = 2 * j, jr = 2 * j + 1 < wp ? 2 * j + 1 : wp - 1;
  *slot = g * ns + j - (c << (depth - l));
  if (l == 1) {
    *left = t * width + jl - l0;
    *right = t * width + jr - l0;
  } else {
    const int base = g * ns - (c << (depth - l + 1));
    *left = base + jl;
    *right = base + jr;
  }
}

// sha256(left || right) of two 8-word nodes at slots of a [8][cap] buffer.
HD void merkle_pair(uint32_t st[8], const uint32_t* buf, int cap, int left,
                    int right) {
  uint32_t W[16];
  UNROLL for (int w = 0; w < 8; w++) {
    W[w] = buf[w * cap + left];
    W[8 + w] = buf[w * cap + right];
  }
  const uint32_t h0[8] = SHA256_H0;
  UNROLL for (int i = 0; i < 8; i++) st[i] = h0[i];
  sha256_compress(st, W);
  sha256_compress_pad64(st);
}

#if defined(__CUDACC__)

HD void cp_async16(uint32_t dst, uint64_t src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

HD void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
HD void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(MANY_THREADS)
sha256_many_kernel(const uint8_t* __restrict__ data,
                   const int64_t* __restrict__ offsets,
                   uint32_t* __restrict__ out, int n, int64_t data_len) {
  __shared__ __align__(16) uint32_t ring[MANY_STAGES][MANY_THREADS][WINDOW_WORDS];
  const int tid = threadIdx.x, first = blockIdx.x * MANY_THREADS;
  const int i = first + tid;
  const uint64_t base = (uint64_t)data;
  const uint64_t cta_base = many_cta_base(base, offsets, first);
  const uint32_t end_rel = (uint32_t)(base + (uint64_t)data_len - cta_base);

  uint32_t len = 0, nb = 0, s = 0;
  if (i < n) {
    const int64_t lo = offsets[i];
    len = (uint32_t)(offsets[i + 1] - lo);
    nb = nblocks_of(len);
    s = (uint32_t)((base + (uint64_t)lo) & 15);
  }
  ManyCopy cps[WINDOW_CHUNKS];
  UNROLL for (int u = 0; u < WINDOW_CHUNKS; u++)
    cps[u] = many_copy(offsets, n, first, base, cta_base, tid + u * MANY_THREADS);

  const uint32_t ring_addr = (uint32_t)__cvta_generic_to_shared(&ring[0][0][0]);
  auto issue = [&](uint32_t k) {
    const uint32_t stage = ring_addr + (k % MANY_STAGES) * STAGE_BYTES;
    UNROLL for (int u = 0; u < WINDOW_CHUNKS; u++) {
      const uint32_t bytes = many_copy_bytes(cps[u], k, end_rel);
      if (bytes)
        cp_async16(stage + 16u * (tid + u * MANY_THREADS),
                   cta_base + cps[u].rel + 64u * k, bytes);
    }
    cp_async_commit();
  };

  UNROLL for (int k = 0; k < MANY_STAGES - 1; k++) issue(k);
  uint32_t st[8] = SHA256_H0;
  for (uint32_t k = 0;; k++) {
    cp_async_wait<MANY_STAGES - 2>();          // block k has landed ...
    if (!__syncthreads_or(k < nb)) break;     // ... for every thread
    issue(k + MANY_STAGES - 1);               // into the stage read at k - 1
    if (k < nb) {
      uint32_t W[16];
      block_words(ring[k % MANY_STAGES][tid], s, len, k, nb, W);
      sha256_compress(st, W);
    }
  }
  cp_async_wait<0>();
  if (i < n) {
    UNROLL for (int j = 0; j < 8; j++) out[(size_t)j * n + i] = st[j];
  }
}

__global__ void __launch_bounds__(MERKLE_MAX_THREADS)
sha256_pair_kernel(const uint32_t* __restrict__ level,
                   uint32_t* __restrict__ out, int m, int width, int depth,
                   int chunks) {
  extern __shared__ uint32_t smem[];
  const int nchunks = level_width(width, depth), total = m * nchunks;
  const int g0 = blockIdx.x * chunks;
  const int g1 = g0 + chunks < total ? g0 + chunks : total;
  const int leaf_cap = chunks * leaf_stride(width, depth);
  const int node_cap = chunks * node_stride(width, depth);

  // The leaves, MERKLE_LOADS words a thread in flight at a time (a store
  // waits on its load; a loop of one load a turn would wait on device
  // memory once a word).
  const int l0 = level_start(g0, nchunks, width, depth, 0);
  const int nleaves = level_start(g1, nchunks, width, depth, 0) - l0;
  const int stride = blockDim.x;
  for (int x0 = threadIdx.x; x0 < 8 * nleaves; x0 += MERKLE_LOADS * stride) {
    uint32_t v[MERKLE_LOADS];
    int dst[MERKLE_LOADS];
    UNROLL for (int u = 0; u < MERKLE_LOADS; u++) {
      if (x0 + u * stride < 8 * nleaves) {
        size_t src;
        leaf_word(x0 + u * stride, nleaves, leaf_cap, m, width, l0, &src,
                  &dst[u]);
        v[u] = level[src];
      }
    }
    UNROLL for (int u = 0; u < MERKLE_LOADS; u++)
      if (x0 + u * stride < 8 * nleaves) smem[dst[u]] = v[u];
  }
  __syncthreads();
  for (int l = 1; l <= depth; l++) {
    // Level l reads the leaves (l == 1) or node buffer (l - 1) & 1 and
    // writes node buffer l & 1.
    const int f0 = level_start(g0, nchunks, width, depth, l);
    const int count = level_start(g1, nchunks, width, depth, l) - f0;
    const uint32_t* src =
        l == 1 ? smem : smem + 8 * (leaf_cap + ((l - 1) & 1) * node_cap);
    uint32_t* dst = smem + 8 * (leaf_cap + (l & 1) * node_cap);
    const int src_cap = l == 1 ? leaf_cap : node_cap;
    for (int x = threadIdx.x; x < count; x += blockDim.x) {
      int slot, left, right;
      merkle_node(f0 + x, l, width, depth, nchunks, g0, l0, &slot, &left,
                  &right);
      uint32_t st[8];
      merkle_pair(st, src, src_cap, left, right);
      if (l == depth) {  // node f of the last level is output node f
        UNROLL for (int w = 0; w < 8; w++) out[(size_t)w * total + f0 + x] = st[w];
      } else {
        UNROLL for (int w = 0; w < 8; w++) dst[w * node_cap + slot] = st[w];
      }
    }
    __syncthreads();
  }
}

// Launch on `stream`; return cudaGetLastError() (0 = launched).
extern "C" int sha256_many_launch(const void* data, const void* offsets,
                                  void* out, int n, int64_t data_len,
                                  void* stream) {
  if (n > 0) {
    sha256_many_kernel<<<(n + MANY_THREADS - 1) / MANY_THREADS, MANY_THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int64_t*)offsets, (uint32_t*)out, n,
        data_len);
  }
  return (int)cudaGetLastError();
}

// `sms`: the card's SM count, over which the CTAs are shared out.
extern "C" int merkle_reduce_launch(const void* level, void* out, int m,
                                    int width, int depth, int sms,
                                    void* stream) {
  const int total = m * level_width(width, depth);
  if (total > 0) {
    const int chunks = merkle_chunks_per_cta(m, width, depth, sms);
    sha256_pair_kernel<<<(total + chunks - 1) / chunks,
                         merkle_threads(width, depth, chunks),
                         merkle_smem_bytes(width, depth, chunks),
                         (cudaStream_t)stream>>>(
        (const uint32_t*)level, (uint32_t*)out, m, width, depth, chunks);
  }
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and threads per CTA of each kernel (for a reduce of
// `width`-leaf trees at `depth`, also the chunks a CTA takes).
extern "C" int sha256_many_occupancy(int* blocks, int* threads) {
  *threads = MANY_THREADS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sha256_many_kernel, MANY_THREADS, 0);
}

extern "C" int merkle_reduce_occupancy(int m, int width, int depth, int sms,
                                       int* blocks, int* threads, int* chunks) {
  *chunks = merkle_chunks_per_cta(m, width, depth, sms);
  *threads = merkle_threads(width, depth, *chunks);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sha256_pair_kernel, *threads,
      merkle_smem_bytes(width, depth, *chunks));
}

#else  // host build: the kernels' schedules run CTA by CTA, for the CPU tests

// cp.async's effect: `bytes` bytes from src, zeros for the rest of the 16.
// Bytes before the buffer (the kernel reads them from the aligned storage
// and never uses them) are written as zeros here.
static void host_copy16(uint8_t* dst, uint64_t src, uint32_t bytes,
                        uint64_t base) {
  for (uint32_t b = 0; b < 16; b++)
    dst[b] = (b < bytes && src + b >= base) ? *(const uint8_t*)(uintptr_t)(src + b)
                                            : 0;
}

extern "C" int sha256_many_host(const uint8_t* data, const int64_t* offsets,
                                uint32_t* out, int n, int64_t data_len) {
  static uint32_t ring[MANY_STAGES][MANY_THREADS][WINDOW_WORDS];
  const uint64_t base = (uint64_t)(uintptr_t)data;
  for (int first = 0; first < n; first += MANY_THREADS) {
    const uint64_t cta_base = many_cta_base(base, offsets, first);
    const uint32_t end_rel = (uint32_t)(base + (uint64_t)data_len - cta_base);
    uint32_t len[MANY_THREADS], nb[MANY_THREADS], s[MANY_THREADS];
    uint32_t st[MANY_THREADS][8];
    ManyCopy cps[MANY_THREADS][WINDOW_CHUNKS];
    memset(ring, 0, sizeof ring);
    for (int tid = 0; tid < MANY_THREADS; tid++) {
      const int i = first + tid;
      len[tid] = nb[tid] = s[tid] = 0;
      if (i < n) {
        len[tid] = (uint32_t)(offsets[i + 1] - offsets[i]);
        nb[tid] = nblocks_of(len[tid]);
        s[tid] = (uint32_t)((base + (uint64_t)offsets[i]) & 15);
      }
      const uint32_t h0[8] = SHA256_H0;
      for (int j = 0; j < 8; j++) st[tid][j] = h0[j];
      for (int u = 0; u < WINDOW_CHUNKS; u++)
        cps[tid][u] = many_copy(offsets, n, first, base, cta_base,
                                tid + u * MANY_THREADS);
    }
    auto issue = [&](uint32_t k) {
      uint8_t* stage = (uint8_t*)ring[k % MANY_STAGES];
      for (int tid = 0; tid < MANY_THREADS; tid++)
        for (int u = 0; u < WINDOW_CHUNKS; u++) {
          const uint32_t bytes = many_copy_bytes(cps[tid][u], k, end_rel);
          if (bytes)
            host_copy16(stage + 16 * (tid + u * MANY_THREADS),
                        cta_base + cps[tid][u].rel + 64ull * k, bytes, base);
        }
    };
    for (uint32_t k = 0; k < MANY_STAGES - 1; k++) issue(k);
    for (uint32_t k = 0;; k++) {
      bool any = false;
      for (int tid = 0; tid < MANY_THREADS; tid++) any = any || k < nb[tid];
      if (!any) break;
      issue(k + MANY_STAGES - 1);
      for (int tid = 0; tid < MANY_THREADS; tid++) {
        if (k >= nb[tid]) continue;
        uint32_t W[16];
        block_words(ring[k % MANY_STAGES][tid], s[tid], len[tid], k, nb[tid], W);
        sha256_compress(st[tid], W);
      }
    }
    for (int tid = 0; tid < MANY_THREADS && first + tid < n; tid++)
      for (int j = 0; j < 8; j++) out[(size_t)j * n + first + tid] = st[tid][j];
  }
  return 0;
}

extern "C" int merkle_reduce_host(const uint32_t* level, uint32_t* out, int m,
                                  int width, int depth, int sms) {
  const int nchunks = level_width(width, depth), total = m * nchunks;
  const int chunks = merkle_chunks_per_cta(m, width, depth, sms);
  const int leaf_cap = chunks * leaf_stride(width, depth);
  const int node_cap = chunks * node_stride(width, depth);
  uint32_t* smem = (uint32_t*)calloc(merkle_smem_bytes(width, depth, chunks), 1);
  if (smem == NULL) return 1;
  for (int g0 = 0; g0 < total; g0 += chunks) {
    const int g1 = g0 + chunks < total ? g0 + chunks : total;
    const int l0 = level_start(g0, nchunks, width, depth, 0);
    const int nleaves = level_start(g1, nchunks, width, depth, 0) - l0;
    for (int x = 0; x < 8 * nleaves; x++) {
      size_t src;
      int dst;
      leaf_word(x, nleaves, leaf_cap, m, width, l0, &src, &dst);
      smem[dst] = level[src];
    }
    for (int l = 1; l <= depth; l++) {
      const int f0 = level_start(g0, nchunks, width, depth, l);
      const int count = level_start(g1, nchunks, width, depth, l) - f0;
      const uint32_t* src =
          l == 1 ? smem : smem + 8 * (leaf_cap + ((l - 1) & 1) * node_cap);
      uint32_t* dst = smem + 8 * (leaf_cap + (l & 1) * node_cap);
      const int src_cap = l == 1 ? leaf_cap : node_cap;
      for (int x = 0; x < count; x++) {
        int slot, left, right;
        merkle_node(f0 + x, l, width, depth, nchunks, g0, l0, &slot, &left,
                    &right);
        uint32_t st[8];
        merkle_pair(st, src, src_cap, left, right);
        for (int w = 0; w < 8; w++) {
          if (l == depth)
            out[(size_t)w * total + f0 + x] = st[w];
          else
            dst[w * node_cap + slot] = st[w];
        }
      }
    }
  }
  free(smem);
  return 0;
}

#endif
