// Batched Ed25519 signature verification, one thread per signature.
//
// Replaces the TPU kernel corda_tpu/ops/ed25519_pallas.py::_kernel
// (verify_arrays_pallas), which runs ed25519_jax.verify_core on 1024-lane
// blocks in VMEM. Same contract: (8, N) little-endian 32-bit words of A,
// raw R, S and h = SHA-512(R||A||M) mod L in (word-major, lanes minor, so
// thread i reads word j at j*N + i and a warp's reads coalesce), an int32
// accept mask (N,) out. N is any size: the last block masks its ragged edge.
//
// Semantics are the conformance oracle's (crypto/ref_ed25519.py):
// cofactorless ref10 verify; S and h windowed over all 256 bits (no S < L
// check); y taken from bits 0..254 and used mod p without a range check;
// the parity != sign flip applied even for x = 0; point_ok = ok_direct |
// ok_flip; the encoding of R' compared with the RAW R bytes, so a
// non-canonical R rejects.
//
// What bounds it on an H100: 32-bit integer multiply-adds. This structure
// costs 1,835 field multiplies and 1,537 squarings a signature
// (decompression 20 + 255, the -A table 60 + 4, 65 windows 1,742 + 1,024,
// the final inversion and encode 13 + 254): fixed windows pay a full
// addition even for a zero digit. The least work for given scalars is
// less: ref10's variable-time sliding windows need about 1,500 and 1,525
// for random ones, and chip_smoke.py bounds the kernel by that count of
// its inputs. Traffic is 128 B read and 4 B written per signature,
// negligible against either. Design:
//   * radix 2^32: a field element is 8 x 32-bit words, which is what
//     Hopper's 32x32 multiplier takes. A multiply is 64 partial products in
//     PTX carry chains (mad.lo.cc / madc.hi.cc), each row split into two
//     independent chains by the parity of the product's word, a square 36
//     (28 doubled cross products + 8 diagonal), then the high half folds
//     in times 38
//     (2^256 = 38 mod p). Reduction is lazy. INVARIANT: every field
//     operation takes any 256-bit values and returns a value < 2^256
//     congruent to its result mod p; only fe_freeze returns [0, p);
//   * ref10's point forms (p2, p3, p1p1): doublings that feed a doubling,
//     and the addition that closes a window, never compute T;
//   * signed radix-16 digits in -8..7 (S and h recoded over all 256 bits;
//     the carry out is a 65th digit, 0 or 1, taken as a first window), so
//     both tables hold [1..8] only: a negative digit swaps y+x and y-x and
//     the sign of the 2dT term; digit 0 selects the identity;
//   * the fixed-base table [1..8]B (niels form y+x, y-x, 2dxy) is staged in
//     shared memory at block start: lanes read different entries, which
//     the constant cache would serialise;
//   * the per-signature [1..8](-A) table (cached form, 1 KB) lives in local
//     memory. It cannot live in shared memory whole (512 threads x 1 KB per
//     SM is more than its 228 KB); with its first two entries there (32 KB
//     a block) the kernel ran no faster on an H100 (PERF.md);
//   * __launch_bounds__(128, 4): at most 128 registers, so 4 blocks of 128
//     fit an SM and N = 65,536 runs in one wave on 132 SMs. No spills: the
//     once-per-signature parts (decompression, the -A table, the two
//     exponentiations) are calls with their own register allocation, and
//     the inputs are read from memory where they are used;
//   * all lanes run the same instruction stream (no data-dependent exits),
//     so a warp never diverges except at the ragged edge.
//
// The arithmetic compiles for either side: under nvcc as device functions
// over PTX carry chains, without nvcc (as C++) as host functions over a C
// twin of each PTX instruction that keeps the carry flag in a variable.
// The host build exports ed25519_verify_host, fe_op_host and recode_host,
// which the CPU tests use to hold this exact code against the oracle.

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
// Called once per signature: its own register allocation, so the values
// live around the call do not crowd its multiplies into spilling.
#define HD_CALL __device__ __noinline__
#define THREADS 128
#else
#define HD static inline
#define HD_CALL static
#endif

typedef unsigned long long u64;

// ---------------------------------------------------------------------------
// The carry-chain instructions: PTX on the card, a C twin on the host.

#if defined(__CUDACC__)
#define PTX2(name, ins)                                                    \
  HD uint32_t name(uint32_t a, uint32_t b) {                               \
    uint32_t r;                                                            \
    asm volatile(ins " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));           \
    return r;                                                              \
  }
#define PTX3(name, ins)                                                    \
  HD uint32_t name(uint32_t a, uint32_t b, uint32_t c) {                   \
    uint32_t r;                                                            \
    asm volatile(ins " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                              \
  }
PTX2(add_cc, "add.cc.u32")
PTX2(addc_cc, "addc.cc.u32")
PTX2(addc, "addc.u32")
PTX2(sub_cc, "sub.cc.u32")
PTX2(subc_cc, "subc.cc.u32")
PTX2(subc, "subc.u32")
PTX3(mad_lo_cc, "mad.lo.cc.u32")
PTX3(madc_lo_cc, "madc.lo.cc.u32")
PTX3(mad_hi_cc, "mad.hi.cc.u32")
PTX3(madc_hi_cc, "madc.hi.cc.u32")
PTX3(madc_hi, "madc.hi.u32")
#else
static thread_local uint32_t cf;  // CC.CF: the carry (or, after sub, borrow)
HD uint32_t add_cc(uint32_t a, uint32_t b) {
  u64 s = (u64)a + b; cf = (uint32_t)(s >> 32); return (uint32_t)s;
}
HD uint32_t addc_cc(uint32_t a, uint32_t b) {
  u64 s = (u64)a + b + cf; cf = (uint32_t)(s >> 32); return (uint32_t)s;
}
HD uint32_t addc(uint32_t a, uint32_t b) { return a + b + cf; }
HD uint32_t sub_cc(uint32_t a, uint32_t b) {
  u64 d = (u64)a - b; cf = (uint32_t)(d >> 32) & 1; return (uint32_t)d;
}
HD uint32_t subc_cc(uint32_t a, uint32_t b) {
  u64 d = (u64)a - b - cf; cf = (uint32_t)(d >> 32) & 1; return (uint32_t)d;
}
HD uint32_t subc(uint32_t a, uint32_t b) { return a - b - cf; }
HD uint32_t lo(uint32_t a, uint32_t b) { return a * b; }
HD uint32_t hi(uint32_t a, uint32_t b) { return (uint32_t)(((u64)a * b) >> 32); }
HD uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return add_cc(lo(a, b), c); }
HD uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return addc_cc(lo(a, b), c); }
HD uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) { return add_cc(hi(a, b), c); }
HD uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) { return addc_cc(hi(a, b), c); }
HD uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) { return addc(hi(a, b), c); }
#endif

// ---------------------------------------------------------------------------
// GF(2^255 - 19) in 8 x 32-bit words, little-endian.

struct fe { uint32_t v[8]; };
struct ge_p2 { fe X, Y, Z; };             // x = X/Z, y = Y/Z
struct ge_p3 { fe X, Y, Z, T; };          // extended: T = XY/Z
struct ge_p1p1 { fe X, Y, Z, T; };        // x = X/Z, y = Y/T
struct ge_cached { fe YpX, YmX, Z, T2d; };
struct ge_niels { fe ypx, ymx, xy2d; };   // affine, z = 1

// Constants (tests/test_torch_csrc.py checks them against the oracle).
#define FE_D {{0x135978a3U, 0x75eb4dcaU, 0x4141d8abU, 0x00700a4dU, \
               0x7779e898U, 0x8cc74079U, 0x2b6ffe73U, 0x52036ceeU}}
#define FE_D2 {{0x26b2f159U, 0xebd69b94U, 0x8283b156U, 0x00e0149aU, \
                0xeef3d130U, 0x198e80f2U, 0x56dffce7U, 0x2406d9dcU}}
#define FE_SQRTM1 {{0x4a0ea0b0U, 0xc4ee1b27U, 0xad2fe478U, 0x2f431806U, \
                    0x3dfbd7a7U, 0x2b4d0099U, 0x4fc1df0bU, 0x2b832480U}}
// 4p = 2^257 - 76 as nine words: fe_sub's offset.
#define P4_LO 0xffffffb4U
#define P4_MID 0xffffffffU
#define P4_TOP 1U

HD fe fe_const(uint32_t x) {
  fe r = {{x, 0, 0, 0, 0, 0, 0, 0}};
  return r;
}

// r + c * 2^256 -> a value < 2^256, same mod p (c < 2^26).
HD void fe_fold(fe& r, uint32_t c) {
  r.v[0] = mad_lo_cc(c, 38, r.v[0]);
#pragma unroll
  for (int k = 1; k < 8; k++) r.v[k] = addc_cc(r.v[k], 0);
  // A carry out leaves r < 38c, so r + 38 cannot carry again.
  r.v[0] += 38 * addc(0, 0);
}

HD fe fe_add(const fe& a, const fe& b) {
  fe r;
  r.v[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int k = 1; k < 8; k++) r.v[k] = addc_cc(a.v[k], b.v[k]);
  fe_fold(r, addc(0, 0));
  return r;
}

// a - b as (4p - b) + a: 4p exceeds any 256-bit b, so nothing borrows; the
// sum is below 3 * 2^256.
HD fe fe_sub(const fe& a, const fe& b) {
  fe r;
  r.v[0] = sub_cc(P4_LO, b.v[0]);
#pragma unroll
  for (int k = 1; k < 8; k++) r.v[k] = subc_cc(P4_MID, b.v[k]);
  uint32_t top = subc(P4_TOP, 0);
  r.v[0] = add_cc(r.v[0], a.v[0]);
#pragma unroll
  for (int k = 1; k < 8; k++) r.v[k] = addc_cc(r.v[k], a.v[k]);
  fe_fold(r, addc(top, 0));
  return r;
}

HD fe fe_neg(const fe& a) { return fe_sub(fe_const(0), a); }

// t (512 bits) -> t_lo + 38 * t_hi, folded below 2^256. Each 38 * t_hi[k]
// is a lo/hi pair at words k, k + 1: the even k add into t_lo in one carry
// chain; the odd k pairs never overlap, so they are plain 64-bit products,
// added in a second chain. The top word is at most 1 + 37 + 1.
HD fe fe_reduce(const uint32_t t[16]) {
  fe r;
  r.v[0] = mad_lo_cc(t[8], 38, t[0]);
  r.v[1] = madc_hi_cc(t[8], 38, t[1]);
#pragma unroll
  for (int k = 2; k < 8; k += 2) {
    r.v[k] = madc_lo_cc(t[8 + k], 38, t[k]);
    r.v[k + 1] = madc_hi_cc(t[8 + k], 38, t[k + 1]);
  }
  uint32_t top = addc(0, 0);
  u64 odd = (u64)t[9] * 38;
  r.v[1] = add_cc(r.v[1], (uint32_t)odd);
  r.v[2] = addc_cc(r.v[2], (uint32_t)(odd >> 32));
#pragma unroll
  for (int k = 3; k < 7; k += 2) {
    odd = (u64)t[8 + k] * 38;
    r.v[k] = addc_cc(r.v[k], (uint32_t)odd);
    r.v[k + 1] = addc_cc(r.v[k + 1], (uint32_t)(odd >> 32));
  }
  odd = (u64)t[15] * 38;
  r.v[7] = addc_cc(r.v[7], (uint32_t)odd);
  top = addc(top, (uint32_t)(odd >> 32));
  fe_fold(r, top);
  return r;
}

// w[0..8] += bi * (a_j0 + a_j0+2 2^64 + a_j0+4 2^128 + a_j0+6 2^192): four
// lo/hi pairs that never overlap, in one carry chain. With carry_out the
// chain ends in w[8], which must be zero; without, the caller knows that
// the sum fits w[0..7].
HD void mul_row(uint32_t* w, const fe& a, int j0, uint32_t bi, bool carry_out) {
  w[0] = mad_lo_cc(a.v[j0], bi, w[0]);
  w[1] = madc_hi_cc(a.v[j0], bi, w[1]);
#pragma unroll
  for (int j = 2; j < 6; j += 2) {
    w[j] = madc_lo_cc(a.v[j0 + j], bi, w[j]);
    w[j + 1] = madc_hi_cc(a.v[j0 + j], bi, w[j + 1]);
  }
  w[6] = madc_lo_cc(a.v[j0 + 6], bi, w[6]);
  if (carry_out) {
    w[7] = madc_hi_cc(a.v[j0 + 6], bi, w[7]);
    w[8] = addc(0, 0);
  } else {
    w[7] = madc_hi(a.v[j0 + 6], bi, w[7]);
  }
}

// Operand scanning split by the parity of i + j: a_j * b_i goes as a lo/hi
// pair to words i + j, i + j + 1 of e when i + j is even and of o when it
// is odd. So each row is two independent carry chains of four products,
// and every row writes the same word pairs ((2m, 2m+1) of e, (2m+1, 2m+2)
// of o): ptxas keeps each pair in one register pair for IMAD.WIDE.U32.X,
// with no moves between rows (split by the parity of j alone, the pairs
// shift by a word each row and a third of the instructions are MOVs).
// Row i's chain that starts at word i carries into word i + 8, which no
// earlier row of that accumulator reached; the one that starts at word
// i + 1 carries nothing out, since an accumulator after row i is below
// 2^(32 (i + 1)) * 2^256. t = e + o at the end.
HD fe fe_mul(const fe& a, const fe& b) {
  uint32_t e[16], o[16], t[16];
#pragma unroll
  for (int k = 0; k < 16; k++) e[k] = o[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const int odd = i & 1;
    mul_row(&e[i + odd], a, odd, b.v[i], !odd);
    mul_row(&o[i + 1 - odd], a, 1 - odd, b.v[i], odd);
  }
  t[0] = e[0];
  t[1] = add_cc(e[1], o[1]);
#pragma unroll
  for (int k = 2; k < 15; k++) t[k] = addc_cc(e[k], o[k]);
  t[15] = addc(e[15], o[15]);
  return fe_reduce(t);
}

// The 28 cross products a_i * a_j (i < j) as lo/hi pairs in two
// accumulators by the parity of i + j (pairs within one never overlap, so
// each row is two independent carry chains, each ending in a carry word),
// summed and doubled; then the 8 squares a_i^2 added in one chain.
HD fe fe_sq(const fe& a) {
  uint32_t e[16], o[16], t[16];
#pragma unroll
  for (int k = 0; k < 16; k++) e[k] = o[k] = 0;
#pragma unroll
  for (int i = 0; i < 7; i++) {
    o[2 * i + 1] = mad_lo_cc(a.v[i], a.v[i + 1], o[2 * i + 1]);
    o[2 * i + 2] = madc_hi_cc(a.v[i], a.v[i + 1], o[2 * i + 2]);
    int j = i + 3;
#pragma unroll
    for (; j < 8; j += 2) {
      o[i + j] = madc_lo_cc(a.v[i], a.v[j], o[i + j]);
      o[i + j + 1] = madc_hi_cc(a.v[i], a.v[j], o[i + j + 1]);
    }
    o[i + j] = addc(o[i + j], 0);
    if (i + 2 < 8) {
      e[2 * i + 2] = mad_lo_cc(a.v[i], a.v[i + 2], e[2 * i + 2]);
      e[2 * i + 3] = madc_hi_cc(a.v[i], a.v[i + 2], e[2 * i + 3]);
      j = i + 4;
#pragma unroll
      for (; j < 8; j += 2) {
        e[i + j] = madc_lo_cc(a.v[i], a.v[j], e[i + j]);
        e[i + j + 1] = madc_hi_cc(a.v[i], a.v[j], e[i + j + 1]);
      }
      e[i + j] = addc(e[i + j], 0);
    }
  }
  // t = 2 (e + o) + sum a_i^2 2^(64 i)
  t[0] = 0;
  t[1] = add_cc(e[1], o[1]);
#pragma unroll
  for (int k = 2; k < 16; k++) t[k] = addc_cc(e[k], o[k]);
  t[1] = add_cc(t[1], t[1]);
#pragma unroll
  for (int k = 2; k < 16; k++) t[k] = addc_cc(t[k], t[k]);
  t[0] = mad_lo_cc(a.v[0], a.v[0], t[0]);
  t[1] = madc_hi_cc(a.v[0], a.v[0], t[1]);
#pragma unroll
  for (int i = 1; i < 7; i++) {
    t[2 * i] = madc_lo_cc(a.v[i], a.v[i], t[2 * i]);
    t[2 * i + 1] = madc_hi_cc(a.v[i], a.v[i], t[2 * i + 1]);
  }
  t[14] = madc_lo_cc(a.v[7], a.v[7], t[14]);
  t[15] = madc_hi(a.v[7], a.v[7], t[15]);
  return fe_reduce(t);
}

HD fe fe_sqn(fe a, int n) {
#if defined(__CUDACC__)
#pragma unroll 1
#endif
  for (int i = 0; i < n; i++) a = fe_sq(a);
  return a;
}

// Canonical representative in [0, p) of any 256-bit value (plain C: it runs
// a few times per signature).
HD fe fe_freeze(fe a) {
  u64 c = 19 * (u64)(a.v[7] >> 31);  // 2^255 = 19 mod p
  a.v[7] &= 0x7fffffffU;
  for (int k = 0; k < 8; k++) {
    c += a.v[k];
    a.v[k] = (uint32_t)c;
    c >>= 32;
  }
  // Now a < 2^255 + 19 < 2p; a >= p iff a + 19 >= 2^255.
  fe w;
  c = 19;
  for (int k = 0; k < 8; k++) {
    c += a.v[k];
    w.v[k] = (uint32_t)c;
    c >>= 32;
  }
  const bool ge_p = (w.v[7] >> 31) != 0;
  w.v[7] &= 0x7fffffffU;
  for (int k = 0; k < 8; k++) a.v[k] = ge_p ? w.v[k] : a.v[k];
  return a;
}

HD bool fe_iszero(const fe& a) {
  fe f = fe_freeze(a);
  uint32_t acc = 0;
  for (int k = 0; k < 8; k++) acc |= f.v[k];
  return acc == 0;
}

// z^(2^252 - 3) (ref10's addition chain: 251 squarings, 11 multiplies).
HD_CALL fe fe_pow22523(const fe& z) {
  fe t0, t1, t2;
  t0 = fe_sq(z);
  t1 = fe_sqn(t0, 2);
  t1 = fe_mul(z, t1);
  t0 = fe_mul(t0, t1);
  t0 = fe_sq(t0);
  t0 = fe_mul(t1, t0);            // 2^5 - 1
  t1 = fe_sqn(t0, 5);
  t0 = fe_mul(t1, t0);            // 2^10 - 1
  t1 = fe_sqn(t0, 10);
  t1 = fe_mul(t1, t0);            // 2^20 - 1
  t2 = fe_sqn(t1, 20);
  t1 = fe_mul(t2, t1);            // 2^40 - 1
  t1 = fe_sqn(t1, 10);
  t0 = fe_mul(t1, t0);            // 2^50 - 1
  t1 = fe_sqn(t0, 50);
  t1 = fe_mul(t1, t0);            // 2^100 - 1
  t2 = fe_sqn(t1, 100);
  t1 = fe_mul(t2, t1);            // 2^200 - 1
  t1 = fe_sqn(t1, 50);
  t0 = fe_mul(t1, t0);            // 2^250 - 1
  t0 = fe_sqn(t0, 2);
  return fe_mul(t0, z);           // 2^252 - 3
}

// z^(p - 2) = z^(2^255 - 21); inv(0) = 0 (254 squarings, 11 multiplies).
HD_CALL fe fe_invert(const fe& z) {
  fe t0, t1, t2, t3;
  t0 = fe_sq(z);
  t1 = fe_sqn(t0, 2);
  t1 = fe_mul(z, t1);
  t0 = fe_mul(t0, t1);            // 11
  t2 = fe_sq(t0);
  t1 = fe_mul(t1, t2);            // 2^5 - 1
  t2 = fe_sqn(t1, 5);
  t1 = fe_mul(t2, t1);            // 2^10 - 1
  t2 = fe_sqn(t1, 10);
  t2 = fe_mul(t2, t1);            // 2^20 - 1
  t3 = fe_sqn(t2, 20);
  t2 = fe_mul(t3, t2);            // 2^40 - 1
  t2 = fe_sqn(t2, 10);
  t1 = fe_mul(t2, t1);            // 2^50 - 1
  t2 = fe_sqn(t1, 50);
  t2 = fe_mul(t2, t1);            // 2^100 - 1
  t3 = fe_sqn(t2, 100);
  t2 = fe_mul(t3, t2);            // 2^200 - 1
  t2 = fe_sqn(t2, 50);
  t1 = fe_mul(t2, t1);            // 2^250 - 1
  t1 = fe_sqn(t1, 5);
  return fe_mul(t1, t0);          // 2^255 - 21
}

HD fe fe_select(bool c, const fe& a, const fe& b) {  // c ? a : b
  fe r;
  for (int k = 0; k < 8; k++) r.v[k] = c ? a.v[k] : b.v[k];
  return r;
}

// ---------------------------------------------------------------------------
// Group arithmetic, ref10's forms (complete formulas, a = -1).

// dbl-2008-hwcd: 4 squarings, no T needed or made.
HD ge_p1p1 ge_dbl(const ge_p2& p) {
  fe xx = fe_sq(p.X), yy = fe_sq(p.Y), zz = fe_sq(p.Z);
  fe b = fe_add(zz, zz);
  fe aa = fe_sq(fe_add(p.X, p.Y));
  ge_p1p1 r;
  r.Y = fe_add(yy, xx);
  r.Z = fe_sub(yy, xx);
  r.X = fe_sub(aa, r.Y);
  r.T = fe_sub(b, r.Z);
  return r;
}

HD ge_p2 ge_to_p2(const ge_p1p1& p) {  // 3 mul
  ge_p2 r = {fe_mul(p.X, p.T), fe_mul(p.Y, p.Z), fe_mul(p.Z, p.T)};
  return r;
}

HD ge_p3 ge_to_p3(const ge_p1p1& p) {  // 4 mul
  ge_p3 r = {fe_mul(p.X, p.T), fe_mul(p.Y, p.Z), fe_mul(p.Z, p.T),
             fe_mul(p.X, p.Y)};
  return r;
}

// The tail shared by both additions: A = (y1+x1)*(y2+x2), B = (y1-x1)*
// (y2-x2), C = 2d*t1*t2, D = 2*z1*z2; subtracting q swaps D + C and D - C.
HD ge_p1p1 ge_add_tail(const fe& a, const fe& b, const fe& c, const fe& d,
                       bool neg) {
  fe dp = fe_add(d, c), dm = fe_sub(d, c);
  ge_p1p1 r;
  r.X = fe_sub(a, b);
  r.Y = fe_add(a, b);
  r.Z = fe_select(neg, dm, dp);
  r.T = fe_select(neg, dp, dm);
  return r;
}

// p + q (or p - q) against a cached point: 4 mul.
HD ge_p1p1 ge_add(const ge_p3& p, const ge_cached& q, bool neg) {
  fe a = fe_mul(fe_add(p.Y, p.X), fe_select(neg, q.YmX, q.YpX));
  fe b = fe_mul(fe_sub(p.Y, p.X), fe_select(neg, q.YpX, q.YmX));
  fe c = fe_mul(p.T, q.T2d);
  fe zz = fe_mul(p.Z, q.Z);
  return ge_add_tail(a, b, c, fe_add(zz, zz), neg);
}

// p + q (or p - q) against an affine niels point: 3 mul.
HD ge_p1p1 ge_madd(const ge_p3& p, const ge_niels& q, bool neg) {
  fe a = fe_mul(fe_add(p.Y, p.X), fe_select(neg, q.ymx, q.ypx));
  fe b = fe_mul(fe_sub(p.Y, p.X), fe_select(neg, q.ypx, q.ymx));
  fe c = fe_mul(p.T, q.xy2d);
  return ge_add_tail(a, b, c, fe_add(p.Z, p.Z), neg);
}

HD ge_cached ge_to_cached(const ge_p3& p) {
  const fe d2 = FE_D2;
  ge_cached c = {fe_add(p.Y, p.X), fe_sub(p.Y, p.X), p.Z, fe_mul(p.T, d2)};
  return c;
}

// ---------------------------------------------------------------------------
// Scalars as signed radix-16 digits.

// y = x + 0x8888...8 (64 nibbles of 8). Nibble t of y, less 8, is digit t
// (weight 16^t, in -8..7) of x; the carry out, returned, is digit 64 (0 or
// 1). Any 256-bit x, so S >= 2^255 and S + L recode exactly.
HD uint32_t recode(uint32_t y[8], const uint32_t x[8]) {
  y[0] = add_cc(x[0], 0x88888888U);
#pragma unroll
  for (int k = 1; k < 8; k++) y[k] = addc_cc(x[k], 0x88888888U);
  return addc(0, 0);
}

// Digit t (0..63) of y's word k stored at y[k * stride]: y's nibble t
// less 8. The kernel keeps y in shared memory (one column per thread), off
// the register file.
HD int digit_at(const uint32_t* y, int stride, int t) {
  return (int)((y[(t >> 3) * stride] >> (4 * (t & 7))) & 15) - 8;
}

HD ge_niels niels_entry(const ge_niels* tab, int d) {  // [|d|]B, 0 -> identity
  const int m = d < 0 ? -d : d;
  ge_niels e = tab[(m > 0 ? m : 1) - 1];
  const fe one = fe_const(1), zero = fe_const(0);
  if (m == 0) { e.ypx = one; e.ymx = one; e.xy2d = zero; }
  return e;
}

// [1..8](-A) in cached form, in local memory.
struct atab_t { ge_cached loc[8]; };

HD ge_cached atab_get(const atab_t& t, int d) {  // [|d|](-A), 0 -> identity
  const int m = d < 0 ? -d : d;
  ge_cached c = t.loc[(m > 0 ? m : 1) - 1];
  const fe one = fe_const(1), zero = fe_const(0);
  if (m == 0) { c.YpX = one; c.YmX = one; c.Z = one; c.T2d = zero; }
  return c;
}

// acc + ds*B + dh*(-A) -> p2: the additions of one window (3 + 4 + 4 + 3 mul).
HD ge_p2 window_adds(const ge_p3& acc, int ds, int dh, const ge_niels* btab,
                     const atab_t& atab) {
  ge_p3 p = ge_to_p3(ge_madd(acc, niels_entry(btab, ds), ds < 0));
  return ge_to_p2(ge_add(p, atab_get(atab, dh), dh < 0));
}

// ---------------------------------------------------------------------------

// One signature's inputs: word j of lane i of A at a[j * n + i] (and so on
// for R, S, h). Each is read where it is used, so neither the words nor
// their addresses stay live in registers through the scalar
// multiplication: on the card the lane index is read anew from the special
// registers (volatile, so never hoisted) at each use.
struct lane_in {
  const uint32_t *a, *r, *s, *h;
  int i, n;
};

#if defined(__CUDACC__)
__device__ __forceinline__ int lane_index() {
  uint32_t tid, cta, ntid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(cta));
  asm volatile("mov.u32 %0, %%ntid.x;" : "=r"(ntid));
  return (int)(cta * ntid + tid);
}
#endif

HD void load8(uint32_t w[8], const uint32_t* p, int i, int n) {
#if defined(__CUDACC__)
  i = lane_index();
#endif
  for (int k = 0; k < 8; k++) w[k] = p[(size_t)k * n + i];
}

// Bits 0..254 (y) and bit 255 (the return value) of 8 LE words.
HD int unpack_fe(fe& out, const uint32_t* p, int i, int n) {
  load8(out.v, p, i, n);
  const int sign = (int)(out.v[7] >> 31);
  out.v[7] &= 0x7fffffffU;
  return sign;
}

// Decompress A and negate (ref10 ge_frombytes; decompress_neg_a) into
// neg_a; point_ok = ok_direct | ok_flip.
HD_CALL void decompress_neg_a(const lane_in& in, ge_p3& neg_a, int& point_ok) {
  const fe one = fe_const(1);
  const fe d = FE_D;
  const fe sqrtm1 = FE_SQRTM1;
  fe y;
  const int a_sign = unpack_fe(y, in.a, in.i, in.n);
  fe yy = fe_sq(y);
  fe u = fe_sub(yy, one);
  fe v = fe_add(fe_mul(yy, d), one);
  fe v3 = fe_mul(fe_sq(v), v);
  fe v7 = fe_mul(fe_sq(v3), v);
  fe x = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)));
  fe vxx = fe_mul(v, fe_sq(x));
  const bool ok_direct = fe_iszero(fe_sub(vxx, u));
  const bool ok_flip = fe_iszero(fe_add(vxx, u));
  x = fe_select(ok_flip && !ok_direct, fe_mul(x, sqrtm1), x);
  x = fe_select((int)(fe_freeze(x).v[0] & 1) != a_sign, fe_neg(x), x);
  fe nx = fe_neg(x);
  neg_a.X = nx;
  neg_a.Y = y;
  neg_a.Z = one;
  neg_a.T = fe_mul(nx, y);
  point_ok = ok_direct || ok_flip;
}

// [1..8](-A): 1, 2 = dbl(1), k + 1 = k + 1. Each addition reads [1](-A)
// back from the table rather than keep its 32 words in registers.
HD_CALL void build_atab(const ge_p3& neg_a, atab_t& atab) {
  atab.loc[0] = ge_to_cached(neg_a);
  const ge_p2 neg_a2 = {neg_a.X, neg_a.Y, neg_a.Z};
  ge_p3 cur = ge_to_p3(ge_dbl(neg_a2));
  atab.loc[1] = ge_to_cached(cur);
#if defined(__CUDACC__)
#pragma unroll 1
#endif
  for (int e = 2; e < 8; e++) {
    cur = ge_to_p3(ge_add(cur, atab.loc[0], false));
    atab.loc[e] = ge_to_cached(cur);
  }
}

// One signature. btab: [1..8]B in niels form (shared memory on the card);
// ydig: 16 words, word k at ydig[k * ystride], for the recoded S and h.
HD int verify_one(const lane_in& in, const ge_niels* btab, atab_t& atab,
                  uint32_t* ydig, int ystride) {
  const fe one = fe_const(1), zero = fe_const(0);
  ge_p3 neg_a;
  int point_ok;
  decompress_neg_a(in, neg_a, point_ok);
  build_atab(neg_a, atab);

  // [s]B + [h](-A): digit 64 first, then 64 windows of 4 doublings.
  uint32_t x8[8], y8[8];
  load8(x8, in.s, in.i, in.n);
  const int ds_top = (int)recode(y8, x8);
  for (int k = 0; k < 8; k++) ydig[k * ystride] = y8[k];
  load8(x8, in.h, in.i, in.n);
  const int dh_top = (int)recode(y8, x8);
  for (int k = 0; k < 8; k++) ydig[(8 + k) * ystride] = y8[k];
  const ge_p3 ident = {zero, one, one, zero};
  ge_p2 acc = window_adds(ident, ds_top, dh_top, btab, atab);
#if defined(__CUDACC__)
#pragma unroll 1
#endif
  for (int t = 63; t >= 0; t--) {
    acc = ge_to_p2(ge_dbl(acc));
    acc = ge_to_p2(ge_dbl(acc));
    acc = ge_to_p2(ge_dbl(acc));
    const ge_p3 acc3 = ge_to_p3(ge_dbl(acc));
    const int ds = digit_at(ydig, ystride, t);
    const int dh = digit_at(ydig + 8 * ystride, ystride, t);
    acc = window_adds(acc3, ds, dh, btab, atab);
  }

  // Encode R' and compare with the raw R bytes.
  fe zi = fe_invert(acc.Z);
  fe xr = fe_freeze(fe_mul(acc.X, zi));
  fe yr = fe_freeze(fe_mul(acc.Y, zi));
  fe r_y;
  const int r_sign = unpack_fe(r_y, in.r, in.i, in.n);
  bool ok = point_ok && ((int)(xr.v[0] & 1) == r_sign);
  for (int k = 0; k < 8; k++) ok = ok && (yr.v[k] == r_y.v[k]);
  return ok ? 1 : 0;
}

// Field operations one at a time (the tests' op codes): 0 mul, 1 sq, 2 add,
// 3 sub, 4 neg, 5 freeze, 6 invert, 7 pow22523. Returns 1 for a bad op.
HD int fe_op(int op, const fe& x, const fe& y, fe& z) {
  switch (op) {
    case 0: z = fe_mul(x, y); break;
    case 1: z = fe_sq(x); break;
    case 2: z = fe_add(x, y); break;
    case 3: z = fe_sub(x, y); break;
    case 4: z = fe_neg(x); break;
    case 5: z = fe_freeze(x); break;
    case 6: z = fe_invert(x); break;
    case 7: z = fe_pow22523(x); break;
    default: return 1;
  }
  return 0;
}

#define BTAB_WORDS (8 * 3 * 8)  // 8 niels entries of 3 field elements

#if defined(__CUDACC__)

__global__ void __launch_bounds__(THREADS, 4)
ed25519_verify_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ r,
                      const uint32_t* __restrict__ s,
                      const uint32_t* __restrict__ h,
                      const uint32_t* __restrict__ btab_global,
                      int32_t* __restrict__ out, int n) {
  __shared__ ge_niels btab[8];
  uint32_t* flat = &btab[0].ypx.v[0];
  for (int k = threadIdx.x; k < BTAB_WORDS; k += blockDim.x) flat[k] = btab_global[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  atab_t atab;
  __shared__ uint32_t ydig[16 * THREADS];
  const lane_in in = {a, r, s, h, i, n};
  const int ok = verify_one(in, btab, atab, &ydig[threadIdx.x], THREADS);
  out[lane_index()] = ok;
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int ed25519_verify_launch(const void* a, const void* r,
                                     const void* s, const void* h,
                                     const void* btab, void* out, int n,
                                     void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    ed25519_verify_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)r, (const uint32_t*)s,
        (const uint32_t*)h, (const uint32_t*)btab, (int32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM and threads per block of ed25519_verify_kernel.
extern "C" int ed25519_verify_occupancy(int* blocks_per_sm, int* threads) {
  *threads = THREADS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ed25519_verify_kernel, THREADS, 0);
}

__global__ void fe_op_kernel(int op, const fe* __restrict__ a,
                             const fe* __restrict__ b, fe* __restrict__ out,
                             int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) fe_op(op, a[i], b[i], out[i]);
}

// The field operations on the card, for chip_smoke.py: a, b, out are n x 8
// words; returns cudaGetLastError(), or -1 for a bad op.
extern "C" int fe_op_launch(int op, const void* a, const void* b, void* out,
                            int n, void* stream) {
  if (op < 0 || op > 7) return -1;
  if (n > 0)
    fe_op_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                   (cudaStream_t)stream>>>(op, (const fe*)a, (const fe*)b,
                                           (fe*)out, n);
  return (int)cudaGetLastError();
}

#else  // host build: the same arithmetic, for the CPU tests

extern "C" int ed25519_verify_host(const uint32_t* a, const uint32_t* r,
                                   const uint32_t* s, const uint32_t* h,
                                   const uint32_t* btab, int32_t* out, int n) {
  atab_t atab;
  uint32_t ydig[16];
  for (int i = 0; i < n; i++) {
    const lane_in in = {a, r, s, h, i, n};
    out[i] = verify_one(in, (const ge_niels*)btab, atab, ydig, 1);
  }
  return 0;
}

// fe_op over n elements; a, b, out: n x 8 words.
extern "C" int fe_op_host(int op, const uint32_t* a, const uint32_t* b,
                          uint32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    if (fe_op(op, ((const fe*)a)[i], ((const fe*)b)[i], ((fe*)out)[i]))
      return 1;
  }
  return 0;
}

// Signed digits of n scalars (n x 8 words): digits is n x 65, digit t of
// weight 16^t, digit 64 the carry out.
extern "C" int recode_host(const uint32_t* words, int32_t* digits, int n) {
  for (int i = 0; i < n; i++) {
    uint32_t y[8];
    digits[65 * i + 64] = (int32_t)recode(y, words + 8 * i);
    for (int t = 0; t < 64; t++) digits[65 * i + t] = digit_at(y, 1, t);
  }
  return 0;
}

#endif
