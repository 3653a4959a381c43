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
// What bounds it on an H100: 32-bit integer multiplies. A signature costs
// about 3,700 field multiplies (decompression ~275 with the pow22523 chain,
// the -A table 127, 64 windows of 4 doublings + 2 adds = 3,008, the final
// inversion and encode 267); each is 25 (15 for a square) 64x64->128-bit
// limb products here. Traffic is 128 B read and 4 B written per signature,
// negligible against that. Design:
//   * field elements are 5 x 51-bit limbs in uint64 with 128-bit products:
//     Hopper multiplies 32x32->64 natively, so the TPU's 13-bit limbs (sized
//     for int32 lanes) are not needed; every operation returns limbs below
//     2^52 so the next multiply cannot overflow;
//   * the fixed-base table [0..15]B (niels form y+x, y-x, 2dxy) is staged in
//     shared memory at block start: each lane reads a different entry, which
//     the constant cache would serialise;
//   * the per-signature [0..15](-A) table (cached form, 2.5 KB) lives in
//     thread-local memory and spills; moving it to shared memory is later
//     work;
//   * all lanes run the same instruction stream (no data-dependent exits),
//     so a warp never diverges except at the ragged edge.
//
// The arithmetic compiles for either side: under nvcc as device functions,
// without nvcc (as C++) as host functions exporting ed25519_verify_host, which
// the CPU tests use to hold this exact code against the oracle.

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#else
#define HD static inline
#endif

typedef unsigned long long u64;
typedef unsigned __int128 u128;

#define M51 ((1ULL << 51) - 1)

struct fe { u64 v[5]; };
struct ge { fe X, Y, Z, T; };            // extended: x = X/Z, y = Y/Z, T = XY/Z
struct ge_cached { fe YpX, YmX, Z, T2d; };
struct ge_niels { fe ypx, ymx, xy2d; };  // affine, z = 1

// Constants in 51-bit limbs (tests/test_torch_csrc.py checks them against
// the oracle's integers).
#define FE_D2 {{0x69b9426b2f159ULL, 0x35050762add7aULL, 0x3cf44c0038052ULL, \
                0x6738cc7407977ULL, 0x2406d9dc56dffULL}}
#define FE_D {{0x34dca135978a3ULL, 0x1a8283b156ebdULL, 0x5e7a26001c029ULL, \
               0x739c663a03cbbULL, 0x52036cee2b6ffULL}}
#define FE_SQRTM1 {{0x61b274a0ea0b0ULL, 0xd5a5fc8f189dULL, 0x7ef5e9cbd0c60ULL, \
                    0x78595a6804c9eULL, 0x2b8324804fc1dULL}}

// Limbs in < 2^55 -> limbs < 2^52 (limb 0 < 2^51 + 2^10), same value mod p.
HD fe fe_weak(fe a) {
  u64 c;
  c = a.v[0] >> 51; a.v[0] &= M51; a.v[1] += c;
  c = a.v[1] >> 51; a.v[1] &= M51; a.v[2] += c;
  c = a.v[2] >> 51; a.v[2] &= M51; a.v[3] += c;
  c = a.v[3] >> 51; a.v[3] &= M51; a.v[4] += c;
  c = a.v[4] >> 51; a.v[4] &= M51; a.v[0] += 19 * c;
  return a;
}

HD fe fe_const(u64 x) {
  fe r = {{x, 0, 0, 0, 0}};
  return r;
}

HD fe fe_add(const fe& a, const fe& b) {
  fe r;
  for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
  return fe_weak(r);
}

// a - b as a + 4p - b: 4p's limbs exceed any b < 2^52, so nothing borrows.
HD fe fe_sub(const fe& a, const fe& b) {
  fe r;
  r.v[0] = a.v[0] + 0x1fffffffffffb4ULL - b.v[0];
  for (int i = 1; i < 5; i++) r.v[i] = a.v[i] + 0x1ffffffffffffcULL - b.v[i];
  return fe_weak(r);
}

HD fe fe_neg(const fe& a) { return fe_sub(fe_const(0), a); }

// Inputs < 2^52 per limb: each 128-bit column sum stays below 2^111.
HD fe fe_mul(const fe& a, const fe& b) {
  const u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
  const u64 b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3], b4 = b.v[4];
  const u64 b1_19 = 19 * b1, b2_19 = 19 * b2, b3_19 = 19 * b3, b4_19 = 19 * b4;
  u128 t0 = (u128)a0 * b0 + (u128)a1 * b4_19 + (u128)a2 * b3_19
          + (u128)a3 * b2_19 + (u128)a4 * b1_19;
  u128 t1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2 * b4_19
          + (u128)a3 * b3_19 + (u128)a4 * b2_19;
  u128 t2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0
          + (u128)a3 * b4_19 + (u128)a4 * b3_19;
  u128 t3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1
          + (u128)a3 * b0 + (u128)a4 * b4_19;
  u128 t4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2
          + (u128)a3 * b1 + (u128)a4 * b0;
  fe r;
  t1 += (u64)(t0 >> 51); r.v[0] = (u64)t0 & M51;
  t2 += (u64)(t1 >> 51); r.v[1] = (u64)t1 & M51;
  t3 += (u64)(t2 >> 51); r.v[2] = (u64)t2 & M51;
  t4 += (u64)(t3 >> 51); r.v[3] = (u64)t3 & M51;
  u64 c = (u64)(t4 >> 51); r.v[4] = (u64)t4 & M51;
  r.v[0] += 19 * c;
  r.v[1] += r.v[0] >> 51;
  r.v[0] &= M51;
  return r;
}

HD fe fe_sq(const fe& a) {
  const u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
  const u64 d0 = 2 * a0, d1 = 2 * a1, d2 = 2 * a2, d3 = 2 * a3;
  const u64 a3_19 = 19 * a3, a4_19 = 19 * a4;
  u128 t0 = (u128)a0 * a0 + (u128)d1 * a4_19 + (u128)d2 * a3_19;
  u128 t1 = (u128)d0 * a1 + (u128)d2 * a4_19 + (u128)a3 * a3_19;
  u128 t2 = (u128)d0 * a2 + (u128)a1 * a1 + (u128)d3 * a4_19;
  u128 t3 = (u128)d0 * a3 + (u128)d1 * a2 + (u128)a4 * a4_19;
  u128 t4 = (u128)d0 * a4 + (u128)d1 * a3 + (u128)a2 * a2;
  fe r;
  t1 += (u64)(t0 >> 51); r.v[0] = (u64)t0 & M51;
  t2 += (u64)(t1 >> 51); r.v[1] = (u64)t1 & M51;
  t3 += (u64)(t2 >> 51); r.v[2] = (u64)t2 & M51;
  t4 += (u64)(t3 >> 51); r.v[3] = (u64)t3 & M51;
  u64 c = (u64)(t4 >> 51); r.v[4] = (u64)t4 & M51;
  r.v[0] += 19 * c;
  r.v[1] += r.v[0] >> 51;
  r.v[0] &= M51;
  return r;
}

HD fe fe_sqn(fe a, int n) {
#if defined(__CUDACC__)
#pragma unroll 1
#endif
  for (int i = 0; i < n; i++) a = fe_sq(a);
  return a;
}

// Canonical representative in [0, p).
HD fe fe_freeze(fe a) {
  a = fe_weak(fe_weak(fe_weak(a)));  // every limb < 2^51: value < 2^255
  u64 q = (a.v[0] + 19) >> 51;       // q = 1 iff value >= p
  q = (a.v[1] + q) >> 51;
  q = (a.v[2] + q) >> 51;
  q = (a.v[3] + q) >> 51;
  q = (a.v[4] + q) >> 51;
  a.v[0] += 19 * q;                  // value + 19 - 2^255 when q = 1
  a.v[1] += a.v[0] >> 51; a.v[0] &= M51;
  a.v[2] += a.v[1] >> 51; a.v[1] &= M51;
  a.v[3] += a.v[2] >> 51; a.v[2] &= M51;
  a.v[4] += a.v[3] >> 51; a.v[3] &= M51;
  a.v[4] &= M51;
  return a;
}

HD bool fe_iszero(const fe& a) {
  fe f = fe_freeze(a);
  return (f.v[0] | f.v[1] | f.v[2] | f.v[3] | f.v[4]) == 0;
}

// z^(2^252 - 3) (ref10's addition chain: 251 squarings, 11 multiplies).
HD fe fe_pow22523(const fe& z) {
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
HD fe fe_invert(const fe& z) {
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

// dbl-2008-hwcd with a = -1 (the JAX package's _ext_dbl): 4 sq + 4 mul.
HD ge ge_dbl(const ge& p) {
  fe a = fe_sq(p.X);
  fe b = fe_sq(p.Y);
  fe zz = fe_sq(p.Z);
  fe c = fe_add(zz, zz);
  fe e = fe_sub(fe_sub(fe_sq(fe_add(p.X, p.Y)), a), b);
  fe g = fe_sub(b, a);
  fe f = fe_sub(g, c);
  fe h = fe_neg(fe_add(a, b));
  ge r = {fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
  return r;
}

// add-2008-hwcd-3 against a cached point: 8 mul.
HD ge ge_add_cached(const ge& p, const ge_cached& q) {
  fe a = fe_mul(fe_sub(p.Y, p.X), q.YmX);
  fe b = fe_mul(fe_add(p.Y, p.X), q.YpX);
  fe c = fe_mul(p.T, q.T2d);
  fe zz = fe_mul(p.Z, q.Z);
  fe d = fe_add(zz, zz);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r = {fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
  return r;
}

// The same addition against an affine niels point (z = 1): 7 mul.
HD ge ge_add_niels(const ge& p, const ge_niels& q) {
  fe a = fe_mul(fe_sub(p.Y, p.X), q.ymx);
  fe b = fe_mul(fe_add(p.Y, p.X), q.ypx);
  fe c = fe_mul(p.T, q.xy2d);
  fe d = fe_add(p.Z, p.Z);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r = {fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
  return r;
}

HD ge_cached ge_to_cached(const ge& p) {
  const fe d2 = FE_D2;
  ge_cached c = {fe_add(p.Y, p.X), fe_sub(p.Y, p.X), p.Z, fe_mul(p.T, d2)};
  return c;
}

// 8 LE 32-bit words -> 4 LE 64-bit words.
HD void load_u64x4(u64 q[4], const uint32_t w[8]) {
  for (int i = 0; i < 4; i++) q[i] = (u64)w[2 * i] | ((u64)w[2 * i + 1] << 32);
}

// Bits 0..254 as 51-bit limbs; returns bit 255.
HD int unpack_fe(fe& out, const uint32_t w[8]) {
  u64 q[4];
  load_u64x4(q, w);
  out.v[0] = q[0] & M51;
  out.v[1] = ((q[0] >> 51) | (q[1] << 13)) & M51;
  out.v[2] = ((q[1] >> 38) | (q[2] << 26)) & M51;
  out.v[3] = ((q[2] >> 25) | (q[3] << 39)) & M51;
  out.v[4] = (q[3] >> 12) & M51;
  return (int)(q[3] >> 63);
}

HD int nibble(const u64 q[4], int t) {  // window t of 64, MSB first
  const int bit = 252 - 4 * t;
  return (int)((q[bit >> 6] >> (bit & 63)) & 0xF);
}

// One signature. btab: [0..15]B in niels form (shared memory on the card).
HD int verify_one(const uint32_t aw[8], const uint32_t rw[8],
                  const uint32_t sw[8], const uint32_t hw[8],
                  const ge_niels* btab) {
  const fe one = fe_const(1);
  const fe d = FE_D;
  const fe sqrtm1 = FE_SQRTM1;

  // Decompress A and negate (ref10 ge_frombytes; decompress_neg_a).
  fe y;
  const int a_sign = unpack_fe(y, aw);
  fe yy = fe_sq(y);
  fe u = fe_sub(yy, one);
  fe v = fe_add(fe_mul(yy, d), one);
  fe v3 = fe_mul(fe_sq(v), v);
  fe v7 = fe_mul(fe_sq(v3), v);
  fe x = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)));
  fe vxx = fe_mul(v, fe_sq(x));
  const bool ok_direct = fe_iszero(fe_sub(vxx, u));
  const bool ok_flip = fe_iszero(fe_add(vxx, u));
  fe xs = fe_mul(x, sqrtm1);
  if (ok_flip && !ok_direct) x = xs;
  const bool point_ok = ok_direct || ok_flip;
  if ((int)(fe_freeze(x).v[0] & 1) != a_sign) x = fe_neg(x);
  fe nx = fe_neg(x);
  ge neg_a = {nx, y, one, fe_mul(nx, y)};

  // [k](-A) for k = 0..15, cached form.
  ge_cached atab[16];
  const fe zero = fe_const(0);
  atab[0].YpX = one; atab[0].YmX = one; atab[0].Z = one; atab[0].T2d = zero;
  atab[1] = ge_to_cached(neg_a);
  ge cur = neg_a;
  for (int k = 2; k < 16; k++) {
    cur = ge_add_cached(cur, atab[1]);
    atab[k] = ge_to_cached(cur);
  }

  // [s]B + [h](-A): 64 windows, MSB first.
  u64 s[4], h[4];
  load_u64x4(s, sw);
  load_u64x4(h, hw);
  ge acc = {zero, one, one, zero};
#if defined(__CUDACC__)
#pragma unroll 1
#endif
  for (int t = 0; t < 64; t++) {
    acc = ge_dbl(acc);
    acc = ge_dbl(acc);
    acc = ge_dbl(acc);
    acc = ge_dbl(acc);
    acc = ge_add_niels(acc, btab[nibble(s, t)]);
    acc = ge_add_cached(acc, atab[nibble(h, t)]);
  }

  // Encode R' and compare with the raw R bytes.
  fe zi = fe_invert(acc.Z);
  fe xr = fe_freeze(fe_mul(acc.X, zi));
  fe yr = fe_freeze(fe_mul(acc.Y, zi));
  fe r_y;
  const int r_sign = unpack_fe(r_y, rw);
  bool ok = point_ok && ((int)(xr.v[0] & 1) == r_sign);
  for (int i = 0; i < 5; i++) ok = ok && (yr.v[i] == r_y.v[i]);
  return ok ? 1 : 0;
}

#define BTAB_U64 (16 * 3 * 5)  // 16 niels entries of 3 field elements

#if defined(__CUDACC__)

#define THREADS 128

__global__ void __launch_bounds__(THREADS)
ed25519_verify_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ r,
                      const uint32_t* __restrict__ s,
                      const uint32_t* __restrict__ h,
                      const u64* __restrict__ btab_global,
                      int32_t* __restrict__ out, int n) {
  __shared__ ge_niels btab[16];
  u64* flat = reinterpret_cast<u64*>(btab);
  for (int k = threadIdx.x; k < BTAB_U64; k += blockDim.x) flat[k] = btab_global[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t aw[8], rw[8], sw[8], hw[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    aw[j] = a[(size_t)j * n + i];
    rw[j] = r[(size_t)j * n + i];
    sw[j] = s[(size_t)j * n + i];
    hw[j] = h[(size_t)j * n + i];
  }
  out[i] = verify_one(aw, rw, sw, hw, btab);
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
        (const uint32_t*)h, (const u64*)btab, (int32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

#else  // host build: the same arithmetic, for the CPU tests

extern "C" int ed25519_verify_host(const uint32_t* a, const uint32_t* r,
                                   const uint32_t* s, const uint32_t* h,
                                   const u64* btab, int32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    uint32_t aw[8], rw[8], sw[8], hw[8];
    for (int j = 0; j < 8; j++) {
      aw[j] = a[(size_t)j * n + i];
      rw[j] = r[(size_t)j * n + i];
      sw[j] = s[(size_t)j * n + i];
      hw[j] = h[(size_t)j * n + i];
    }
    out[i] = verify_one(aw, rw, sw, hw, (const ge_niels*)btab);
  }
  return 0;
}

// Field operations one at a time, for the CPU tests: op 0 mul, 1 sq,
// 2 add, 3 sub, 4 neg, 5 freeze, 6 invert, 7 pow22523. a, b, out: n x 5.
extern "C" int fe_op_host(int op, const u64* a, const u64* b, u64* out, int n) {
  for (int i = 0; i < n; i++) {
    fe x, y, z;
    for (int k = 0; k < 5; k++) { x.v[k] = a[5 * i + k]; y.v[k] = b[5 * i + k]; }
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
    for (int k = 0; k < 5; k++) out[5 * i + k] = z.v[k];
  }
  return 0;
}

#endif
