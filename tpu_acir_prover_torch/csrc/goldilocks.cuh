// Goldilocks arithmetic on the card, shared by the kernels of poseidon2.cu
// and field.cu: one definition of the field's device functions.
//
// A field element is a uint64_t (the bits of the port's int64 tensors),
// p = 2^64 - 2^32 + 1.  Values stay in [0, 2^64), not canonical, between
// operations; canon() makes them canonical where they are written.
//
// - gl_mul: the 64x64->128 product from four 32x32 partial products in one
//   PTX carry chain (mul.lo/hi, mad.lo.cc, madc.hi.cc), then the reduction;
//   Poseidon2's permutations use it.
// - gl_mul64: the same reduction of the product's two words from the
//   64-bit multiply (a * b and __umul64hi); the field kernels use it.
// - Acc: a 96-bit sum (a 64-bit word and a 32-bit carry count) of lane
//   values or small multiples, reduced once by reduce96.
//
// Each reduction is that of tpu_acir_prover/field/gl.py's _reduce128_64
// (2^64 = 2^32 - 1 and 2^96 = -1 mod p), so a canonical result is that of
// the plain torch twins in field/gl_plain.py, bit for bit.

#pragma once

#include <cstdint>

namespace {

constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p, p = 2^64 - 2^32 + 1

// A 96-bit sum lo + hi * 2^64 of lane values, reduced once at the end.
struct Acc {
  uint64_t lo;
  uint32_t hi;
};

// x mod p for x in [0, 2^64): x - p = x + EPS (mod 2^64) wraps iff x >= p.
__device__ __forceinline__ uint64_t canon(uint64_t x) {
  uint64_t y = x + EPS;
  return y < x ? y : x;
}

// The reduction of a 128-bit value (t3:t2:t1:t0) into [0, 2^64), using
// 2^64 = 2^32 - 1 and 2^96 = -1 (mod p): r = (t1:t0) - t3 + t2 * (2^32 - 1).
// A borrow out of the subtraction is worth -(2^32 - 1), a carry out of the
// addition +(2^32 - 1); neither correction can wrap again.
#define P2_REDUCE128                         \
  "sub.cc.u32 t0, t0, t3;\n\t"               \
  "subc.cc.u32 t1, t1, 0;\n\t"               \
  "subc.u32 c, 0, 0;\n\t"                    \
  "sub.cc.u32 t0, t0, c;\n\t"                \
  "subc.u32 t1, t1, 0;\n\t"                  \
  "sub.cc.u32 e0, 0, t2;\n\t"                \
  "subc.u32 e1, t2, 0;\n\t"                  \
  "add.cc.u32 t0, t0, e0;\n\t"               \
  "addc.cc.u32 t1, t1, e1;\n\t"              \
  "addc.u32 c, 0, 0;\n\t"                    \
  "sub.u32 c, 0, c;\n\t"                     \
  "add.cc.u32 t0, t0, c;\n\t"                \
  "addc.u32 t1, t1, 0;\n\t"

// (t3:t2:t1:t0) = a * b with a = (a1:a0), b = (b1:b0).
#define P2_MUL128                            \
  "mov.b64 {a0, a1}, %1;\n\t"                \
  "mov.b64 {b0, b1}, %2;\n\t"                \
  "mul.lo.u32 t0, a0, b0;\n\t"               \
  "mul.hi.u32 t1, a0, b0;\n\t"               \
  "mul.lo.u32 t2, a1, b1;\n\t"               \
  "mul.hi.u32 t3, a1, b1;\n\t"               \
  "mad.lo.cc.u32 t1, a0, b1, t1;\n\t"        \
  "madc.hi.cc.u32 t2, a0, b1, t2;\n\t"       \
  "addc.u32 t3, t3, 0;\n\t"                  \
  "mad.lo.cc.u32 t1, a1, b0, t1;\n\t"        \
  "madc.hi.cc.u32 t2, a1, b0, t2;\n\t"       \
  "addc.u32 t3, t3, 0;\n\t"

// a * b mod p, in [0, 2^64).
__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, t0, t1, t2, t3, e0, e1, c;\n\t"
      P2_MUL128
      P2_REDUCE128
      "mov.b64 %0, {t0, t1};\n\t"
      "}"
      : "=l"(r) : "l"(a), "l"(b));
  return r;
}

// a * b + s mod p, in [0, 2^64), for b < p: then a * b < 2^128 - 2^96 + 2^64
// and a * b + s < 2^128 for any 96-bit sum s of 12 lanes.
__device__ __forceinline__ uint64_t gl_mul_add(uint64_t a, uint64_t b, Acc s) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, t0, t1, t2, t3, e0, e1, c, s0, s1;\n\t"
      P2_MUL128
      "mov.b64 {s0, s1}, %3;\n\t"
      "add.cc.u32 t0, t0, s0;\n\t"
      "addc.cc.u32 t1, t1, s1;\n\t"
      "addc.cc.u32 t2, t2, %4;\n\t"
      "addc.u32 t3, t3, 0;\n\t"
      P2_REDUCE128
      "mov.b64 %0, {t0, t1};\n\t"
      "}"
      : "=l"(r) : "l"(a), "l"(b), "l"(s.lo), "r"(s.hi));
  return r;
}

// a + c mod p for a in [0, 2^64) and a round constant c < p: one carry
// correction suffices, since a + c - 2^64 + (2^32 - 1) < 2^64.
__device__ __forceinline__ uint64_t gl_add_rc(uint64_t a, uint64_t c) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, k;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "add.cc.u32 a0, a0, b0;\n\t"
      "addc.cc.u32 a1, a1, b1;\n\t"
      "addc.u32 k, 0, 0;\n\t"
      "sub.u32 k, 0, k;\n\t"
      "add.cc.u32 a0, a0, k;\n\t"
      "addc.u32 a1, a1, 0;\n\t"
      "mov.b64 %0, {a0, a1};\n\t"
      "}"
      : "=l"(r) : "l"(a), "l"(c));
  return r;
}

__device__ __forceinline__ Acc acc_add(Acc a, Acc b) {
  Acc r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1;\n\t"
      "mov.b64 {a0, a1}, %2;\n\t"
      "mov.b64 {b0, b1}, %4;\n\t"
      "add.cc.u32 a0, a0, b0;\n\t"
      "addc.cc.u32 a1, a1, b1;\n\t"
      "addc.u32 %1, %3, %5;\n\t"
      "mov.b64 %0, {a0, a1};\n\t"
      "}"
      : "=l"(r.lo), "=r"(r.hi) : "l"(a.lo), "r"(a.hi), "l"(b.lo), "r"(b.hi));
  return r;
}

__device__ __forceinline__ Acc acc(uint64_t x) { return Acc{x, 0u}; }

// a + y * m for a small m: a 96-bit multiply-accumulate.
__device__ __forceinline__ Acc acc_mad_small(Acc a, uint64_t y, uint32_t m) {
  Acc r;
  asm("{\n\t"
      ".reg .u32 y0, y1, l0, l1, h;\n\t"
      "mov.b64 {y0, y1}, %3;\n\t"
      "mov.b64 {l0, l1}, %2;\n\t"
      "mad.lo.cc.u32 l0, y0, %4, l0;\n\t"
      "madc.hi.cc.u32 l1, y0, %4, l1;\n\t"
      "addc.u32 h, %5, 0;\n\t"
      "mad.lo.cc.u32 l1, y1, %4, l1;\n\t"
      "madc.hi.u32 h, y1, %4, h;\n\t"
      "mov.b64 %0, {l0, l1};\n\t"
      "mov.b32 %1, h;\n\t"
      "}"
      : "=l"(r.lo), "=r"(r.hi) : "l"(a.lo), "l"(y), "r"(m), "r"(a.hi));
  return r;
}

// lo + hi * 2^64 mod p, in [0, 2^64): hi * 2^64 = hi * (2^32 - 1).
__device__ __forceinline__ uint64_t reduce96(Acc a) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 l0, l1, e0, e1, c;\n\t"
      "mov.b64 {l0, l1}, %1;\n\t"
      "sub.cc.u32 e0, 0, %2;\n\t"
      "subc.u32 e1, %2, 0;\n\t"
      "add.cc.u32 l0, l0, e0;\n\t"
      "addc.cc.u32 l1, l1, e1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "sub.u32 c, 0, c;\n\t"
      "add.cc.u32 l0, l0, c;\n\t"
      "addc.u32 l1, l1, 0;\n\t"
      "mov.b64 %0, {l0, l1};\n\t"
      "}"
      : "=l"(r) : "l"(a.lo), "r"(a.hi));
  return r;
}

// a * b mod p, in [0, 2^64), from the 64-bit multiply's two words and the
// carry chain of P2_REDUCE128; any a, b in [0, 2^64).
__device__ __forceinline__ uint64_t gl_mul64(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 t0, t1, t2, t3, e0, e1, c;\n\t"
      "mov.b64 {t0, t1}, %1;\n\t"
      "mov.b64 {t2, t3}, %2;\n\t"
      P2_REDUCE128
      "mov.b64 %0, {t0, t1};\n\t"
      "}"
      : "=l"(r) : "l"(a * b), "l"(__umul64hi(a, b)));
  return r;
}

}  // namespace
