// Goldilocks and GF(p^2) elementwise kernels for Hopper (sm_90a): the
// port's field layer on the card.
//
// Replaces the JAX package's field ops, which XLA fuses into the device
// code of every jitted phase (no pallas_call of their own):
//   gl_binary_kernel<Op>  <- tpu_acir_prover/field/gl.py _add64, _sub64,
//                            _mul64 / _reduce128_64 (add, sub, mul)
//   gl_pow_kernel         <- pow_const and inv (a^(p-2)) there
//   ext_mul_kernel        <- make_ext's mul, tpu_acir_prover/field/ext.py
//   ext_inv_kernel        <- make_ext's inv there
// Their plain torch twins are field/gl_plain.py and field/ext_plain.py;
// every output is the twin's, bit for bit.
//
// What bounds them on this card:
// - add, sub, mul and the GF(p^2) product read each operand once and write
//   each output once, a few dozen integer instructions an element: bound
//   by bytes (device memory at 3.35 TB/s);
// - the two Fermat inverses are 73 dependent products an element (the
//   addition chain of gl_inv for p - 2: 64 squarings and 9 multiplies):
//   bound by the integer multiply rate.
//
// Design (right first, one thread per element):
// - an element is the uint64_t bits of the port's int64 tensors; the
//   product is a * b and __umul64hi(a, b) reduced by the carry chain of
//   goldilocks.cuh (gl_mul64), the GF(p^2) sums in 96 bits (Acc) reduced
//   once;
// - operands are read in place through sizes and strides (rank <= MAX_RANK,
//   stride 0 where broadcast, dimensions merged where they are contiguous
//   by the caller), so broadcast rows and columns, 0-d constants and
//   strided views are never copied; the output is contiguous;
// - the element index is split into coordinates in 32 bits (no division at
//   rank 1, where the operands of one shape merge): an output has fewer
//   than 2^31 elements (the wrapper raises on a larger one);
// - the exponent is a host value, the same for every thread, so neither
//   the choice of gl_inv's chain for e = p - 2 nor the square-and-multiply
//   loop for any other e diverges; both run in registers.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a layout
// or a size it does not take: 1 <= n < 2^31) so the caller can raise.

#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;  // 2^64 - 2^32 + 1
constexpr uint32_t W = 7;                      // u^2 = 7 in GF(p^2)
constexpr int MAX_RANK = 6;
constexpr int THREADS = 256;
constexpr int64_t MAX_ELEMENTS = int64_t(1) << 31;

enum Op { ADD = 0, SUB = 1, MUL = 2 };

// The output's sizes (outermost first) and each operand's strides, in
// elements, over the first `rank` dimensions.
template <int N>
struct Layout {
  int rank;
  int64_t size[MAX_RANK];
  int64_t stride[N][MAX_RANK];
};

// The offsets of output element i in each of the N operands.
template <int N>
__device__ __forceinline__ void offsets(const Layout<N>& L, uint32_t i,
                                        int64_t (&off)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) off[k] = 0;
#pragma unroll
  for (int d = MAX_RANK - 1; d >= 0; --d) {
    if (d < L.rank) {
      uint32_t c = i;
      if (d > 0) {
        const uint32_t s = (uint32_t)L.size[d];
        c = i % s;
        i /= s;
      }
#pragma unroll
      for (int k = 0; k < N; ++k) off[k] += (int64_t)c * L.stride[k][d];
    }
  }
}

// (a + b) mod p and (a - b) mod p in the twin's steps (field/gl_plain.py):
// one carry or borrow correction by 2^64 mod p, then canon.
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;
  return canon(s);
}

__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) d -= EPS;
  return canon(d);
}

template <int OP>
__device__ __forceinline__ uint64_t gl_op(uint64_t a, uint64_t b) {
  if (OP == ADD) return gl_add(a, b);
  if (OP == SUB) return gl_sub(a, b);
  return canon(gl_mul64(a, b));
}

// x^e, canonical; x^0 = 1 (0^0 too, as the twin's).
__device__ __forceinline__ uint64_t gl_pow(uint64_t x, uint64_t e) {
  uint64_t r = 1;
  while (e) {
    if (e & 1) r = gl_mul64(r, x);
    e >>= 1;
    if (e) x = gl_mul64(x, x);
  }
  return canon(r);
}

__device__ __forceinline__ uint64_t sqr_n(uint64_t x, int n) {
  for (int k = 0; k < n; ++k) x = gl_mul64(x, x);
  return x;
}

// x^(p-2), canonical (the inverse of x, and 0 for 0), by an addition chain
// of 64 squarings and 9 multiplies.  With t_k = x^(2^k - 1):
// t2 = t1^2 t1, t3 = t2^2 t1, t6 = t3^(2^3) t3, t12 = t6^(2^6) t6,
// t24 = t12^(2^12) t12, t30 = t24^(2^6) t6, t31 = t30^2 t1,
// t32 = t31^2 t1; and p - 2 = (2^31 - 1) 2^33 + 2^32 - 1, so
// x^(p-2) = t31^(2^33) t32.
__device__ __forceinline__ uint64_t gl_inv(uint64_t x) {
  const uint64_t t2 = gl_mul64(gl_mul64(x, x), x);
  const uint64_t t3 = gl_mul64(gl_mul64(t2, t2), x);
  const uint64_t t6 = gl_mul64(sqr_n(t3, 3), t3);
  const uint64_t t12 = gl_mul64(sqr_n(t6, 6), t6);
  const uint64_t t24 = gl_mul64(sqr_n(t12, 12), t12);
  const uint64_t t30 = gl_mul64(sqr_n(t24, 6), t6);
  const uint64_t t31 = gl_mul64(gl_mul64(t30, t30), x);
  const uint64_t t32 = gl_mul64(gl_mul64(t31, t31), x);
  return canon(gl_mul64(sqr_n(t31, 33), t32));
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
gl_binary_kernel(const uint64_t* __restrict__ a,
                 const uint64_t* __restrict__ b, uint64_t* __restrict__ out,
                 uint32_t n, Layout<2> L) {
  const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) {
    int64_t off[2];
    offsets(L, i, off);
    out[i] = gl_op<OP>(a[off[0]], b[off[1]]);
  }
}

// a^e; e = p - 2 (the inverse) takes gl_inv's chain.
__global__ void __launch_bounds__(THREADS)
gl_pow_kernel(const uint64_t* __restrict__ a, uint64_t e,
              uint64_t* __restrict__ out, uint32_t n, Layout<1> L) {
  const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) {
    int64_t off[1];
    offsets(L, i, off);
    out[i] = e == P - 2 ? gl_inv(a[off[0]]) : gl_pow(a[off[0]], e);
  }
}

// (a0 + a1 u)(b0 + b1 u) = a0 b0 + 7 a1 b1 + (a0 b1 + a1 b0) u: four
// products, each sum in 96 bits and reduced once.
__global__ void __launch_bounds__(THREADS)
ext_mul_kernel(const uint64_t* __restrict__ a0,
               const uint64_t* __restrict__ a1,
               const uint64_t* __restrict__ b0,
               const uint64_t* __restrict__ b1, uint64_t* __restrict__ c0,
               uint64_t* __restrict__ c1, uint32_t n, Layout<4> L) {
  const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) {
    int64_t off[4];
    offsets(L, i, off);
    const uint64_t x0 = a0[off[0]], x1 = a1[off[1]];
    const uint64_t y0 = b0[off[2]], y1 = b1[off[3]];
    const uint64_t m00 = gl_mul64(x0, y0), m11 = gl_mul64(x1, y1);
    const uint64_t m01 = gl_mul64(x0, y1), m10 = gl_mul64(x1, y0);
    c0[i] = canon(reduce96(acc_mad_small(acc(m00), m11, W)));
    c1[i] = canon(reduce96(acc_add(acc(m01), acc(m10))));
  }
}

// 1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 - 7 a1^2), the norm's inverse by
// Fermat (gl_inv); the inverse of 0 is 0, as the twin's.
__global__ void __launch_bounds__(THREADS)
ext_inv_kernel(const uint64_t* __restrict__ a0,
               const uint64_t* __restrict__ a1, uint64_t* __restrict__ c0,
               uint64_t* __restrict__ c1, uint32_t n, Layout<2> L) {
  const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) {
    int64_t off[2];
    offsets(L, i, off);
    const uint64_t x0 = a0[off[0]], x1 = a1[off[1]];
    const uint64_t s0 = canon(gl_mul64(x0, x0));
    const uint64_t s1 = canon(reduce96(acc_mad_small(acc(0),
                                                     gl_mul64(x1, x1), W)));
    const uint64_t di = gl_inv(gl_sub(s0, s1));
    const uint64_t im = canon(gl_mul64(x1, di));
    c0[i] = canon(gl_mul64(x0, di));
    c1[i] = im == 0 ? 0 : P - im;
  }
}

// The layout of N operands from the caller's arrays, sizes[rank] and
// strides[N][rank], and the grid of one thread an element.  False for a
// size or a rank this file does not take.
template <int N>
bool make_layout(int64_t n, int rank, const int64_t* sizes,
                 const int64_t* strides, Layout<N>* L, dim3* grid) {
  if (n < 1 || n >= MAX_ELEMENTS || rank < 1 || rank > MAX_RANK)
    return false;
  L->rank = rank;
  for (int d = 0; d < MAX_RANK; ++d) {
    L->size[d] = d < rank ? sizes[d] : 1;
    for (int k = 0; k < N; ++k)
      L->stride[k][d] = d < rank ? strides[k * rank + d] : 0;
  }
  *grid = dim3((unsigned)((n + THREADS - 1) / THREADS));
  return true;
}

constexpr int BAD_LAYOUT = (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

const char* fd_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// out = a op b (op 0 add, 1 sub, 2 mul) over n = prod(sizes) elements;
// strides is [2][rank].
int fd_gl_binary(int op, const void* a, const void* b, void* out, int64_t n,
                 int rank, const int64_t* sizes, const int64_t* strides,
                 void* stream) {
  Layout<2> L;
  dim3 g;
  if (!make_layout(n, rank, sizes, strides, &L, &g)) return BAD_LAYOUT;
  cudaStream_t s = (cudaStream_t)stream;
  const uint64_t* x = (const uint64_t*)a;
  const uint64_t* y = (const uint64_t*)b;
  uint64_t* z = (uint64_t*)out;
  const uint32_t m = (uint32_t)n;
  switch (op) {
    case ADD:
      gl_binary_kernel<ADD><<<g, THREADS, 0, s>>>(x, y, z, m, L);
      break;
    case SUB:
      gl_binary_kernel<SUB><<<g, THREADS, 0, s>>>(x, y, z, m, L);
      break;
    case MUL:
      gl_binary_kernel<MUL><<<g, THREADS, 0, s>>>(x, y, z, m, L);
      break;
    default:
      return BAD_LAYOUT;
  }
  return (int)cudaGetLastError();
}

// out = a^e; strides is [1][rank].
int fd_gl_pow(const void* a, uint64_t e, void* out, int64_t n, int rank,
              const int64_t* sizes, const int64_t* strides, void* stream) {
  Layout<1> L;
  dim3 g;
  if (!make_layout(n, rank, sizes, strides, &L, &g)) return BAD_LAYOUT;
  gl_pow_kernel<<<g, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)a, e, (uint64_t*)out, (uint32_t)n, L);
  return (int)cudaGetLastError();
}

// (c0, c1) = (a0, a1) * (b0, b1); strides is [4][rank].
int fd_ext_mul(const void* a0, const void* a1, const void* b0,
               const void* b1, void* c0, void* c1, int64_t n, int rank,
               const int64_t* sizes, const int64_t* strides, void* stream) {
  Layout<4> L;
  dim3 g;
  if (!make_layout(n, rank, sizes, strides, &L, &g)) return BAD_LAYOUT;
  ext_mul_kernel<<<g, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)a0, (const uint64_t*)a1, (const uint64_t*)b0,
      (const uint64_t*)b1, (uint64_t*)c0, (uint64_t*)c1, (uint32_t)n, L);
  return (int)cudaGetLastError();
}

// (c0, c1) = 1 / (a0, a1); strides is [2][rank].
int fd_ext_inv(const void* a0, const void* a1, void* c0, void* c1,
               int64_t n, int rank, const int64_t* sizes,
               const int64_t* strides, void* stream) {
  Layout<2> L;
  dim3 g;
  if (!make_layout(n, rank, sizes, strides, &L, &g)) return BAD_LAYOUT;
  ext_inv_kernel<<<g, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)a0, (const uint64_t*)a1, (uint64_t*)c0,
      (uint64_t*)c1, (uint32_t)n, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
