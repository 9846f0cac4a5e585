// Goldilocks and GF(p^2) elementwise kernels for Hopper (sm_90a): the
// port's field layer on the card.
//
// Replaces the JAX package's field ops, which XLA fuses into the device
// code of every jitted phase (no pallas_call of their own):
//   gl_binary_kernel<Op, Path>  <- tpu_acir_prover/field/gl.py _add64,
//                                  _sub64, _mul64 / _reduce128_64
//   gl_pow_kernel               <- pow_const and inv (a^(p-2)) there
//   ext_mul_kernel<Path>        <- make_ext's mul,
//                                  tpu_acir_prover/field/ext.py
//   ext_prod_kernel             <- a fold of make_ext's mul over columns
//   ext_inv_kernel              <- make_ext's inv there
// Their plain torch twins are field/gl_plain.py and field/ext_plain.py;
// every output is the twin's, bit for bit.
//
// What bounds them on this card:
// - add, sub, mul and the GF(p^2) products read each operand once and
//   write each output once, a few dozen integer instructions an element:
//   bound by bytes (device memory at 3.35 TB/s);
// - the two Fermat inverses are 73 dependent products an element (the
//   addition chain of gl_inv for p - 2: 64 squarings and 9 multiplies):
//   bound by the integer multiply rate.
//
// An element is the uint64_t bits of the port's int64 tensors; the product
// is a * b and __umul64hi(a, b) reduced by the carry chain of
// goldilocks.cuh (gl_mul64), the GF(p^2) sums in 96 bits (Acc) reduced
// once.  Operands are read in place through sizes and strides (rank <=
// MAX_RANK, stride 0 where broadcast, dimensions merged where they are
// contiguous, by the caller), so broadcast rows and columns, 0-d constants
// and strided views are never copied; outputs are contiguous.
//
// The binary kernels and ext_mul take one of four paths, which the wrapper
// (kernels/field.py, plan) chooses once a launch from the layout on the
// host, with the launch's grid and block; each path is a template
// instance of its own:
// - FLAT, rank 1, every operand of stride 1 or 0.  A block of B threads
//   takes VEC * B = 4B consecutive elements, a thread two pairs of them:
//   elements 2t, 2t + 1 and 2B + 2t, 2B + 2t + 1, so that each load or
//   store instruction of a warp covers 512 contiguous bytes.  A pair of an
//   operand of stride 1 is one 16-byte load (the read-only path), of each
//   output one 16-byte store; an operand of stride 0 is read once a pair;
//   a pair that does not start on a 16-byte boundary (a view at an odd
//   element offset) takes two 8-byte loads.  The grid covers the run
//   once: a grid of a few waves striding over the rest, and a thread's
//   four elements as two neighbouring pairs (a warp's load spanning 1 KiB
//   at half use), both measured slower on the card (PERF.md).
// - ROWS, rank 2 or 3 with no transposed operand.  The block is (TX, TY)
//   threads; x walks the innermost run, four contiguous elements (32
//   bytes) a thread, y the rows, z the outermost dimension, so no element
//   pays a division: the outer coordinates come from blockIdx.y / z and
//   the thread's y, with the grid striding where a dimension exceeds
//   65535.  A run of four of an operand of stride 1 is two 16-byte loads,
//   or, 8 bytes off a 16-byte boundary (a row of odd length), a scalar
//   head and tail around one; on the card this beat FLAT's two pairs,
//   whose halves fall in other rows where the rows are short.
// - TILED, rank 2 or 3, where an operand is contiguous along the output's
//   second-innermost dimension (rows) and strided along its innermost
//   (cols): a transposed read, which in the output's order takes one
//   8-byte value of each 32-byte sector.  A block of 256 threads moves a
//   tile of TILE elements, TR rows (the rows rounded up to a power of two,
//   at most 32) by TILE / TR cols, of each such operand through shared
//   memory: it reads them along the operand's rows (TR contiguous values
//   a col), writes the output along its cols, and pads each col of the
//   tile to TR + 1 values, an odd count, so that neither pass conflicts
//   on a bank.  A tile of 32 rows where the output has 4 would leave
//   seven in eight of its threads idle.
// - GENERAL: one thread an element, its coordinates split from the index
//   by division; for what fits none of the above (rank 4 to 6), and at
//   rank 1 (no division) for a strided operand: a column of a matrix costs
//   a 32-byte sector an element whatever the order, and one element a
//   thread leaves more threads to hide the latency than FLAT's four, which
//   were measured slower there (PERF.md).
//
// ext_prod multiplies up to PROD_MAX_COLS listed columns of an ext pair
// of (rows, k) matrices, one thread a row: it loads every listed value of
// its row from each half in place first (the loads of a row in flight
// together), then folds them in registers, so no intermediate product
// reaches device memory, where a fold of ext_mul launches writes and reads
// back each partial product.  A warp's rows lie 128 bytes apart in a (rows,
// 16) matrix; its loads of the listed columns fall in the same sectors,
// which the first load brings into L1, so each sector is read from device
// memory once.  A block staging its rows' spans in shared memory with
// 16-byte loads first was measured no faster on the card (PERF.md).  The
// fold is sequential, not balanced like the twin's; a product mod p is
// exact and each step's output canonical, so the value, and with it the
// bits, does not depend on the fold's order.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a layout,
// a path or a size it does not take: 1 <= n < 2^31) so the caller can
// raise.

#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;  // 2^64 - 2^32 + 1
constexpr uint32_t W = 7;                      // u^2 = 7 in GF(p^2)
constexpr int MAX_RANK = 6;
constexpr int THREADS = 256;
constexpr int64_t MAX_ELEMENTS = int64_t(1) << 31;
constexpr uint32_t MAX_GRID_YZ = 65535;
constexpr uint32_t VEC = 4;            // elements a thread but in GENERAL
constexpr uint32_t TILE = 1024;        // TILED: elements of a tile (2^10),
constexpr uint32_t MAX_TILE_ROWS = 32; // at most 32 of its rows
constexpr uint32_t PROD_ROWS = 128;    // ext_prod: rows a block
constexpr int PROD_MAX_COLS = 8;

enum Op { ADD = 0, SUB = 1, MUL = 2 };
enum Path { FLAT = 0, ROWS = 1, TILED = 2, GENERAL = 3 };

// log2 of TILED's tile rows: the output's rows rounded up to a power of
// two, at most MAX_TILE_ROWS.
__host__ __device__ __forceinline__ uint32_t tile_rows_log2(uint32_t rows) {
  uint32_t lr = 0;
  while ((1u << lr) < rows && (1u << lr) < MAX_TILE_ROWS) ++lr;
  return lr;
}

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

__device__ __forceinline__ uint64_t ld(const uint64_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ ulonglong2 ld2(const uint64_t* p) {
  return __ldg(reinterpret_cast<const ulonglong2*>(p));
}

__device__ __forceinline__ bool aligned16(const uint64_t* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Elements i .. i + VEC - 1 (those below n) of a run at stride s from p.
__device__ __forceinline__ void load_run(const uint64_t* p, int64_t s,
                                         uint32_t i, uint32_t n,
                                         uint64_t (&v)[VEC]) {
  if (s == 0) {
    const uint64_t x = ld(p);
#pragma unroll
    for (uint32_t e = 0; e < VEC; ++e) v[e] = x;
  } else if (s == 1 && i + VEC <= n) {
    const uint64_t* q = p + i;
    if (aligned16(q)) {
      const ulonglong2 a = ld2(q), b = ld2(q + 2);
      v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    } else {
      const ulonglong2 a = ld2(q + 1);
      v[0] = ld(q), v[1] = a.x, v[2] = a.y, v[3] = ld(q + 3);
    }
  } else {
#pragma unroll
    for (uint32_t e = 0; e < VEC; ++e)
      v[e] = i + e < n ? ld(p + (int64_t)(i + e) * s) : 0;
  }
}

// Stores elements i .. i + VEC - 1 (those below n) of a contiguous run.
__device__ __forceinline__ void store_run(uint64_t* p, uint32_t i,
                                          uint32_t n,
                                          const uint64_t (&v)[VEC]) {
  uint64_t* q = p + i;
  if (i + VEC <= n) {
    if (aligned16(q)) {
      reinterpret_cast<ulonglong2*>(q)[0] = make_ulonglong2(v[0], v[1]);
      reinterpret_cast<ulonglong2*>(q)[1] = make_ulonglong2(v[2], v[3]);
    } else {
      q[0] = v[0];
      *reinterpret_cast<ulonglong2*>(q + 1) = make_ulonglong2(v[1], v[2]);
      q[3] = v[3];
    }
  } else {
#pragma unroll
    for (uint32_t e = 0; e < VEC; ++e)
      if (i + e < n) q[e] = v[e];
  }
}

// Elements i and i + 1 (those below n) of a run at stride s from p.
__device__ __forceinline__ void load_pair(const uint64_t* p, int64_t s,
                                          uint32_t i, uint32_t n,
                                          uint64_t& x, uint64_t& y) {
  if (s == 0) {
    x = y = ld(p);
  } else if (s == 1 && i + 1 < n && aligned16(p + i)) {
    const ulonglong2 v = ld2(p + i);
    x = v.x, y = v.y;
  } else {
    x = i < n ? ld(p + (int64_t)i * s) : 0;
    y = i + 1 < n ? ld(p + (int64_t)(i + 1) * s) : 0;
  }
}

// Stores elements i and i + 1 (those below n) of a contiguous run.
__device__ __forceinline__ void store_pair(uint64_t* q, uint32_t i,
                                           uint32_t n, uint64_t x,
                                           uint64_t y) {
  if (i + 1 < n && aligned16(q + i)) {
    *reinterpret_cast<ulonglong2*>(q + i) = make_ulonglong2(x, y);
  } else {
    if (i < n) q[i] = x;
    if (i + 1 < n) q[i + 1] = y;
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

// (x0 + x1 u)(y0 + y1 u) = x0 y0 + 7 x1 y1 + (x0 y1 + x1 y0) u: four
// products, each sum in 96 bits and reduced once; canonical.
__device__ __forceinline__ void ext_mul(uint64_t x0, uint64_t x1,
                                        uint64_t y0, uint64_t y1,
                                        uint64_t& c0, uint64_t& c1) {
  const uint64_t m00 = gl_mul64(x0, y0), m11 = gl_mul64(x1, y1);
  const uint64_t m01 = gl_mul64(x0, y1), m10 = gl_mul64(x1, y0);
  c0 = canon(reduce96(acc_mad_small(acc(m00), m11, W)));
  c1 = canon(reduce96(acc_add(acc(m01), acc(m10))));
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

// The elementwise functions of the pathed kernels: N operands in, M
// outputs.
template <int OP>
struct GlBinary {
  static constexpr int N = 2, M = 1;
  __device__ __forceinline__ static void apply(const uint64_t (&x)[N],
                                               uint64_t (&y)[M]) {
    y[0] = gl_op<OP>(x[0], x[1]);
  }
};

struct ExtMul {
  static constexpr int N = 4, M = 2;
  __device__ __forceinline__ static void apply(const uint64_t (&x)[N],
                                               uint64_t (&y)[M]) {
    ext_mul(x[0], x[1], x[2], x[3], y[0], y[1]);
  }
};

// F on VEC elements of each operand, into VEC elements of each output.
template <class F>
__device__ __forceinline__ void apply_run(const uint64_t (&x)[F::N][VEC],
                                          uint64_t (&y)[F::M][VEC]) {
#pragma unroll
  for (uint32_t e = 0; e < VEC; ++e) {
    uint64_t a[F::N], b[F::M];
#pragma unroll
    for (int k = 0; k < F::N; ++k) a[k] = x[k][e];
    F::apply(a, b);
#pragma unroll
    for (int m = 0; m < F::M; ++m) y[m][e] = b[m];
  }
}

// F on the pairs at i0 and i1 of runs of n elements: operand k's from
// p[k] at stride s[k], the outputs' to the contiguous runs q[m].
template <class F>
__device__ __forceinline__ void two_pairs(const uint64_t* const* p,
                                          const int64_t* s,
                                          uint64_t* const* q, uint32_t i0,
                                          uint32_t i1, uint32_t n) {
  uint64_t x[F::N][VEC], y[F::M][VEC];
#pragma unroll
  for (int k = 0; k < F::N; ++k) {
    load_pair(p[k], s[k], i0, n, x[k][0], x[k][1]);
    load_pair(p[k], s[k], i1, n, x[k][2], x[k][3]);
  }
  apply_run<F>(x, y);
#pragma unroll
  for (int m = 0; m < F::M; ++m) {
    store_pair(q[m], i0, n, y[m][0], y[m][1]);
    store_pair(q[m], i1, n, y[m][2], y[m][3]);
  }
}

template <class F>
__device__ __forceinline__ void flat_path(const uint64_t* const (&in)[F::N],
                                          uint64_t* const (&out)[F::M],
                                          uint32_t n,
                                          const Layout<F::N>& L) {
  const uint32_t i0 = VEC * blockIdx.x * blockDim.x + 2 * threadIdx.x;
  if (i0 >= n) return;
  int64_t s[F::N];
#pragma unroll
  for (int k = 0; k < F::N; ++k) s[k] = L.stride[k][0];
  two_pairs<F>(in, s, out, i0, i0 + 2 * blockDim.x, n);
}

// Rank 2 (rows, len) or 3 (outer, rows, len).
template <class F>
__device__ __forceinline__ void rows_path(const uint64_t* const (&in)[F::N],
                                          uint64_t* const (&out)[F::M],
                                          const Layout<F::N>& L) {
  const int r = L.rank;
  const uint32_t len = (uint32_t)L.size[r - 1];
  const uint32_t rows = (uint32_t)L.size[r - 2];
  const uint32_t outer = r == 3 ? (uint32_t)L.size[0] : 1;
  const uint32_t c = VEC * (blockIdx.x * blockDim.x + threadIdx.x);
  if (c >= len) return;
  for (uint32_t z = blockIdx.z; z < outer; z += gridDim.z) {
    for (uint32_t y = blockIdx.y * blockDim.y + threadIdx.y; y < rows;
         y += gridDim.y * blockDim.y) {
      uint64_t x[F::N][VEC], v[F::M][VEC];
#pragma unroll
      for (int k = 0; k < F::N; ++k) {
        const int64_t off = (r == 3 ? (int64_t)z * L.stride[k][0] : 0) +
                            (int64_t)y * L.stride[k][r - 2];
        load_run(in[k] + off, L.stride[k][r - 1], c, len, x[k]);
      }
      apply_run<F>(x, v);
      const int64_t o = ((int64_t)z * rows + y) * len;
#pragma unroll
      for (int m = 0; m < F::M; ++m) store_run(out[m] + o, c, len, v[m]);
    }
  }
}

// Rank 2 (rows, cols) or 3 (outer, rows, cols); operand k is staged when
// it is contiguous along rows and strided along cols.  A tile is TR rows
// by TILE / TR cols, TR = 2^lr; thread t's VEC elements are u = t + 256 q:
// in the stage (row u mod TR, col u / TR), in the output (row u / TC, col
// u mod TC) for TC = TILE / TR.
template <class F>
__device__ __forceinline__ void tiled_path(const uint64_t* const (&in)[F::N],
                                           uint64_t* const (&out)[F::M],
                                           const Layout<F::N>& L) {
  __shared__ uint64_t tile[F::N][2 * TILE];   // TC (TR + 1) <= 2 TILE
  const int r = L.rank;
  const uint32_t cols = (uint32_t)L.size[r - 1];
  const uint32_t rows = (uint32_t)L.size[r - 2];
  const uint32_t outer = r == 3 ? (uint32_t)L.size[0] : 1;
  const uint32_t lr = tile_rows_log2(rows);
  const uint32_t tr = 1u << lr, lc = 10 - lr, tc = 1u << lc;
  const uint32_t tiles = (rows + tr - 1) >> lr;
  const uint32_t j0 = blockIdx.x * tc;
  bool staged[F::N];
#pragma unroll
  for (int k = 0; k < F::N; ++k)
    staged[k] = L.stride[k][r - 2] == 1 && L.stride[k][r - 1] != 0 &&
                L.stride[k][r - 1] != 1;
  for (uint32_t z = blockIdx.z; z < outer; z += gridDim.z) {
    for (uint32_t t = blockIdx.y; t < tiles; t += gridDim.y) {
      const uint32_t i0 = t * tr;
#pragma unroll
      for (int k = 0; k < F::N; ++k) {
        if (!staged[k]) continue;
        const uint64_t* p =
            in[k] + (r == 3 ? (int64_t)z * L.stride[k][0] : 0);
#pragma unroll
        for (uint32_t q = 0; q < VEC; ++q) {
          const uint32_t u = threadIdx.x + q * THREADS;
          const uint32_t i = u & (tr - 1), j = u >> lr;
          if (i0 + i < rows && j0 + j < cols)
            tile[k][j * (tr + 1) + i] =
                ld(p + i0 + i + (int64_t)(j0 + j) * L.stride[k][r - 1]);
        }
      }
      __syncthreads();
#pragma unroll
      for (uint32_t q = 0; q < VEC; ++q) {
        const uint32_t u = threadIdx.x + q * THREADS;
        const uint32_t j = u & (tc - 1), i = u >> lc;
        if (i0 + i < rows && j0 + j < cols) {
          uint64_t a[F::N], b[F::M];
#pragma unroll
          for (int k = 0; k < F::N; ++k)
            a[k] = staged[k]
                       ? tile[k][j * (tr + 1) + i]
                       : ld(in[k] +
                            (r == 3 ? (int64_t)z * L.stride[k][0] : 0) +
                            (int64_t)(i0 + i) * L.stride[k][r - 2] +
                            (int64_t)(j0 + j) * L.stride[k][r - 1]);
          F::apply(a, b);
          const int64_t o = ((int64_t)z * rows + i0 + i) * cols + j0 + j;
#pragma unroll
          for (int m = 0; m < F::M; ++m) out[m][o] = b[m];
        }
      }
      __syncthreads();
    }
  }
}

template <class F>
__device__ __forceinline__ void general_path(
    const uint64_t* const (&in)[F::N], uint64_t* const (&out)[F::M],
    uint32_t n, const Layout<F::N>& L) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    int64_t off[F::N];
    offsets(L, i, off);
    uint64_t a[F::N], b[F::M];
#pragma unroll
    for (int k = 0; k < F::N; ++k) a[k] = ld(in[k] + off[k]);
    F::apply(a, b);
#pragma unroll
    for (int m = 0; m < F::M; ++m) out[m][i] = b[m];
  }
}

template <class F, int PATH>
__device__ __forceinline__ void run_path(const uint64_t* const (&in)[F::N],
                                         uint64_t* const (&out)[F::M],
                                         uint32_t n, const Layout<F::N>& L) {
  if constexpr (PATH == FLAT) flat_path<F>(in, out, n, L);
  else if constexpr (PATH == ROWS) rows_path<F>(in, out, L);
  else if constexpr (PATH == TILED) tiled_path<F>(in, out, L);
  else general_path<F>(in, out, n, L);
}

template <int OP, int PATH>
__global__ void __launch_bounds__(THREADS)
gl_binary_kernel(const uint64_t* __restrict__ a,
                 const uint64_t* __restrict__ b, uint64_t* __restrict__ out,
                 uint32_t n, Layout<2> L) {
  const uint64_t* const in[2] = {a, b};
  uint64_t* const o[1] = {out};
  run_path<GlBinary<OP>, PATH>(in, o, n, L);
}

template <int PATH>
__global__ void __launch_bounds__(THREADS)
ext_mul_kernel(const uint64_t* __restrict__ a0,
               const uint64_t* __restrict__ a1,
               const uint64_t* __restrict__ b0,
               const uint64_t* __restrict__ b1, uint64_t* __restrict__ c0,
               uint64_t* __restrict__ c1, uint32_t n, Layout<4> L) {
  const uint64_t* const in[4] = {a0, a1, b0, b1};
  uint64_t* const o[2] = {c0, c1};
  run_path<ExtMul, PATH>(in, o, n, L);
}

// a^e, one thread an element; e = p - 2 (the inverse) takes gl_inv's
// chain.
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

// ext_prod's halves and columns; see fd_ext_prod.
struct ProdArgs {
  int64_t rs[2], cs[2];         // each half's row and column strides
  int32_t col[PROD_MAX_COLS];   // the listed columns
  int32_t count;
};

// prod over the listed columns j of (re[:, j] + im[:, j] u), one thread a
// row.
__global__ void __launch_bounds__(PROD_ROWS)
ext_prod_kernel(const uint64_t* __restrict__ re,
                const uint64_t* __restrict__ im, uint64_t* __restrict__ c0,
                uint64_t* __restrict__ c1, uint32_t n, ProdArgs A) {
  const uint32_t row = blockIdx.x * PROD_ROWS + threadIdx.x;
  if (row >= n) return;
  const uint64_t* const p0 = re + (int64_t)row * A.rs[0];
  const uint64_t* const p1 = im + (int64_t)row * A.rs[1];
  // unrolled, so that A.col is read at constant indices (a dynamic index
  // would copy the arguments to local memory)
  uint64_t v0[PROD_MAX_COLS], v1[PROD_MAX_COLS];
#pragma unroll
  for (int j = 0; j < PROD_MAX_COLS; ++j) {
    if (j < A.count) {
      v0[j] = ld(p0 + (int64_t)A.col[j] * A.cs[0]);
      v1[j] = ld(p1 + (int64_t)A.col[j] * A.cs[1]);
    }
  }
  uint64_t x0 = v0[0], x1 = v1[0];
#pragma unroll
  for (int j = 1; j < PROD_MAX_COLS; ++j)
    if (j < A.count) ext_mul(x0, x1, v0[j], v1[j], x0, x1);
  c0[row] = x0;
  c1[row] = x1;
}

// A launch's description from the caller's int64 array:
//   [n, rank, path, grid x, y, z, block x, y, sizes[rank], strides[N][rank]]
// False for a size, a rank, a path or a grid this file does not take.
template <int N>
bool read_desc(const int64_t* d, Layout<N>* L, uint32_t* n, int* path,
               dim3* grid, dim3* block) {
  const int64_t m = d[0];
  const int rank = (int)d[1];
  if (m < 1 || m >= MAX_ELEMENTS || rank < 1 || rank > MAX_RANK)
    return false;
  *n = (uint32_t)m;
  *path = (int)d[2];
  for (int k = 3; k < 8; ++k)
    if (d[k] < 1) return false;
  if (d[3] >= MAX_ELEMENTS || d[4] > MAX_GRID_YZ || d[5] > MAX_GRID_YZ ||
      d[6] * d[7] > THREADS)
    return false;
  *grid = dim3((unsigned)d[3], (unsigned)d[4], (unsigned)d[5]);
  *block = dim3((unsigned)d[6], (unsigned)d[7]);
  const bool ok =
      (*path == FLAT && rank == 1) ||
      (*path == ROWS && (rank == 2 || rank == 3)) ||
      (*path == TILED && (rank == 2 || rank == 3) && d[6] == THREADS &&
       d[7] == 1) ||
      (*path == GENERAL && d[7] == 1 && d[3] * d[6] >= m);
  if (!ok) return false;
  L->rank = rank;
  const int64_t* sizes = d + 8;
  const int64_t* strides = sizes + rank;
  for (int k = 0; k < MAX_RANK; ++k) {
    L->size[k] = k < rank ? sizes[k] : 1;
    for (int j = 0; j < N; ++j)
      L->stride[j][k] = k < rank ? strides[j * rank + k] : 0;
  }
  // FLAT, ROWS and TILED do not stride along x: the grid must cover the
  // innermost run
  const int64_t inner = sizes[rank - 1];
  const int64_t tile_cols =
      TILE >> tile_rows_log2((uint32_t)sizes[rank > 1 ? rank - 2 : 0]);
  return ((*path != FLAT && *path != ROWS) || d[3] * d[6] * VEC >= inner) &&
         (*path != TILED || d[3] * tile_cols >= inner);
}

constexpr int BAD_LAYOUT = (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

const char* fd_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// out = a op b (op 0 add, 1 sub, 2 mul); desc as read_desc's, N = 2.
int fd_gl_binary(int op, const void* a, const void* b, void* out,
                 const int64_t* desc, void* stream) {
  Layout<2> L;
  uint32_t n;
  int path;
  dim3 g, t;
  if (!read_desc(desc, &L, &n, &path, &g, &t) || op < ADD || op > MUL)
    return BAD_LAYOUT;
  cudaStream_t s = (cudaStream_t)stream;
  const uint64_t* x = (const uint64_t*)a;
  const uint64_t* y = (const uint64_t*)b;
  uint64_t* z = (uint64_t*)out;
  // one instance an (op, path)
  using K = void (*)(const uint64_t*, const uint64_t*, uint64_t*, uint32_t,
                     Layout<2>);
  static const K kernels[3][4] = {
      {gl_binary_kernel<ADD, FLAT>, gl_binary_kernel<ADD, ROWS>,
       gl_binary_kernel<ADD, TILED>, gl_binary_kernel<ADD, GENERAL>},
      {gl_binary_kernel<SUB, FLAT>, gl_binary_kernel<SUB, ROWS>,
       gl_binary_kernel<SUB, TILED>, gl_binary_kernel<SUB, GENERAL>},
      {gl_binary_kernel<MUL, FLAT>, gl_binary_kernel<MUL, ROWS>,
       gl_binary_kernel<MUL, TILED>, gl_binary_kernel<MUL, GENERAL>}};
  kernels[op][path]<<<g, t, 0, s>>>(x, y, z, n, L);
  return (int)cudaGetLastError();
}

// out = a^e, one thread an element; desc as read_desc's, N = 1, path
// GENERAL.
int fd_gl_pow(const void* a, uint64_t e, void* out, const int64_t* desc,
              void* stream) {
  Layout<1> L;
  uint32_t n;
  int path;
  dim3 g, t;
  if (!read_desc(desc, &L, &n, &path, &g, &t) || path != GENERAL ||
      t.x != THREADS)
    return BAD_LAYOUT;
  gl_pow_kernel<<<g, t, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)a, e, (uint64_t*)out, n, L);
  return (int)cudaGetLastError();
}

// (c0, c1) = (a0, a1) * (b0, b1); desc as read_desc's, N = 4, any path
// but TILED.
int fd_ext_mul(const void* a0, const void* a1, const void* b0,
               const void* b1, void* c0, void* c1, const int64_t* desc,
               void* stream) {
  Layout<4> L;
  uint32_t n;
  int path;
  dim3 g, t;
  if (!read_desc(desc, &L, &n, &path, &g, &t) || path == TILED)
    return BAD_LAYOUT;
  using K = void (*)(const uint64_t*, const uint64_t*, const uint64_t*,
                     const uint64_t*, uint64_t*, uint64_t*, uint32_t,
                     Layout<4>);
  static const K kernels[4] = {ext_mul_kernel<FLAT>, ext_mul_kernel<ROWS>,
                               nullptr, ext_mul_kernel<GENERAL>};
  kernels[path]<<<g, t, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)a0, (const uint64_t*)a1, (const uint64_t*)b0,
      (const uint64_t*)b1, (uint64_t*)c0, (uint64_t*)c1, n, L);
  return (int)cudaGetLastError();
}

// (c0, c1) = 1 / (a0, a1), one thread an element; desc as read_desc's,
// N = 2, path GENERAL.
int fd_ext_inv(const void* a0, const void* a1, void* c0, void* c1,
               const int64_t* desc, void* stream) {
  Layout<2> L;
  uint32_t n;
  int path;
  dim3 g, t;
  if (!read_desc(desc, &L, &n, &path, &g, &t) || path != GENERAL ||
      t.x != THREADS)
    return BAD_LAYOUT;
  ext_inv_kernel<<<g, t, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)a0, (const uint64_t*)a1, (uint64_t*)c0,
      (uint64_t*)c1, n, L);
  return (int)cudaGetLastError();
}

// (c0, c1)[r] = prod over the listed columns j of (re, im)[r, j] for r <
// n rows.  desc: [n, count, rs_re, cs_re, rs_im, cs_im, cols[count]].
int fd_ext_prod(const void* re, const void* im, void* c0, void* c1,
                const int64_t* desc, void* stream) {
  const int64_t n = desc[0];
  ProdArgs A;
  A.count = (int32_t)desc[1];
  if (n < 1 || n >= MAX_ELEMENTS || A.count < 1 || A.count > PROD_MAX_COLS)
    return BAD_LAYOUT;
  const int64_t* d = desc + 2;
  for (int h = 0; h < 2; ++h) {
    A.rs[h] = *d++;
    A.cs[h] = *d++;
  }
  for (int j = 0; j < PROD_MAX_COLS; ++j) {
    A.col[j] = j < A.count ? (int32_t)*d++ : 0;
    if (A.col[j] < 0) return BAD_LAYOUT;
  }
  const unsigned blocks = (unsigned)((n + PROD_ROWS - 1) / PROD_ROWS);
  ext_prod_kernel<<<blocks, PROD_ROWS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)re, (const uint64_t*)im, (uint64_t*)c0,
      (uint64_t*)c1, (uint32_t)n, A);
  return (int)cudaGetLastError();
}

}  // extern "C"
