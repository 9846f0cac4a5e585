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
//   ext_prod_kernel<ALLBUT>     <- grouped_fold and _axis_excl_products,
//                                  tpu_acir_prover/prover/prove.py (a
//                                  fold of make_ext's mul over columns)
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
// ext_prod computes, in one launch, the product of each of up to
// GP_MAX_GROUPS groups of columns of an ext pair of (rows, k) matrices, k
// <= GP_MAX_K, a group 1 to GP_MAX_COLS disjoint columns; with ALLBUT
// also each group's sum over its columns i of the product of the others
// (the LogUp constraint's leave-one-out sums; 1 for a group of one), as
// grouped_fold and _axis_excl_products compute them for all groups at
// once in tpu_acir_prover/prover/prove.py.  Each output half is a (G,
// rows) block, so that a group's value is a contiguous (rows,) vector.
// - A block of GP_ROWS threads takes one tile of GP_ROWS rows, one row a
//   thread.  A half whose rows are contiguous (column stride 1, row stride
//   k, 16 bytes aligned) is STAGED: the block first copies its tile of it,
//   GP_ROWS * k contiguous values, into shared memory by 16-byte cp.async
//   copies (a warp's copy is 512 contiguous bytes, each value read from
//   device memory once), then computes from there.  One block's copy
//   overlaps another's products: an SM holds five.  Persistent blocks that
//   keep their next tile's copy in flight (two or three buffers, the copies
//   issued by the computing warps or by a producer warp on mbarriers)
//   measured slower on the card (PERF.md).
//   Chunk q of a tile (its values 2q and 2q + 1) lands in slot q ^ ((q >>
//   3) & 7): at k = 16 the eight rows of a quarter warp, each reading the
//   same two columns with one 16-byte load, hit eight different 16-byte
//   bank groups, so a warp reads a column in two wavefronts, the least a
//   64-bit load can take.  (A pitch of 17 values does that for 8-byte
//   reads only: its rows do not start on the 16-byte boundaries that a
//   16-byte copy writes to.)
// - A half broadcast over rows and columns (both strides 0, the lookup's
//   imaginary half) is read once a thread, never staged; any other layout
//   is DIRECT: each value read in place, one thread a row.
// - A group's product is a running product in registers.  With ALLBUT the
//   sum S of the leave-one-out products runs beside it: adding a value t
//   to the values so far (product P) makes S t + P, so a group of L >= 2
//   columns takes 2 L - 3 ext products with its product, where a prefix x
//   suffix scan (_axis_excl_products) takes 3 L - 5 and L products of L - 1
//   columns and the group's take L^2 - L - 1.
// - An ext product is two sums of two Goldilocks products, each summed in
//   32-bit limbs and reduced once (gl_dot2; 7 y1 mod p taken once a value,
//   once a launch for a broadcast half); intermediate values are left in
//   [0, 2^64), what is written is made canonical.
// A product mod p is exact and each output canonical, so the bits do not
// depend on the order of the fold: they are the twin's.  Its bound is
// bytes, but its integer instructions come close to the copies' time at
// the permutation's groups and pass it at the lookup's ALLBUT launch; the
// two only partly overlap (PERF.md).
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
constexpr uint32_t GP_ROWS = 128;      // ext_prod: rows a tile and threads
                                       // a block
constexpr int GP_MAX_K = 16;           // columns of its matrices
constexpr int GP_MAX_GROUPS = 8;
constexpr int GP_MAX_COLS = 8;         // columns of a group

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

// ext_prod: how a half is read.
enum HalfMode { STAGED = 0, DIRECT = 1, BCAST = 2 };

// ext_prod's halves and groups; see fd_ext_prod.
struct GroupArgs {
  const uint64_t* half[2];
  int64_t rs[2], cs[2];         // each half's row and column strides
  int32_t mode[2];              // HalfMode
  int32_t k, count;             // columns, groups
  uint64_t groups;              // byte g: first column | (columns - 1) << 4
};

// The shared-memory slot of chunk q (values 2q, 2q + 1) of a staged tile:
// a permutation within each run of eight chunks (see the top of the file).
__device__ __forceinline__ uint32_t tile_slot(uint32_t q) {
  return q ^ ((q >> 3) & 7);
}

// Copies 16 bytes from device memory at src to shared memory at dst
// without waiting, the first `bytes` of them read and the rest zeros.
__device__ __forceinline__ void cp_async16(uint64_t* dst, const uint64_t* src,
                                           uint32_t bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// Waits for this thread's cp.async copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The field's sums of products a b + c d (+ e) for any 64-bit inputs, in
// 32-bit limbs: P2_MUL128 puts a b in t3:t2:t1:t0, then c d (and e) are
// added by one carry chain into t4:t3:t2:t1:t0 (< 2^130), and one
// reduction follows, P2_REDUCE128's with the 34 bits (t4:t3) above 2^96
// where that takes t3 (2^96 = -1): two products and one reduction cost
// about as much as one product reduced on its own.
#define P2_DOT2_ACC                          \
  "mov.b64 {c0, c1}, %3;\n\t"                \
  "mov.b64 {d0, d1}, %4;\n\t"                \
  "mad.lo.cc.u32 t0, c0, d0, t0;\n\t"        \
  "madc.hi.cc.u32 t1, c0, d0, t1;\n\t"       \
  "madc.lo.cc.u32 t2, c1, d1, t2;\n\t"       \
  "madc.hi.cc.u32 t3, c1, d1, t3;\n\t"       \
  "addc.u32 t4, 0, 0;\n\t"                   \
  "mad.lo.cc.u32 t1, c0, d1, t1;\n\t"        \
  "madc.hi.cc.u32 t2, c0, d1, t2;\n\t"       \
  "addc.cc.u32 t3, t3, 0;\n\t"               \
  "addc.u32 t4, t4, 0;\n\t"                  \
  "mad.lo.cc.u32 t1, c1, d0, t1;\n\t"        \
  "madc.hi.cc.u32 t2, c1, d0, t2;\n\t"       \
  "addc.cc.u32 t3, t3, 0;\n\t"               \
  "addc.u32 t4, t4, 0;\n\t"

#define P2_REDUCE_WIDE                       \
  "sub.cc.u32 t0, t0, t3;\n\t"               \
  "subc.cc.u32 t1, t1, t4;\n\t"              \
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

#define P2_DOT2_REGS \
  ".reg .u32 a0, a1, b0, b1, c0, c1, d0, d1, t0, t1, t2, t3, t4, e0, e1, c;\n\t"

// a b + c d mod p, in [0, 2^64).
__device__ __forceinline__ uint64_t gl_dot2(uint64_t a, uint64_t b,
                                            uint64_t c, uint64_t d) {
  uint64_t r;
  asm("{\n\t" P2_DOT2_REGS P2_MUL128 P2_DOT2_ACC P2_REDUCE_WIDE
      "mov.b64 %0, {t0, t1};\n\t"
      "}"
      : "=l"(r) : "l"(a), "l"(b), "l"(c), "l"(d));
  return r;
}

// a b + c d + e mod p, in [0, 2^64).
__device__ __forceinline__ uint64_t gl_dot2_add(uint64_t a, uint64_t b,
                                                uint64_t c, uint64_t d,
                                                uint64_t e) {
  uint64_t r;
  asm("{\n\t" P2_DOT2_REGS P2_MUL128 P2_DOT2_ACC
      "mov.b64 {e0, e1}, %5;\n\t"
      "add.cc.u32 t0, t0, e0;\n\t"
      "addc.cc.u32 t1, t1, e1;\n\t"
      "addc.cc.u32 t2, t2, 0;\n\t"
      "addc.cc.u32 t3, t3, 0;\n\t"
      "addc.u32 t4, t4, 0;\n\t"
      P2_REDUCE_WIDE
      "mov.b64 %0, {t0, t1};\n\t"
      "}"
      : "=l"(r) : "l"(a), "l"(b), "l"(c), "l"(d), "l"(e));
  return r;
}

// 7 y mod p, in [0, 2^64), for any 64-bit y: 7 y = 8 y - y = lo + hi 2^64
// with hi < 7, and 2^64 = 2^32 - 1; a carry out of the sum is worth
// 2^32 - 1 again.  Shifts, where the 64-bit multiply by 7 took five
// IMAD.WIDE.
__device__ __forceinline__ uint64_t gl_times7(uint64_t y) {
  const uint64_t y8 = y << 3, lo = y8 - y;
  const uint64_t hi = (y >> 61) - (y8 < y);
  const uint64_t add = (hi << 32) - hi, r = lo + add;
  return r < lo ? r + EPS : r;
}

// (x0 + x1 u)(y0 + y1 u) with w1 = 7 y1 mod p given: x0 y0 + x1 w1 and
// x0 y1 + x1 y0, each half left in [0, 2^64).
__device__ __forceinline__ void ext_mul_w(uint64_t x0, uint64_t x1,
                                          uint64_t y0, uint64_t y1,
                                          uint64_t w1, uint64_t& c0,
                                          uint64_t& c1) {
  const uint64_t r0 = gl_dot2(x0, y0, x1, w1);
  c1 = gl_dot2(x0, y1, x1, y0);
  c0 = r0;
}

// Copies the staged halves' rows of the block's tile into their buffers
// buf[h]: the tile's rows * k values, chunk q (values 2q, 2q + 1) by thread
// q mod GP_ROWS into slot tile_slot(q); a last chunk with one value left
// reads 8 bytes and zero-fills the rest.
__device__ __forceinline__ void stage_tile(const GroupArgs& A,
                                           uint64_t* const (&buf)[2],
                                           uint32_t row0, uint32_t n) {
  const uint32_t words = min(GP_ROWS, n - row0) * (uint32_t)A.k;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (A.mode[h] != STAGED) continue;
    const uint64_t* src = A.half[h] + (int64_t)row0 * A.k;
    for (uint32_t q = threadIdx.x; 2 * q < words; q += GP_ROWS)
      cp_async16(buf[h] + 2 * tile_slot(q), src + 2 * q,
                 2 * q + 1 < words ? 16 : 8);
  }
}

// Half H's values of columns c0 .. c0 + len - 1 of the thread's row: local
// row r of the staged tile `tile`, or row `row` in place.  A staged value
// (r, c) is value f = r k + c of the tile: in slot tile_slot(f >> 1), at f
// & 1 within it.  At an even k two neighbouring columns from an even f
// are one 16-byte load.
template <int H>
__device__ __forceinline__ void load_group(const GroupArgs& A,
                                           const uint64_t* tile, uint64_t b,
                                           uint32_t r, uint32_t row, int c0,
                                           int len,
                                           uint64_t (&v)[GP_MAX_COLS]) {
  if (A.mode[H] == BCAST) {
#pragma unroll
    for (int i = 0; i < GP_MAX_COLS; ++i) v[i] = b;
  } else if (A.mode[H] == DIRECT) {
    const uint64_t* p =
        A.half[H] + (int64_t)row * A.rs[H] + (int64_t)c0 * A.cs[H];
#pragma unroll
    for (int i = 0; i < GP_MAX_COLS; ++i)
      if (i < len) v[i] = ld(p + (int64_t)i * A.cs[H]);
  } else {
    const uint32_t f0 = r * (uint32_t)A.k + (uint32_t)c0;
    const bool pairs = (A.k & 1) == 0;
#pragma unroll
    for (int i = 0; i < GP_MAX_COLS; ++i) {
      if (i >= len) continue;
      const uint32_t f = f0 + i;
      const uint64_t* q = tile + 2 * tile_slot(f >> 1);
      if (pairs && (f & 1) == 0 && i + 1 < len) {
        const ulonglong2 x = *reinterpret_cast<const ulonglong2*>(q);
        v[i] = x.x;
        if (i + 1 < GP_MAX_COLS) v[i + 1] = x.y;
      } else if (!(pairs && i > 0 && (f & 1) == 1)) {
        v[i] = q[f & 1];      // not the second value of a pair
      }
    }
  }
}

// A group's product (p0, p1) of its len values t_i = v0 + v1 u (w1 = 7 v1
// mod p) and, with ALLBUT, the sum (s0, s1) over i of the product of all
// values but t_i; all canonical.  Over the first i values, with P their
// product and S that sum, adding t_i makes S t_i + P and P t_i: 2 len - 3
// ext products for len >= 2 (two sums of two products each, the + P
// folded into one of them before its reduction).
template <bool ALLBUT>
__device__ __forceinline__ void group_values(const uint64_t (&v0)[GP_MAX_COLS],
                                             const uint64_t (&v1)[GP_MAX_COLS],
                                             const uint64_t (&w1)[GP_MAX_COLS],
                                             int len, uint64_t& p0,
                                             uint64_t& p1, uint64_t& s0,
                                             uint64_t& s1) {
  uint64_t x0 = v0[0], x1 = v1[0], y0 = 1, y1 = 0;   // P and S
#pragma unroll
  for (int i = 1; i < GP_MAX_COLS; ++i) {
    if (i >= len) continue;
    if (ALLBUT && i == 1) {
      y0 = gl_add(v0[0], v0[1]), y1 = gl_add(v1[0], v1[1]);
    } else if (ALLBUT) {
      const uint64_t r0 = gl_dot2_add(y0, v0[i], y1, w1[i], x0);
      y1 = gl_dot2_add(y0, v1[i], y1, v0[i], x1);
      y0 = r0;
    }
    ext_mul_w(x0, x1, v0[i], v1[i], w1[i], x0, x1);
  }
  p0 = canon(x0), p1 = canon(x1);
  s0 = canon(y0), s1 = canon(y1);
}

// out: the (1 + ALLBUT, 2, A.count, n) products (and sums), re then im.
// A block takes one tile of GP_ROWS rows: it stages the tile, then each
// thread computes one row of it.
template <bool ALLBUT>
__global__ void __launch_bounds__(GP_ROWS)
ext_prod_kernel(const GroupArgs A, uint64_t* __restrict__ out, uint32_t n) {
  extern __shared__ __align__(16) uint64_t smem[];
  const uint32_t row0 = blockIdx.x * GP_ROWS, r = threadIdx.x;
  uint64_t* const tile[2] = {
      smem, smem + (A.mode[0] == STAGED ? GP_ROWS * (uint32_t)A.k : 0)};
  if (A.mode[0] == STAGED || A.mode[1] == STAGED) {
    stage_tile(A, tile, row0, n);
    cp_async_wait_all();
    __syncthreads();
  }
  const uint32_t row = row0 + r;
  if (row >= n) return;
  const uint64_t b0 = A.mode[0] == BCAST ? ld(A.half[0]) : 0;
  const uint64_t b1 = A.mode[1] == BCAST ? ld(A.half[1]) : 0;
  const uint64_t w1b = gl_times7(b1);
  const int64_t block = (int64_t)A.count * n;
#pragma unroll 1
  for (int g = 0; g < A.count; ++g) {
    const uint32_t byte = (uint32_t)(A.groups >> (8 * g)) & 0xFF;
    const int c0 = byte & 15, len = (byte >> 4) + 1;
    uint64_t v0[GP_MAX_COLS], v1[GP_MAX_COLS], w1[GP_MAX_COLS];
    load_group<0>(A, tile[0], b0, r, row, c0, len, v0);
    load_group<1>(A, tile[1], b1, r, row, c0, len, v1);
#pragma unroll
    for (int i = 1; i < GP_MAX_COLS; ++i)
      if (i < len) w1[i] = A.mode[1] == BCAST ? w1b : gl_times7(v1[i]);
    uint64_t p0, p1, s0, s1;
    group_values<ALLBUT>(v0, v1, w1, len, p0, p1, s0, s1);
    uint64_t* o = out + (int64_t)g * n + row;
    o[0] = p0;
    o[block] = p1;
    if (ALLBUT) {
      o[2 * block] = s0;
      o[3 * block] = s1;
    }
  }
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

// For each group g of columns of the ext pair (re, im) of (n, k) matrices,
// the product of its columns into out[0][.][g] and, with allbut, the sum of
// its leave-one-out products into out[1][.][g]: out is (1 + allbut, 2,
// count, n), re halves before im.  desc: [n, k, count, allbut, mode_re,
// rs_re, cs_re, mode_im, rs_im, cs_im, groups], modes and groups as
// GroupArgs' (a staged half: column stride 1, row stride k, 16-byte
// aligned; a broadcast half: strides 0); groups disjoint, inside k.
int fd_ext_prod(const void* re, const void* im, void* out,
                const int64_t* desc, void* stream) {
  const int64_t n = desc[0];
  GroupArgs A;
  A.k = (int32_t)desc[1];
  A.count = (int32_t)desc[2];
  const bool allbut = desc[3] != 0;
  if (n < 1 || n >= MAX_ELEMENTS || A.k < 1 || A.k > GP_MAX_K ||
      A.count < 1 || A.count > GP_MAX_GROUPS)
    return BAD_LAYOUT;
  A.half[0] = (const uint64_t*)re;
  A.half[1] = (const uint64_t*)im;
  for (int h = 0; h < 2; ++h) {
    A.mode[h] = (int32_t)desc[4 + 3 * h];
    A.rs[h] = desc[5 + 3 * h];
    A.cs[h] = desc[6 + 3 * h];
    const bool ok =
        (A.mode[h] == STAGED && A.cs[h] == 1 && A.rs[h] == A.k &&
         (reinterpret_cast<uintptr_t>(A.half[h]) & 15) == 0) ||
        (A.mode[h] == BCAST && A.rs[h] == 0 && A.cs[h] == 0) ||
        A.mode[h] == DIRECT;
    if (!ok) return BAD_LAYOUT;
  }
  A.groups = (uint64_t)desc[10];
  uint32_t used = 0;
  for (int g = 0; g < GP_MAX_GROUPS; ++g) {
    const uint32_t byte = (uint32_t)(A.groups >> (8 * g)) & 0xFF;
    if (g >= A.count) {
      if (byte) return BAD_LAYOUT;
      continue;
    }
    const int c0 = byte & 15, len = (byte >> 4) + 1;
    const uint32_t cols = ((1u << len) - 1) << c0;
    if (byte > 0x7F || c0 + len > A.k || (used & cols)) return BAD_LAYOUT;
    used |= cols;
  }
  const int staged = (A.mode[0] == STAGED) + (A.mode[1] == STAGED);
  const size_t smem = (size_t)staged * GP_ROWS * A.k * 8;
  // at most 2 halves x GP_ROWS x GP_MAX_K values: 32 KiB, under the 48 KiB
  // a launch may take without asking
  const auto kernel = allbut ? ext_prod_kernel<true> : ext_prod_kernel<false>;
  kernel<<<(unsigned)((n + GP_ROWS - 1) / GP_ROWS), GP_ROWS, smem,
           (cudaStream_t)stream>>>(A, (uint64_t*)out, (uint32_t)n);
  return (int)cudaGetLastError();
}

}  // extern "C"
