// Poseidon2 width 12 over Goldilocks for Hopper (sm_90a): the Merkle leaf
// sponge, the Merkle levels of a subtree, the bare permutation, the
// transcript's duplex and the proof-of-work grind.
//
// Replaces the Pallas kernels in tpu_acir_prover/kernels/poseidon_pallas.py:
//   leaf_hash      <- _leaf_kernel / leaf_hash
//   merkle_levels  <- _two_to_one_kernel / two_to_one_level, several levels
//                     per launch (the subtree design that module's docstring
//                     names merkle_bulk)
//   permute        <- permute_tile (no pallas_call of its own there), on a
//                     batch of states
// and the JAX package's uses of that permutation in its fused prover,
// tpu_acir_prover/prover/fused.py:
//   duplex         <- GraphChallenger._duplex (absorb the buffered inputs,
//                     then permute one (12,) state)
//   grind          <- grind_graph (a lax.while_loop over batches of
//                     permute_tile) and ProvingKey.grind in
//                     tpu_acir_prover/prover/prove.py
//
// What bounds the batched kernels: 32-bit multiply-adds.  A permutation is
// 736 Goldilocks products (8 external rounds x 12 S-boxes x 4 for x^7, and
// 22 internal rounds x (4 + 12)), each a 64x64->128 product of four
// 32x32->64 partial products (8 32-bit multiply-adds), plus its reduction.
// The linear layers are adds.  Memory is far below that: a leaf row of C
// values is read once and 4 values are written.
//
// Design for that bound:
// - one thread owns one 12-lane state in registers; lane indices are
//   compile-time constants, round constants sit in __constant__ memory;
// - the 128-bit product is one PTX carry chain (mul.lo/hi, mad.lo.cc,
//   madc.hi.cc) and its reduction is branch-free (sub.cc/subc, add.cc/addc);
// - lane values stay in [0, 2^64), not canonical, between operations, and
//   are made canonical once, when a digest or a state is written;
// - the linear layers add in 96 bits (a 64-bit word and a 32-bit carry
//   count) and reduce each output once; the internal layer adds its 12-lane
//   sum into the 128-bit diagonal product before its one reduction;
// - leaf_hash stages each block's rows in shared memory, one rate chunk at
//   a time and double-buffered, with cp.async, so a warp's loads are runs of
//   contiguous words and the next chunk lands while the current one is
//   permuted.  The copies are 8 bytes: a row of odd width starts on an
//   8-byte boundary only;
// - merkle_levels hashes `levels` levels per launch: each block owns a run
//   of whole subtrees of 2^levels children (enough of them to give every
//   thread a parent at the first level), reads the run once from device
//   memory, keeps the levels above in shared memory (ping-pong buffers, a
//   barrier between levels) and writes every level to its own output;
// - a narrow level (a few thousand parents or fewer: too few warps to fill
//   the card) is bound by the latency of one permutation, not by issue.
//   There merkle_levels spreads each permutation over a quad of four
//   threads: thread q holds lanes q, 4 + q and 8 + q, so the circulant sum
//   of the external matrix is local, its M4 rows take the quad's four values
//   by shuffles, and the internal sum is a quad all-reduce.  A thread then
//   issues about 8k instructions per permutation instead of about 22k.
//
// The latency of one permutation: the S-box is x^3 * x^4, three products
// deep; in the quad and sixteen-thread layouts an internal round sums
// lanes 1..11 while lane 0's S-box runs, so its critical path is the S-box
// and the one diagonal product.
//
// duplex is one state: nothing to fill the card with, so it is bound by the
// latency of the dependent products on its critical path, 8 x 3 + 22 x
// (3 + 1) = 112 of them, not by throughput.  It spreads the permutation
// over sixteen threads of one warp, lane i on thread i (12..15 idle): M4's
// row and the circulant sum take their lanes by shuffles, the internal sum
// is a 16-lane shuffle all-reduce that runs beside lane 0's S-box.  A
// thread runs one S-box a round instead of twelve (a quad of four threads,
// three lanes each, measured slower inside a graph replay: PERF.md).  The
// buffered inputs are read by address inside the kernel (struct Inputs), so
// the absorb costs no launches of its own.
//
// grind is bound by multiply throughput and by the tail of its last wave:
// every nonce of a wave runs to its end, whether or not a smaller nonce
// hits.  Its grid is GRIND_BLOCKS_PER_SM blocks per SM, fewer than the SM
// keeps resident: a wave then covers fewer nonces past the first hit, each
// at a shorter latency.  It tries one nonce a thread for the first wave,
// then one nonce a quad, whose permutation has about a third of a thread's
// latency, so a hit just past the first wave costs a quad wave, not another
// thread wave (the grid and the one thread wave were chosen by a measured
// sweep at 16 bits: PERF.md).
// Warps stop together, once their next nonce is above the smallest hit so
// far, so every nonce below the final minimum has been tried: the result
// is the smallest hit, as in a scan of batches in order.
//
// The Goldilocks device functions (canon, gl_mul, the Acc sums and
// reduce96) are in goldilocks.cuh, shared with field.cu.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so the caller can raise.

#include <cstdint>
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int DIGEST = 4;
constexpr int EXTERNAL_ROUNDS = 8;
constexpr int INTERNAL_ROUNDS = 22;
constexpr int THREADS = 128;            // leaf_hash and permute blocks
constexpr int STAGE_STRIDE = RATE + 1;  // padded row of a staged chunk
constexpr int MAX_LEVELS = 3;           // merkle_levels: levels per launch
constexpr int LEVEL_THREADS = 256;      // one thread per parent
constexpr int QUAD_WARP_PARENTS = 8;    // four threads per parent: a warp
constexpr int GRIND_BLOCKS_PER_SM = 2;  // grind blocks of THREADS threads

__constant__ uint64_t c_ext[EXTERNAL_ROUNDS][WIDTH];
__constant__ uint64_t c_int[INTERNAL_ROUNDS];
__constant__ uint64_t c_dm1[WIDTH];
// M4's rows, for the quad permutation (thread q forms row q)
__constant__ uint32_t c_m4[4][4] = {{5, 7, 1, 3}, {4, 6, 1, 1}, {1, 3, 5, 7},
                                    {1, 1, 4, 6}};

// x^7 as x^3 * x^4: four products, three deep (x^2, then x^3 and x^4 side
// by side, then x^7), one fewer than the chain x^2, x^3, x^6, x^7.
__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  uint64_t x2 = gl_mul(x, x);
  uint64_t x3 = gl_mul(x2, x);
  uint64_t x4 = gl_mul(x2, x2);
  return gl_mul(x3, x4);
}

// M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] by the paper's add chain,
// in 96 bits (outputs < 16 * 2^64).
__device__ __forceinline__ void m4(const uint64_t* x, Acc* v) {
  Acc t0 = acc_add(acc(x[0]), acc(x[1]));
  Acc t1 = acc_add(acc(x[2]), acc(x[3]));
  Acc t2 = acc_add(acc_add(acc(x[1]), acc(x[1])), t1);
  Acc t3 = acc_add(acc_add(acc(x[3]), acc(x[3])), t0);
  Acc d1 = acc_add(t1, t1);
  Acc t4 = acc_add(acc_add(d1, d1), t3);
  Acc d0 = acc_add(t0, t0);
  Acc t5 = acc_add(acc_add(d0, d0), t2);
  v[0] = acc_add(t3, t5);
  v[1] = t5;
  v[2] = acc_add(t2, t4);
  v[3] = t4;
}

// M_E = circ(2*M4, M4, M4); outputs < 64 * 2^64 before their one reduction.
__device__ __forceinline__ void external_matrix(uint64_t s[WIDTH]) {
  Acc v[WIDTH];
#pragma unroll
  for (int a = 0; a < 3; ++a) m4(s + 4 * a, v + 4 * a);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    Acc tot = acc_add(acc_add(v[r], v[4 + r]), v[8 + r]);
    s[r] = reduce96(acc_add(v[r], tot));
    s[4 + r] = reduce96(acc_add(v[4 + r], tot));
    s[8 + r] = reduce96(acc_add(v[8 + r], tot));
  }
}

__device__ __forceinline__ void external_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = sbox(gl_add_rc(s[i], c_ext[r][i]));
  external_matrix(s);
}

// M_I = all-ones + diag(mu - 1): out_i = (mu_i - 1) * x_i + sum_j x_j, the
// sum kept in 96 bits (< 12 * 2^64) and added before the one reduction.
// (Summing lanes 1..11 before lane 0's S-box, as the latency-bound layouts
// below do, measured slower here: these kernels are bound by instruction
// throughput.)
__device__ __forceinline__ void internal_round(uint64_t s[WIDTH], int r) {
  s[0] = sbox(gl_add_rc(s[0], c_int[r]));
  Acc sum = acc(s[0]);
#pragma unroll
  for (int i = 1; i < WIDTH; ++i) sum = acc_add(sum, acc(s[i]));
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = gl_mul_add(s[i], c_dm1[i], sum);
}

// The rounds loop at run time (round constants indexed by a uniform
// counter) to keep the kernels' code small; lanes are unrolled.
__device__ __forceinline__ void permute(uint64_t s[WIDTH]) {
  external_matrix(s);
#pragma unroll 1
  for (int r = 0; r < EXTERNAL_ROUNDS / 2; ++r) external_round(s, r);
#pragma unroll 1
  for (int r = 0; r < INTERNAL_ROUNDS; ++r) internal_round(s, r);
#pragma unroll 1
  for (int r = EXTERNAL_ROUNDS / 2; r < EXTERNAL_ROUNDS; ++r)
    external_round(s, r);
}

// ---- one permutation on a quad of four threads (narrow Merkle levels) ----

struct Quad {
  unsigned mask;  // the warp's threads (all of a block smaller than a warp)
  int base;       // warp lane of the quad's thread 0
  int q;          // this thread's place in the quad
  uint32_t m4[4]; // row q of M4
  uint64_t dm1[3];  // mu - 1 of lanes q, 4 + q, 8 + q
};

__device__ __forceinline__ Quad make_quad() {
  Quad d;
  d.mask = blockDim.x >= 32 ? 0xFFFFFFFFu : (1u << blockDim.x) - 1;
  d.q = threadIdx.x & 3;
  d.base = (threadIdx.x & 31) & ~3;
#pragma unroll
  for (int j = 0; j < 4; ++j) d.m4[j] = c_m4[d.q][j];
#pragma unroll
  for (int a = 0; a < 3; ++a) d.dm1[a] = c_dm1[4 * a + d.q];
  return d;
}

// x[a] is lane 4a + q.  Row q of M4 on block a takes the block's four lanes
// from the quad; the circulant sum over blocks is this thread's own.
__device__ __forceinline__ void quad_external_matrix(uint64_t x[3],
                                                     const Quad& d) {
  Acc v[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    Acc t = acc(0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      t = acc_mad_small(t, __shfl_sync(d.mask, x[a], d.base + j), d.m4[j]);
    v[a] = t;
  }
  Acc tot = acc_add(acc_add(v[0], v[1]), v[2]);
#pragma unroll
  for (int a = 0; a < 3; ++a) x[a] = reduce96(acc_add(v[a], tot));
}

__device__ __forceinline__ void quad_external_round(uint64_t x[3],
                                                    const Quad& d, int r) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    x[a] = sbox(gl_add_rc(x[a], c_ext[r][4 * a + d.q]));
  quad_external_matrix(x, d);
}

__device__ __forceinline__ Acc shfl_xor_acc(Acc s, int m, unsigned mask) {
  return Acc{__shfl_xor_sync(mask, s.lo, m), __shfl_xor_sync(mask, s.hi, m)};
}

// Every thread runs the S-box (thread 0's, on lane 0, is the one kept: in
// a warp the others would idle through it anyway) while the quad sums
// lanes 1..11; lane 0 is then broadcast and added in.
__device__ __forceinline__ void quad_internal_round(uint64_t x[3],
                                                    const Quad& d, int r) {
  const uint64_t t = sbox(gl_add_rc(x[0], c_int[r]));
  Acc rest = acc_add(acc_add(acc(d.q == 0 ? 0 : x[0]), acc(x[1])), acc(x[2]));
  rest = acc_add(rest, shfl_xor_acc(rest, 1, d.mask));
  rest = acc_add(rest, shfl_xor_acc(rest, 2, d.mask));
  const Acc sum = acc_add(rest, acc(__shfl_sync(d.mask, t, d.base)));
  if (d.q == 0) x[0] = t;
#pragma unroll
  for (int a = 0; a < 3; ++a) x[a] = gl_mul_add(x[a], d.dm1[a], sum);
}

__device__ __forceinline__ void permute_quad(uint64_t x[3], const Quad& d) {
  quad_external_matrix(x, d);
#pragma unroll 1
  for (int r = 0; r < EXTERNAL_ROUNDS / 2; ++r) quad_external_round(x, d, r);
#pragma unroll 1
  for (int r = 0; r < INTERNAL_ROUNDS; ++r) quad_internal_round(x, d, r);
#pragma unroll 1
  for (int r = EXTERNAL_ROUNDS / 2; r < EXTERNAL_ROUNDS; ++r)
    quad_external_round(x, d, r);
}

// ---- one permutation on sixteen threads, one lane each (the duplex) ----

struct Lane {
  unsigned mask;   // the block's sixteen threads
  int i;           // this thread's lane; 12..15 carry values nobody reads
  int row;         // i mod 4: its row of M4
  int base;        // the first lane of its block of four
  int col;         // its column of the external round constants
  uint32_t m4[4];  // row `row` of M4
  uint64_t dm1;    // mu_i - 1 (0 past lane 11)
};

__device__ __forceinline__ Lane make_lane() {
  Lane d;
  d.mask = 0xFFFFu;
  d.i = threadIdx.x & 15;
  d.row = d.i & 3;
  d.base = d.i & ~3;
  d.col = min(d.i, WIDTH - 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) d.m4[j] = c_m4[d.row][j];
  d.dm1 = d.i < WIDTH ? c_dm1[d.i] : 0;
  return d;
}

__device__ __forceinline__ Acc shfl_acc(Acc s, int src, unsigned mask) {
  return Acc{__shfl_sync(mask, s.lo, src), __shfl_sync(mask, s.hi, src)};
}

// Row `row` of M4 on the lane's block takes the block's four lanes; the
// circulant sum takes that row from each of the three blocks.
__device__ __forceinline__ void lane_external_matrix(uint64_t& x,
                                                     const Lane& d) {
  Acc v = acc(0);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v = acc_mad_small(v, __shfl_sync(d.mask, x, d.base + j), d.m4[j]);
  const Acc tot = acc_add(acc_add(shfl_acc(v, d.row, d.mask),
                                  shfl_acc(v, 4 + d.row, d.mask)),
                          shfl_acc(v, 8 + d.row, d.mask));
  x = reduce96(acc_add(v, tot));
}

__device__ __forceinline__ void lane_external_round(uint64_t& x,
                                                    const Lane& d, int r) {
  x = sbox(gl_add_rc(x, c_ext[r][d.col]));
  lane_external_matrix(x, d);
}

// Every lane runs the S-box (lane 0's is the one kept) while the sixteen
// threads sum lanes 1..11 by shuffles; lane 0 is then broadcast, so the
// critical path is the S-box and one product: four products a round.
__device__ __forceinline__ void lane_internal_round(uint64_t& x,
                                                    const Lane& d, int r) {
  const uint64_t t = sbox(gl_add_rc(x, c_int[r]));
  Acc rest = acc(d.i >= 1 && d.i < WIDTH ? x : 0);
#pragma unroll
  for (int m = 1; m < 16; m <<= 1)
    rest = acc_add(rest, shfl_xor_acc(rest, m, d.mask));
  const Acc sum = acc_add(rest, acc(__shfl_sync(d.mask, t, 0)));
  x = gl_mul_add(d.i == 0 ? t : x, d.dm1, sum);
}

__device__ __forceinline__ void permute_lanes(uint64_t& x, const Lane& d) {
  lane_external_matrix(x, d);
#pragma unroll 1
  for (int r = 0; r < EXTERNAL_ROUNDS / 2; ++r) lane_external_round(x, d, r);
#pragma unroll 1
  for (int r = 0; r < INTERNAL_ROUNDS; ++r) lane_internal_round(x, d, r);
#pragma unroll 1
  for (int r = EXTERNAL_ROUNDS / 2; r < EXTERNAL_ROUNDS; ++r)
    lane_external_round(x, d, r);
}

// The sponge inputs buffered since the last duplex, by address: views into
// caps, openings, final coefficients or the nonce.  Under a CUDA graph the
// addresses are fixed at capture; every input lives in the graph's own
// pool (or in the proving key, which holds the graph), as the other
// kernels' operands do, so they stay valid for every replay.
struct Inputs {
  const uint64_t* p[RATE];
};

// Lane j of the state with the k inputs written over lanes 0..k-1.
__device__ __forceinline__ uint64_t absorbed(const uint64_t* state,
                                             const Inputs& in, int k, int j) {
  uint64_t v = state[j];
#pragma unroll
  for (int i = 0; i < RATE; ++i)
    if (i == j && i < k) v = *in.p[i];
  return v;
}

__device__ __forceinline__ void cp_async8(uint64_t* smem, const uint64_t* gmem) {
  unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Starts the copy of columns [off, off + k) of the block's rows into buf;
// a warp's 32 copies are runs of k contiguous words.
__device__ __forceinline__ void stage_chunk(uint64_t* buf,
                                            const uint64_t* __restrict__ in,
                                            int64_t row0, int64_t rows,
                                            int cols, int off, int k) {
  for (int e = threadIdx.x; e < THREADS * k; e += THREADS) {
    int r = e / k;
    int j = e - r * k;
    if (row0 + r < rows)
      cp_async8(&buf[r * STAGE_STRIDE + j], in + (row0 + r) * cols + off + j);
  }
  cp_async_commit();
}

// (rows, cols) row-major -> (rows, 4): overwrite-mode sponge, no padding.
// The rows reach the threads through shared memory.
__global__ void __launch_bounds__(THREADS)
leaf_hash_kernel(const uint64_t* __restrict__ in, int64_t rows, int cols,
                 uint64_t* __restrict__ out) {
  __shared__ uint64_t buf[2][THREADS * STAGE_STRIDE];
  const int64_t row0 = (int64_t)blockIdx.x * THREADS;
  const int64_t row = row0 + threadIdx.x;
  uint64_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = 0;
  const int nchunks = (cols + RATE - 1) / RATE;
  stage_chunk(buf[0], in, row0, rows, cols, 0, min(RATE, cols));
  for (int c = 0; c < nchunks; ++c) {
    const int off = c * RATE;
    const int k = min(RATE, cols - off);
    // chunk c has landed for every thread, and every thread is done with
    // the buffer that chunk c + 1 goes into
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < nchunks)
      stage_chunk(buf[(c + 1) & 1], in, row0, rows, cols, off + RATE,
                  min(RATE, cols - off - RATE));
    const uint64_t* src = &buf[c & 1][threadIdx.x * STAGE_STRIDE];
#pragma unroll
    for (int j = 0; j < RATE; ++j)
      if (j < k) s[j] = src[j];
    permute(s);
  }
  if (row < rows) {
#pragma unroll
    for (int j = 0; j < DIGEST; ++j) out[row * DIGEST + j] = canon(s[j]);
  }
}

struct LevelOutputs {
  uint64_t* level[MAX_LEVELS];
};

// Compresses the digests at in[8p .. 8p + 8) (children 2p, 2p + 1) and
// writes the parent to out_global[g] and, when out_shared is set, to
// out_shared[p].
__device__ __forceinline__ void compress_pair(const uint64_t* in, int p,
                                              int64_t g, uint64_t* out_global,
                                              uint64_t* out_shared) {
  uint64_t s[WIDTH];
  const ulonglong2* src = reinterpret_cast<const ulonglong2*>(in + 8 * (int64_t)p);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ulonglong2 v = src[q];
    s[2 * q] = v.x;
    s[2 * q + 1] = v.y;
  }
#pragma unroll
  for (int j = 2 * DIGEST; j < WIDTH; ++j) s[j] = 0;
  permute(s);
#pragma unroll
  for (int j = 0; j < DIGEST; ++j) {
    uint64_t d = canon(s[j]);
    out_global[g * DIGEST + j] = d;
    if (out_shared) out_shared[p * DIGEST + j] = d;
  }
}

// The np parents of a level on quads: quad k takes parents k, k + nquads,
// ...  Every quad runs every round, an idle one on zeros, so that the
// shuffles see whole warps.
__device__ __forceinline__ void compress_level_quad(const uint64_t* in, int np,
                                                    int64_t g0,
                                                    uint64_t* out_global,
                                                    uint64_t* out_shared) {
  const Quad d = make_quad();
  const int nquads = blockDim.x >> 2;
  for (int p0 = 0; p0 < np; p0 += nquads) {
    const int p = p0 + (threadIdx.x >> 2);
    const bool active = p < np;
    uint64_t x[3];
    x[0] = active ? in[8 * (int64_t)p + d.q] : 0;      // child 2p
    x[1] = active ? in[8 * (int64_t)p + 4 + d.q] : 0;  // child 2p + 1
    x[2] = 0;
    permute_quad(x, d);
    if (active) {
      const uint64_t v = canon(x[0]);
      out_global[(g0 + p) * DIGEST + d.q] = v;
      if (out_shared) out_shared[p * DIGEST + d.q] = v;
    }
  }
}

// `levels` Merkle levels above a child level: block b owns children
// [b * 2^span, (b + 1) * 2^span), span >= levels, and writes their
// 2^(span - l) parents at level l to out.level[l - 1].  Level 1 reads the
// children from device memory; level l > 1 reads level l - 1 from shared
// memory.  kQuad hashes each parent on a quad of threads.
template <bool kQuad>
__global__ void __launch_bounds__(kQuad ? 4 * QUAD_WARP_PARENTS : LEVEL_THREADS)
merkle_levels_kernel(const uint64_t* __restrict__ child, int levels, int span,
                     LevelOutputs out) {
  extern __shared__ __align__(16) uint64_t smem[];
  // level l is kept in buf[(l - 1) & 1]: 2^(span-1) and 2^(span-2) digests
  uint64_t* buf[2] = {smem, smem + ((int64_t)DIGEST << (span - 1))};
  const uint64_t* run = child + ((int64_t)blockIdx.x << span) * DIGEST;
  for (int l = 1; l <= levels; ++l) {
    if (l > 1) __syncthreads();
    const int np = 1 << (span - l);
    const uint64_t* in = l == 1 ? run : buf[l & 1];
    uint64_t* keep = l < levels ? buf[(l - 1) & 1] : nullptr;
    const int64_t g0 = (int64_t)blockIdx.x << (span - l);
    if (kQuad)
      compress_level_quad(in, np, g0, out.level[l - 1], keep);
    else
      for (int p = threadIdx.x; p < np; p += blockDim.x)
        compress_pair(in, p, g0 + p, out.level[l - 1], keep);
  }
}

// (b, 12) -> (b, 12).
__global__ void __launch_bounds__(THREADS)
permute_kernel(const uint64_t* __restrict__ in, int64_t b,
               uint64_t* __restrict__ out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = in[i * WIDTH + j];
  permute(s);
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) out[i * WIDTH + j] = canon(s[j]);
}

// One duplex of the transcript's (12,) state: lanes 0..k-1 take the k
// inputs, then the state is permuted into out.  One block of sixteen
// threads, one lane each.
__global__ void __launch_bounds__(16)
duplex_kernel(const uint64_t* __restrict__ state, Inputs in, int k,
              uint64_t* __restrict__ out) {
  const Lane d = make_lane();
  uint64_t x = d.i < WIDTH ? absorbed(state, in, k, d.i) : 0;
  permute_lanes(x, d);
  if (d.i < WIDTH) out[d.i] = canon(x);
}

constexpr unsigned long long NONCES = 1ull << 32;
constexpr unsigned FULL_WARP = 0xFFFFFFFFu;

// True when every nonce from n on is above the smallest hit so far, for
// the whole warp at once (lane 0 reads, the warp follows).  A stale read
// only delays the stop: the minimum never grows.
__device__ __forceinline__ bool warp_past(uint64_t n,
                                          const unsigned long long* best) {
  unsigned long long b =
      (threadIdx.x & 31) == 0 ? *(const volatile unsigned long long*)best : 0;
  return n > __shfl_sync(FULL_WARP, b, 0);
}

// Nonce search from the (12,) state with the k inputs absorbed: lane
// `lane` takes the nonce; a nonce hits when lane RATE - 1 of the permuted
// state is below `bound`.  *best starts at 2^32 (no hit) and ends at the
// smallest hit.  Thread t of the T threads of the grid first tries nonce
// t; from T on each quad of four threads takes one nonce, warp w the eight
// at T + 8w, then 8 * T / 32 further on, and so on.  A warp stops once its
// smallest next nonce is above the smallest hit, so every nonce below the
// final minimum has been tried: the result is the smallest hit, as in a
// scan in order.
__global__ void __launch_bounds__(THREADS)
grind_kernel(const uint64_t* __restrict__ state, Inputs in, int k, int lane,
             uint64_t bound, unsigned long long* best) {
  const uint64_t T = (uint64_t)gridDim.x * blockDim.x;
  const uint64_t tid = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (warp_past(tid - (threadIdx.x & 31), best)) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; ++j)
    s[j] = j == lane ? tid : absorbed(state, in, k, j);
  permute(s);
  if (canon(s[RATE - 1]) < bound) atomicMin(best, (unsigned long long)tid);
  const Quad d = make_quad();
  uint64_t x0[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) x0[a] = absorbed(state, in, k, 4 * a + d.q);
  const int wl = threadIdx.x & 31;
  for (uint64_t n0 = T + 8 * (tid >> 5); n0 < NONCES; n0 += 8 * (T >> 5)) {
    if (warp_past(n0, best)) return;
    const uint64_t n = n0 + (wl >> 2);
    uint64_t x[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = 4 * a + d.q == lane ? n : x0[a];
    permute_quad(x, d);
    // lane RATE - 1 = 4 + 3 is x[1] of the quad's thread 3
    if (d.q == 3 && canon(x[1]) < bound)
      atomicMin(best, (unsigned long long)n);
  }
}

// n dependent products on one thread: (n1 - n0) / (t1 - t0) of two launches
// is the latency of one gl_mul on the card (kernels/bench.py).
__global__ void mul_chain_kernel(uint64_t x, int n, uint64_t* out) {
#pragma unroll 16
  for (int i = 0; i < n; ++i) x = gl_mul(x, x);
  *out = canon(x);
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

// Host arrays: ext (8, 12), internal (22,), diag - 1 (12,), all u64.
int p2_set_constants(const void* ext, const void* internal, const void* dm1) {
  cudaError_t e = cudaMemcpyToSymbol(c_ext, ext, sizeof(c_ext));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_int, internal, sizeof(c_int));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_dm1, dm1, sizeof(c_dm1));
  return (int)e;
}

const char* p2_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

int p2_leaf_hash(const void* in, int64_t rows, int cols, void* out,
                 void* stream) {
  if (rows > 0 && cols > 0)
    leaf_hash_kernel<<<blocks_for(rows), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, rows, cols, (uint64_t*)out);
  return (int)cudaGetLastError();
}

// child: (n_child, 4); outs[l - 1]: (n_child >> l, 4) for l = 1..levels.
// n_child must be a multiple of 2^levels, child 16-byte aligned.  quad != 0
// hashes each parent on four threads, in blocks of at most a warp; else
// blocks have at most LEVEL_THREADS threads.
int p2_merkle_levels(const void* child, int64_t n_child, int levels,
                     void* const* outs, int quad, void* stream) {
  if (levels < 1 || levels > MAX_LEVELS || n_child % (1ll << levels) != 0)
    return (int)cudaErrorInvalidValue;
  LevelOutputs o;
  for (int l = 0; l < MAX_LEVELS; ++l)
    o.level[l] = l < levels ? (uint64_t*)outs[l] : nullptr;
  // widen a block's run of subtrees until each thread has a first-level
  // parent, as far as the child count allows
  const int want = quad ? QUAD_WARP_PARENTS : LEVEL_THREADS;
  int span = levels;
  while ((1 << (span - 1)) < want && n_child % (2ll << span) == 0) ++span;
  const int64_t blocks = n_child >> span;
  const int parents = min(want, 1 << (span - 1));
  const size_t smem = ((size_t)3 << span) * sizeof(uint64_t);
  if (blocks > 0 && quad)
    merkle_levels_kernel<true><<<(unsigned)blocks, 4 * parents, smem,
                                 (cudaStream_t)stream>>>(
        (const uint64_t*)child, levels, span, o);
  else if (blocks > 0)
    merkle_levels_kernel<false><<<(unsigned)blocks, parents, smem,
                                  (cudaStream_t)stream>>>(
        (const uint64_t*)child, levels, span, o);
  return (int)cudaGetLastError();
}

int p2_permute(const void* in, int64_t b, void* out, void* stream) {
  if (b > 0)
    permute_kernel<<<blocks_for(b), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, b, (uint64_t*)out);
  return (int)cudaGetLastError();
}

// state: (12,) on the device; inputs: k <= 8 device addresses of one u64
// each; out: (12,) on the device, apart from both.
int p2_duplex(const void* state, const void* const* inputs, int k, void* out,
              void* stream) {
  if (k < 0 || k > RATE) return (int)cudaErrorInvalidValue;
  Inputs in;
  for (int i = 0; i < RATE; ++i)
    in.p[i] = i < k ? (const uint64_t*)inputs[i] : nullptr;
  duplex_kernel<<<1, 16, 0, (cudaStream_t)stream>>>((const uint64_t*)state,
                                                     in, k, (uint64_t*)out);
  return (int)cudaGetLastError();
}

// state: (12,) on the device; inputs: k <= lane device addresses of one u64
// each, written over lanes 0..k-1; best: one u64 on the device, set to
// 2^32 by the caller (the launch keeps no state between calls).  The grid
// is GRIND_BLOCKS_PER_SM blocks on every SM of the current device.
int p2_grind(const void* state, const void* const* inputs, int k, int lane,
             uint64_t bound, void* best, void* stream) {
  if (lane < 0 || lane >= RATE || k < 0 || k > lane)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  Inputs in;
  for (int i = 0; i < RATE; ++i)
    in.p[i] = i < k ? (const uint64_t*)inputs[i] : nullptr;
  grind_kernel<<<(unsigned)(GRIND_BLOCKS_PER_SM * sms), THREADS, 0,
                 (cudaStream_t)stream>>>((const uint64_t*)state, in, k, lane,
                                         bound, (unsigned long long*)best);
  return (int)cudaGetLastError();
}

// out: one u64 on the device.
int p2_mul_chain(uint64_t x, int n, void* out, void* stream) {
  mul_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(x, n, (uint64_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
