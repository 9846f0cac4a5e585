/* Native witness-generation core: generator scheduling + execution.
 *
 * Role analog: the reference's witness generation runs inside the Rust
 * plonky2 fork as a dynamic SimpleGenerator fixpoint during
 * `circuit_data.prove` (reference: actions/prove_action.rs:91-97); its
 * performance comes from compiled Rust + rayon.  Here the circuit
 * compiler schedules generators statically and this C core provides
 *   (1) the topological-level fixpoint over millions of generator ops
 *       (gl_schedule), and
 *   (2) sequential execution of level-ordered generator ops with native
 *       Goldilocks arithmetic (gl_run_ops),
 * leaving only custom hint callbacks (256-bit certificate math) to
 * Python.  Built as a plain shared library, loaded with ctypes — no
 * Python.h dependency (pybind11 is not available in this environment).
 *
 * Field: Goldilocks p = 2^64 - 2^32 + 1.  Reduction of a 128-bit product
 * uses 2^64 === 2^32 - 1 (mod p), the standard Goldilocks identity.
 */

#include <stdint.h>
#include <stddef.h>

typedef uint64_t u64;
typedef __uint128_t u128;

static const u64 P = 0xFFFFFFFF00000001ULL;
static const u64 NEG_ORDER = 0xFFFFFFFFULL; /* 2^64 mod p */

/* generator opcodes — must match circuit/builder.py */
enum {
    GEN_EXTERNAL = 0,
    GEN_CONST = 1,
    GEN_ADD = 2,
    GEN_SUB = 3,
    GEN_MUL = 4,
    GEN_MULADDC = 5,
    GEN_INV = 6,
    GEN_BIT = 7,
    GEN_HINT_OUT = 8,
    GEN_MULMULC = 9,
};

static inline u64 gl_add(u64 x, u64 y)
{
    u64 s = x + y;
    if (s < x) { /* wrapped past 2^64: add 2^64 mod p */
        s += NEG_ORDER;
    }
    if (s >= P)
        s -= P;
    return s;
}

static inline u64 gl_sub(u64 x, u64 y)
{
    return (x >= y) ? (x - y) : (x + P - y);
}

static inline u64 gl_reduce128(u128 v)
{
    u64 lo = (u64)v;
    u64 hi = (u64)(v >> 64);
    u64 hi_hi = hi >> 32;
    u64 hi_lo = hi & 0xFFFFFFFFULL;
    u64 t0 = lo - hi_hi;
    if (lo < hi_hi)
        t0 -= NEG_ORDER; /* wrapping correction */
    u64 t1 = hi_lo * NEG_ORDER;
    u64 t2 = t0 + t1;
    if (t2 < t1)
        t2 += NEG_ORDER;
    if (t2 >= P)
        t2 -= P;
    return t2;
}

static inline u64 gl_mul(u64 x, u64 y)
{
    return gl_reduce128((u128)x * (u128)y);
}

static u64 gl_pow(u64 x, u64 e)
{
    u64 acc = 1;
    while (e) {
        if (e & 1)
            acc = gl_mul(acc, x);
        x = gl_mul(x, x);
        e >>= 1;
    }
    return acc;
}

static inline u64 gl_inv(u64 x)
{
    return x ? gl_pow(x, P - 2) : 0; /* 0 -> 0, like the INV generator */
}

/* Topological level assignment: iterate to a fixpoint (ops are appended
 * mostly in dependency order, so this converges in a handful of passes).
 * hint_in_off/hint_in: CSR of hint-input variable ids per hint id (the
 * `a` field of a GEN_HINT_OUT op is its hint id).
 * Returns the number of passes, or -1 if it failed to converge. */
long gl_schedule(long n_ops,
                 const int32_t *op,
                 const int64_t *out,
                 const int64_t *a,
                 const int64_t *b,
                 const int64_t *hint_in_off,
                 const int64_t *hint_in,
                 int64_t n_vars,
                 int64_t *level)
{
    for (int64_t i = 0; i < n_vars; i++)
        level[i] = 0;
    long passes = 0;
    for (;;) {
        int changed = 0;
        passes++;
        if (passes > n_ops + 2)
            return -1; /* dependency cycle */
        for (long i = 0; i < n_ops; i++) {
            int k = op[i];
            int64_t lv = 0;
            switch (k) {
            case GEN_CONST:
            case GEN_EXTERNAL:
                break;
            case GEN_ADD:
            case GEN_SUB:
            case GEN_MUL:
            case GEN_MULADDC:
            case GEN_MULMULC: {
                int64_t la = level[a[i]] + 1;
                int64_t lb = level[b[i]] + 1;
                lv = la > lb ? la : lb;
                break;
            }
            case GEN_INV:
            case GEN_BIT:
                lv = level[a[i]] + 1;
                break;
            case GEN_HINT_OUT: {
                int64_t h = a[i];
                for (int64_t j = hint_in_off[h]; j < hint_in_off[h + 1]; j++) {
                    int64_t l2 = level[hint_in[j]] + 1;
                    if (l2 > lv)
                        lv = l2;
                }
                break;
            }
            default:
                return -2; /* unknown opcode */
            }
            if (lv != level[out[i]]) {
                level[out[i]] = lv;
                changed = 1;
            }
        }
        if (!changed)
            return passes;
    }
}

/* Execute ops[order[start..end)] sequentially over the value array.
 * Skips GEN_EXTERNAL and GEN_HINT_OUT (handled by the Python caller).
 * Returns 0 on success, -1 on unknown opcode. */
long gl_run_ops(long start, long end,
                const int64_t *order,
                const int32_t *op,
                const int64_t *out,
                const int64_t *a,
                const int64_t *b,
                const u64 *cst,
                u64 *vals)
{
    for (long t = start; t < end; t++) {
        long i = order[t];
        int k = op[i];
        u64 r;
        switch (k) {
        case GEN_EXTERNAL:
        case GEN_HINT_OUT:
            continue;
        case GEN_CONST:
            r = cst[i];
            break;
        case GEN_ADD:
            r = gl_add(vals[a[i]], vals[b[i]]);
            break;
        case GEN_SUB:
            r = gl_sub(vals[a[i]], vals[b[i]]);
            break;
        case GEN_MUL:
            r = gl_mul(vals[a[i]], vals[b[i]]);
            break;
        case GEN_MULADDC:
            r = gl_add(gl_mul(vals[a[i]], cst[i]), vals[b[i]]);
            break;
        case GEN_MULMULC:
            r = gl_mul(gl_mul(vals[a[i]], vals[b[i]]), cst[i]);
            break;
        case GEN_INV:
            r = gl_inv(vals[a[i]]);
            break;
        case GEN_BIT:
            r = (vals[a[i]] >> cst[i]) & 1ULL;
            break;
        default:
            return -1;
        }
        vals[out[i]] = r;
    }
    return 0;
}

/* Gate-constraint sweep (the check_constraints debug path): evaluates
 * sum_j qM_j w_2j w_2j+1 + sum_i q_i w_i + qC per row and returns the
 * first violated row, or -1 if all satisfied.  selectors: row-major
 * (n_sel, n); wире values: (W, n). pi adjustments are applied by the
 * caller beforehand via the `pi` vector (0 where none). */
long gl_check_rows(int64_t n, int64_t W,
                   const u64 *selectors, /* (npair+W+2, n) row-major */
                   const u64 *wires,     /* (W, n) row-major */
                   const u64 *pi,        /* (n,) value to subtract per row */
                   int64_t npair)
{
    for (int64_t r = 0; r < n; r++) {
        u64 acc = 0;
        for (int64_t j = 0; j < npair; j++) {
            u64 t = gl_mul(selectors[j * n + r],
                           gl_mul(wires[(2 * j) * n + r],
                                  wires[(2 * j + 1) * n + r]));
            acc = gl_add(acc, t);
        }
        for (int64_t i = 0; i < W; i++) {
            acc = gl_add(acc, gl_mul(selectors[(npair + i) * n + r],
                                     wires[i * n + r]));
        }
        acc = gl_add(acc, selectors[(npair + W) * n + r]); /* qC */
        acc = gl_sub(acc, pi[r]);
        if (acc != 0)
            return r;
    }
    return -1;
}
