"""Per-phase prover on torch tensors: compiled circuit + witness -> proof.

Counterpart of ``ProvingKey`` and ``prove`` in
``tpu_acir_prover/prover/prove.py``; the proof relation (gate, permutation
with partial products, LogUp lookups, quotient in NUM_CHUNKS chunks) is
described in that module's docstring.  The Fiat-Shamir transcript, proof
containers and verifier are the port's copies of the JAX package's host
modules, so the port must give the same proof bytes.

Plain torch ops everywhere except Poseidon2, which goes through the
wrappers in ``kernels/poseidon.py`` (Merkle leaves and levels, the
proof-of-work grind).  Field ops are exact, so products and sums are
taken in whatever order is simplest: values do not depend on it.

Each phase is a ``*_body`` function on device tensors whose challenges are
ext scalars held on the device (pairs of 0-d tensors); it makes no host
read and copies nothing from the host, so the fused prover
(``prover/fused.py``) runs the same bodies inside one CUDA graph.  The
``ProvingKey`` methods of the same names are the per-phase prover's thin
callers: python-int challenges in, device tensors or python ints out.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..circuit.builder import (NUM_SELECTORS, SEL_QLK, lookup_groups,
                               perm_groups)
from ..circuit.compile import CompiledCircuit, powers_u64
from ..field import ext as E
from ..field import gl
from ..field.ext import e_mul
from ..field.gl import MULTIPLICATIVE_GENERATOR, P, root_of_unity, s_inv
from ..kernels import poseidon as kp
from ..utils.timing import PhaseTimer
from .challenger import Challenger
from .config import ProofConfig, STANDARD_CONFIG
from .fri import _HALF, _mul_u64
from .merkle import MerkleTree, merkle_tree
from .ntt import coset_intt, coset_lde, intt
from .proof import (FriStep, Openings, OracleOpening, Proof, QueryRound,
                    VerifyingKey)

NUM_CHUNKS = 6  # quotient degree < 6n for constraint degree <= 7 at rate 8
# LDE rows per quotient evaluation step; bounds the step's temporaries
QUOTIENT_CHUNK = 1 << 18
# most elements of an (m, C) LDE matrix one pass of a commit's NTTs, or of
# the FRI combination, works on (a block of columns); bounds their
# temporaries: 8 columns at 2^23 rows, every column at once up to 2^20
COMMIT_BLOCK = 1 << 26


def resolve_device(device) -> torch.device:
    """The torch device to prove on; raises if it is CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is false")
    return dev


@dataclass
class Oracle:
    """A committed polynomial batch: coeffs + LDE values + Merkle tree."""
    coeffs: torch.Tensor   # (n, C)
    lde: torch.Tensor      # (m, C)
    tree: MerkleTree


# ---------------------------------------------------------------------------
# helpers on ext values ((re, im) tensor pairs)


def _col(mat, i):
    """Ext column i of an interleaved (rows, 2 * Cext) base matrix."""
    return (mat[:, 2 * i], mat[:, 2 * i + 1])


def _ecol(t, i):
    """Column i of an ext pair of (rows, k) tensors."""
    return (t[0][:, i], t[1][:, i])


def _fold(op, items):
    """Balanced fold of a non-empty list with an associative op."""
    items = list(items)
    while len(items) > 1:
        items = [op(items[i], items[i + 1]) if i + 1 < len(items)
                 else items[i] for i in range(0, len(items), 2)]
    return items[0]


def _prefix(op, x, fill):
    """Inclusive Hillis-Steele scan of an (n,) ext vector; ``fill`` is the
    op's neutral as a python-int pair."""
    n = x[0].shape[0]
    acc = x
    d = 1
    while d < n:
        sh = tuple(torch.cat([torch.full((d,), gl.s64(f), dtype=torch.int64,
                                         device=c.device), c[:-d]])
                   for c, f in zip(acc, fill))
        acc = op(acc, sh)
        d *= 2
    return acc


def _shift_one(x, fill):
    """Exclusive form of an inclusive scan: prepend ``fill``, drop last."""
    return tuple(torch.cat([torch.full((1,), f, dtype=torch.int64,
                                       device=c.device), c[:-1]])
                 for c, f in zip(x, fill))


def column_blocks(rows: int, cols: int):
    """Slices of the columns of a (rows, cols) matrix, each block of at
    most COMMIT_BLOCK elements (one column at least)."""
    step = max(1, COMMIT_BLOCK // rows)
    return [slice(c, min(c + step, cols)) for c in range(0, cols, step)]


def exclusive_scan(op, x, fill):
    """Exclusive scan of an (n,) ext vector; ``fill`` is the op's neutral
    as a python-int pair."""
    return _shift_one(_prefix(op, x, fill), fill)


def gate_eval(q, w):
    """sum_j qM_j*w_{2j}*w_{2j+1} + sum_i q_i*w_i + qC on (rows, *) tensors;
    q holds the NUM_SELECTORS selector columns, w the W wire columns."""
    W = w.shape[1]
    npair = W // 2
    pair = gl.mul(w[:, 0::2], w[:, 1::2])
    t1 = gl.sum_axis(gl.mul(q[:, :npair], pair), 1)
    t2 = gl.sum_axis(gl.mul(q[:, npair:npair + W], w), 1)
    return gl.add(gl.add(t1, t2), q[:, npair + W])


def perm_group_products(wires, sigmas, x, k, beta, gamma, groups):
    """Per-group products (N_g, D_g) of the permutation factors
    (w_i + beta k_i x + gamma) and (w_i + beta sigma_i + gamma), as lists of
    (rows,) ext values: one grouped product a factor matrix."""
    kx = gl.mul(x[:, None], k[None, :])

    def factors(second):
        return (gl.add(gl.add(wires, gl.mul(beta[0], second)), gamma[0]),
                gl.add(gl.mul(beta[1], second), gamma[1]))

    f_num, f_den = factors(kx), factors(sigmas)
    return E.group_prod(f_num, groups), E.group_prod(f_den, groups)


def lookup_factors(wires, lam):
    """(lam - w_i) for all wires as an ext pair of (rows, W) tensors."""
    return (gl.sub(lam[0], wires), lam[1].expand(wires.shape))


def round2_factors(pk, wires, beta, gamma, lam):
    """The row-local half of round 2, before its two scans: the step ratio
    of Z, the per-group products, and with lookups the helpers h_g, h_T and
    the running sum's step delta (else ``None`` for those three).  wires:
    (rows, W [+1]), multiplicity column last; lam is None without
    lookups."""
    W = pk.W
    w = wires[:, :W]
    nums, dens = perm_group_products(w, pk.sigma, pk.x_h, pk.k,
                                     beta, gamma, pk.perm_groups)
    ratio = E.mul(_fold(E.mul, nums), E.inv(_fold(E.mul, dens)))
    if not pk.has_lookups:
        return ratio, nums, dens, None, None, None
    invs = E.inv(lookup_factors(w, lam))
    hs = [E.mul_base(_fold(E.add, [_ecol(invs, i) for i in range(s, e)]),
                     pk.qlk)
          for s, e in pk.lk_groups]
    h_t = E.inv((gl.sub(lam[0], pk.table), lam[1].expand(pk.table.shape)))
    delta = E.sub(_fold(E.add, hs), E.mul_base(h_t, wires[:, W]))
    return ratio, nums, dens, hs, h_t, delta


def round2_columns(pk, z, nums, dens, hs, h_t, s_run):
    """Z, the partial products B_j and (with lookups) h_g, h_T and the
    running sum S as a (rows, 2 * num_z_ext) interleaved base matrix, from
    the exclusive scans z and s_run and ``round2_factors``' values."""
    ecols = [z]
    cn, cd = nums[0], dens[0]
    for t in range(pk.K - 1):
        if t:
            cn, cd = E.mul(cn, nums[t]), E.mul(cd, dens[t])
        ecols.append(E.mul(z, E.mul(cn, E.inv(cd))))
    if pk.has_lookups:
        ecols += hs + [h_t, s_run]
    return torch.stack([c for e in ecols for c in e], dim=1)


def round2_body(pk, wires, beta, gamma, lam):
    """Round 2 on all n rows: the factors, the exclusive scans for Z and S,
    then the columns (n, 2 * num_z_ext)."""
    ratio, nums, dens, hs, h_t, delta = round2_factors(pk, wires, beta,
                                                       gamma, lam)
    z = exclusive_scan(E.mul, ratio, (1, 0))
    s_run = exclusive_scan(E.add, delta, (0, 0)) if pk.has_lookups else None
    return round2_columns(pk, z, nums, dens, hs, h_t, s_run)


def quotient_body(pk, wires_lde, z_lde, pub, beta, gamma, lam, alpha):
    """Quotient coefficient columns (n, 2 * NUM_CHUNKS): the constraints
    combined by powers of alpha over the LDE in row chunks of
    QUOTIENT_CHUNK, times Z_H^-1, then a coset INTT.  pub: the (npub,)
    public inputs; lam is None without lookups."""
    n, m = pk.n, pk.m
    alphas = E.powers_table(alpha, pk.num_constraints)
    pi = torch.cat([gl.neg(pub), torch.zeros(n - pub.shape[0],
                                             dtype=torch.int64,
                                             device=pub.device)])
    pi_lde = coset_lde(intt(pi.reshape(n, 1)), pk.config.rate_bits)[:, 0]
    zg = torch.roll(z_lde, -pk.config.rate, dims=0)
    const = pk.constants_oracle.lde
    t_re = torch.empty(m, dtype=torch.int64, device=wires_lde.device)
    t_im = torch.empty_like(t_re)
    for st in range(0, m, QUOTIENT_CHUNK):
        sl = slice(st, st + QUOTIENT_CHUNK)
        t_re[sl], t_im[sl] = pk.quotient_rows(
            const[sl], wires_lde[sl], z_lde[sl], zg[sl], pi_lde[sl],
            pk.x_lde[sl], pk.zh_inv_lde[sl], pk.zh_lde[sl],
            beta, gamma, lam, alphas)
    t_re, t_im = coset_intt(t_re)[:, 0], coset_intt(t_im)[:, 0]
    nch = pk.num_chunks
    return torch.stack([t_re[k * n:(k + 1) * n] for k in range(nch)] +
                       [t_im[k * n:(k + 1) * n] for k in range(nch)],
                       dim=1)


def open_body(coeffs, pows):
    """All columns of an (n, C) coefficient matrix evaluated at an ext
    point, given its (n,) power table: an ext pair of (C,) tensors."""
    return (gl.sum_axis(gl.mul(coeffs, pows[0][:, None]), 0),
            gl.sum_axis(gl.mul(coeffs, pows[1][:, None]), 0))


def fri_combine_body(pk, lde_list, z_lde, fri_alpha, ys, ys_next, zeta,
                     gzeta):
    """F(x) = sum_i a^i (p_i(x) - y_i)/(x - zeta) over the columns of
    lde_list, plus the same over z_lde's columns at g*zeta, on the LDE,
    accumulated one oracle at a time.  ys: the ext pair of (ncols,)
    openings at zeta of lde_list's columns in order; ys_next: z_lde's
    openings at g*zeta; fri_alpha (a), zeta and gzeta: ext scalars."""
    ncols = sum(mat.shape[1] for mat in lde_list)
    a_re, a_im = E.powers_table(fri_alpha, ncols + z_lde.shape[1])
    y1 = E.dot(ys, (a_re[:ncols], a_im[:ncols]))
    y2 = E.dot(ys_next, (a_re[ncols:], a_im[ncols:]))

    def combo(mat, base):
        acc = None
        for sl in column_blocks(*mat.shape):
            blk, a = mat[:, sl], slice(base + sl.start, base + sl.stop)
            t = (gl.sum_axis(gl.mul(blk, a_re[a]), 1),
                 gl.sum_axis(gl.mul(blk, a_im[a]), 1))
            acc = t if acc is None else E.add(acc, t)
        return acc

    x = pk.x_lde
    acc, base = None, 0
    for mat in lde_list:
        t = combo(mat, base)
        acc = t if acc is None else E.add(acc, t)
        base += mat.shape[1]

    def over(num, y, pt):
        den = (gl.sub(x, pt[0]), gl.neg(pt[1]).expand(x.shape))
        return E.mul(E.sub(num, y), E.inv(den))

    return E.add(over(acc, y1, zeta), over(combo(z_lde, base), y2, gzeta))


def fri_fold_body(values, beta, shift: int):
    """One FRI fold of (size,) ext values on the coset shift * H_size ->
    (size/2,) ext values; beta is an ext scalar."""
    size = values[0].shape[0]
    h = size // 2
    dev = values[0].device
    w_inv = s_inv(root_of_unity(size.bit_length() - 1))
    inv2x = gl.mul(gl.powers(w_inv, h, dev),
                   gl.const(s_inv(2 * shift % P), device=dev))
    v0 = (values[0][:h], values[1][:h])
    v1 = (values[0][h:], values[1][h:])
    half = gl.const(_HALF, device=dev)
    return E.add(E.mul_base(E.add(v0, v1), half),
                 E.mul(beta, E.mul_base(E.sub(v0, v1), inv2x)))


class ProvingKey:
    """Device-resident preprocessed data for one compiled circuit, built
    once and reused across proofs."""

    # every tensor of the key lies on self.device, so prove_fused may run it
    fusable = True

    def __init__(self, compiled: CompiledCircuit,
                 config: ProofConfig = STANDARD_CONFIG, *, device):
        self.device = resolve_device(device)
        self.compiled = compiled
        self.config = config
        n = compiled.n
        self.n = n
        self.m = n << config.rate_bits
        self.num_chunks = NUM_CHUNKS
        W = len(compiled.k_shifts)
        self.W = W
        self.has_lookups = compiled.lookup_bits > 0
        self.perm_groups = perm_groups(W)
        self.lk_groups = lookup_groups(W) if self.has_lookups else []
        self.K = len(self.perm_groups)
        self.nh = len(self.lk_groups)
        # z-oracle ext columns: [Z, B_1..B_{K-1}, (h_1..h_nh, h_T, S)]
        self.num_z_ext = self.K + ((self.nh + 2) if self.has_lookups else 0)
        self.num_constraints = 2 + self.K + \
            ((self.nh + 3) if self.has_lookups else 0)

        # preprocessed oracle: [selectors, sigma_0..sigma_{W-1}, table?]
        cols = [compiled.selectors, compiled.sigma]
        if self.has_lookups:
            cols.append(compiled.table.reshape(1, n))
        self.constants_oracle = self.commit(
            self._rows(np.concatenate(cols, axis=0).T))

        # domain tables, rows first, each an attribute of the key
        self.omega = root_of_unity(compiled.log_n)
        omega_m = root_of_unity(self.m.bit_length() - 1)
        g = MULTIPLICATIVE_GENERATOR
        rate = config.rate
        gn = pow(g, n, P)
        wn = pow(omega_m, n, P)
        zh = [(gn * pow(wn, i, P) - 1) % P for i in range(rate)]
        reps = self.m // rate
        tables = {
            "x_lde": _mul_u64(powers_u64(omega_m, self.m), g),
            "x_h": powers_u64(self.omega, n),
            "zh_lde": np.tile(np.array(zh, np.uint64), reps),
            "zh_inv_lde": np.tile(np.array([s_inv(v) for v in zh],
                                           np.uint64), reps),
            "sigma": compiled.sigma.T,
        }
        if self.has_lookups:
            tables["table"] = compiled.table
            tables["qlk"] = compiled.selectors[SEL_QLK]
        self.domain_tables = tuple(tables)
        for name, u64 in tables.items():
            setattr(self, name, self._rows(u64))
        self.k = self._dev(np.array(compiled.k_shifts, dtype=np.uint64))
        self.wire_idx = torch.as_tensor(compiled.wire_vars.astype(np.int64),
                                        device=self.device)

        self.vk = VerifyingKey(
            log_n=compiled.log_n, num_wires=W,
            num_public_inputs=compiled.num_public_inputs,
            k_shifts=compiled.k_shifts, num_quotient_chunks=self.num_chunks,
            rate_bits=config.rate_bits, cap_height=config.cap_height,
            num_queries=config.num_queries, pow_bits=config.pow_bits,
            # tiny traces: never fold below the LDE itself
            final_poly_domain=min(config.final_poly_domain, self.m),
            lookup_bits=compiled.lookup_bits,
            constants_cap=[tuple(int(x) for x in d)
                           for d in self.constants_oracle.tree.cap_u64()],
        )
        # the fused prover's CUDA graph for this key (prover/fused.py)
        self._captured = None

    def _dev(self, u64: np.ndarray) -> torch.Tensor:
        return gl.from_u64(u64, self.device)

    def _rows(self, u64: np.ndarray):
        """A domain-axis table (rows first) on the device; a sharded key
        places it as row blocks instead."""
        return self._dev(u64)

    def _ext(self, v):
        """Ext scalar (python-int pair) -> pair of 0-d device tensors."""
        return (gl.const(v[0], device=self.device),
                gl.const(v[1], device=self.device))

    # ---- phases -------------------------------------------------------------

    def build_wires(self, vals: torch.Tensor, mcol=None) -> torch.Tensor:
        """Solved variable vector (a device tensor) -> (n, W [+1]) wires
        matrix, gathered on the device through the (W, n) routing table."""
        w = vals[self.wire_idx]
        if mcol is not None:
            w = torch.cat([w, mcol.reshape(1, self.n)])
        return w.T.contiguous()

    def commit(self, values: torch.Tensor, from_coeffs: bool = False) -> Oracle:
        """(INTT +) coset LDE + Merkle tree of an (n, C) matrix.  The NTTs
        run over the ``column_blocks`` of the LDE, which are assembled
        before hashing: the NTT is column-independent, so the values are
        those of one pass over all columns."""
        rate_bits = self.config.rate_bits
        blocks = column_blocks(self.m, values.shape[1])
        if len(blocks) == 1:
            coeffs = values if from_coeffs else intt(values)
            lde = coset_lde(coeffs, rate_bits)
        else:
            coeffs = values if from_coeffs else torch.empty_like(values)
            lde = values.new_empty((self.m, values.shape[1]))
            for sl in blocks:
                if not from_coeffs:
                    coeffs[:, sl] = intt(values[:, sl])
                lde[:, sl] = coset_lde(coeffs[:, sl], rate_bits)
        return Oracle(coeffs, lde, merkle_tree(lde, self.config.cap_height))

    def round2_phase(self, wires, beta, gamma, lam) -> torch.Tensor:
        return round2_body(self, wires, self._ext(beta), self._ext(gamma),
                           self._ext(lam) if self.has_lookups else None)

    def quotient_rows(self, const, wires, z, zg, pi, x, zh_inv, zh,
                      beta, gamma, lam, alphas):
        """alpha-combined constraints * Z_H^-1 on a slice of LDE rows -> the
        t(x) values there.  zg is z at rows (row + rate) mod m, the g*x
        shift; every other input is row-aligned."""
        W, K = self.W, self.K
        a_re, a_im = alphas

        def a_mul(i, v):
            return E.mul((a_re[i], a_im[i]), v)

        w = wires[:, :W]
        gate = gl.add(gate_eval(const[:, :NUM_SELECTORS], w), pi)
        terms = [E.from_base(gate)]
        l1 = gl.mul(zh, gl.inv(gl.mul_const(gl.sub(x, gl.const(1, x)),
                                            self.n)))
        z0 = _col(z, 0)
        terms.append(a_mul(1, (gl.mul(l1, gl.sub(z0[0], gl.const(1, x))),
                               gl.mul(l1, z0[1]))))
        sig = const[:, NUM_SELECTORS:NUM_SELECTORS + W]
        nums, dens = perm_group_products(w, sig, x, self.k, beta, gamma,
                                         self.perm_groups)
        # c_t = chain[t] * N_t - chain[t+1] * D_t, chain = [Z, B.., Z(gx)]
        chain = [_col(z, t) for t in range(K)] + [_col(zg, 0)]
        for t in range(K):
            terms.append(a_mul(2 + t, E.sub(E.mul(chain[t], nums[t]),
                                            E.mul(chain[t + 1], dens[t]))))
        if self.has_lookups:
            nh = self.nh
            base_i = 2 + K
            qlk = const[:, SEL_QLK]
            tcol = const[:, NUM_SELECTORS + W]
            hs = [_col(z, K + g) for g in range(nh)]
            # each group's product and sum of leave-one-out products
            prods, allbuts = E.group_prod(lookup_factors(w, lam),
                                          self.lk_groups, allbut=True)
            for g in range(nh):
                c_h = E.sub(E.mul(hs[g], prods[g]),
                            E.mul_base(allbuts[g], qlk))
                terms.append(a_mul(base_i + g, c_h))
            h_t = _col(z, K + nh)
            c_ht = E.sub(E.mul(h_t, (gl.sub(lam[0], tcol), lam[1])),
                         (gl.const(1, x), gl.const(0, x)))
            terms.append(a_mul(base_i + nh, c_ht))
            s_ext, sg_ext = _col(z, K + nh + 1), _col(zg, K + nh + 1)
            c_s = E.add(E.sub(E.sub(sg_ext, s_ext), _fold(E.add, hs)),
                        E.mul_base(h_t, wires[:, W]))
            terms.append(a_mul(base_i + nh + 1, c_s))
            terms.append(a_mul(base_i + nh + 2, E.mul_base(s_ext, l1)))
        return E.mul_base(_fold(E.add, terms), zh_inv)

    def quotient_phase(self, wires_lde, z_lde, pub_values, beta, gamma, lam,
                       alpha) -> torch.Tensor:
        pub = self._dev(np.array(pub_values, dtype=np.uint64))
        return quotient_body(self, wires_lde, z_lde, pub, self._ext(beta),
                             self._ext(gamma),
                             self._ext(lam) if self.has_lookups else None,
                             self._ext(alpha))

    def open_at(self, oracle: Oracle, pows):
        """All columns of an oracle evaluated at an ext point, given its
        power table; returns python-int pairs."""
        re64, im64 = gl.to_u64(torch.stack(open_body(oracle.coeffs, pows)))
        return [(int(x), int(y)) for x, y in zip(re64, im64)]

    def fri_combine(self, lde_list, fri_alpha, ys, ys_next, zeta, gzeta,
                    z_lde):
        def dev(vals):
            return tuple(self._dev(np.array([v[i] for v in vals], np.uint64))
                         for i in (0, 1))

        return fri_combine_body(self, lde_list, z_lde, self._ext(fri_alpha),
                                dev(ys), dev(ys_next), self._ext(zeta),
                                self._ext(gzeta))

    def fri_fold(self, values, beta, shift: int):
        return fri_fold_body(values, self._ext(beta), shift)

    def fri_commit_layer(self, values) -> MerkleTree:
        """FRI layer tree: leaf j packs (F(x_j), F(-x_j)) as 4 columns."""
        re, im = values
        h = re.shape[0] // 2
        leaf = torch.stack([re[:h], im[:h], re[h:], im[h:]], dim=1)
        return merkle_tree(leaf, self.config.cap_height)

    def grind(self, challenger: Challenger, pow_bits: int) -> int:
        """Smallest nonce whose challenge (lane RATE-1 after the duplex) is
        below 2^(64 - pow_bits), searched on the device."""
        state = list(challenger.state)
        for i, v in enumerate(challenger.input_buf):
            state[i] = v
        lane = len(challenger.input_buf)
        nonce = int(kp.grind(self._dev(np.array(state, dtype=np.uint64)),
                             lane, pow_bits))
        if nonce >> 32:
            raise RuntimeError("grinding exhausted 32-bit nonces")
        return nonce


def prove(pk: ProvingKey, external_values: np.ndarray,
          check_constraints: bool = False, timer: PhaseTimer = None) -> Proof:
    timer = timer or PhaseTimer(enabled=False)
    cc = pk.compiled
    cfg = pk.config
    n, m = pk.n, pk.m

    # ---- phase 0: witness fill (host) -------------------------------------
    with timer.phase("witness_fill"):
        vals = cc.generate_witness(external_values)
    if check_constraints:
        bad = cc.check_constraints(vals)
        assert bad is None, f"constraint violated at row {bad}"
    pub_values = cc.public_values(vals)
    mcol = cc.multiplicities(cc.wire_values(vals)) if pk.has_lookups else None

    challenger = Challenger()
    for d in pk.vk.constants_cap:
        challenger.observe_many(d)
    challenger.observe_many(pub_values)

    # ---- phase 1: wire (+ multiplicity) commitment ---------------------------
    # each phase ends in a cap copy to the host, which waits for the device
    with timer.phase("wire_commit"):
        wires = pk.build_wires(pk._dev(vals),
                               None if mcol is None else pk._dev(mcol))
        wires_oracle = pk.commit(wires)
        challenger.observe_cap(wires_oracle.tree.cap_u64())
    beta = challenger.get_ext_challenge()
    gamma = challenger.get_ext_challenge()
    lam = challenger.get_ext_challenge() if pk.has_lookups else None

    # ---- phase 2: Z, partial products, lookup helpers -------------------------
    with timer.phase("permutation_z"):
        z_oracle = pk.commit(pk.round2_phase(wires, beta, gamma, lam))
        challenger.observe_cap(z_oracle.tree.cap_u64())
    alpha = challenger.get_ext_challenge()

    # ---- phase 3: quotient ------------------------------------------------------
    with timer.phase("quotient"):
        q_cols = pk.quotient_phase(wires_oracle.lde, z_oracle.lde,
                                   pub_values, beta, gamma, lam, alpha)
        quotient_oracle = pk.commit(q_cols, from_coeffs=True)
        challenger.observe_cap(quotient_oracle.tree.cap_u64())
    zeta = challenger.get_ext_challenge()

    # ---- phase 4: openings at zeta (and g*zeta for the round-2 oracle) --------
    with timer.phase("openings"):
        zpows = E.powers(zeta, n, pk.device)
        gzeta = e_mul((pk.omega, 0), zeta)
        gzpows = E.powers(gzeta, n, pk.device)
        openings = Openings(pk.open_at(pk.constants_oracle, zpows),
                            pk.open_at(wires_oracle, zpows),
                            pk.open_at(z_oracle, zpows),
                            pk.open_at(z_oracle, gzpows),
                            pk.open_at(quotient_oracle, zpows))
        for (a, b) in openings.ordered():
            challenger.observe(a)
            challenger.observe(b)
        fri_alpha = challenger.get_ext_challenge()

    # ---- phase 5: FRI ------------------------------------------------------------
    oracles = [pk.constants_oracle, wires_oracle, z_oracle, quotient_oracle]
    with timer.phase("fri"):
        ys = (openings.constants_sigmas + openings.wires + openings.z +
              openings.quotient)
        cur = pk.fri_combine([o.lde for o in oracles], fri_alpha, ys,
                             openings.z_next, zeta, gzeta, z_oracle.lde)
        fri_trees = []
        cur_shift = MULTIPLICATIVE_GENERATOR
        size = m
        while size > pk.vk.final_poly_domain:
            tree = pk.fri_commit_layer(cur)
            challenger.observe_cap(tree.cap_u64())
            fbeta = challenger.get_ext_challenge()
            cur = pk.fri_fold(cur, fbeta, cur_shift)
            fri_trees.append(tree)
            cur_shift = (cur_shift * cur_shift) % P
            size //= 2
        re64, im64 = gl.to_u64(torch.stack(
            [coset_intt(c, shift=cur_shift)[:, 0] for c in cur]))
        final_coeffs = [(int(a), int(b)) for a, b in zip(re64, im64)]
        for c0, c1 in final_coeffs:
            challenger.observe(c0)
            challenger.observe(c1)

    with timer.phase("pow_grind"):
        pow_witness = pk.grind(challenger, cfg.pow_bits)
    challenger.observe(pow_witness)
    pow_challenge = challenger.get_challenge()
    assert pow_challenge < (1 << (64 - cfg.pow_bits))
    indices = challenger.get_indices(cfg.num_queries, m)

    # ---- phase 6: query rounds (one gather and one copy per tree) -------------
    with timer.phase("queries"):
        oracle_q = [o.tree.rows_and_paths(indices) for o in oracles]
        layer_q = []
        cur_idx = list(indices)
        for tree in fri_trees:
            cur_idx = [i % tree.num_leaves for i in cur_idx]
            layer_q.append(tree.rows_and_paths(cur_idx))
        queries = []
        for qi in range(len(indices)):
            initial = [OracleOpening(
                row=[int(v) for v in rows[qi]],
                path=[tuple(int(x) for x in d) for d in paths[qi]])
                for rows, paths in oracle_q]
            steps = []
            for rows, paths in layer_q:
                row = rows[qi]
                steps.append(FriStep(
                    pair=((int(row[0]), int(row[1])),
                          (int(row[2]), int(row[3]))),
                    path=[tuple(int(x) for x in d) for d in paths[qi]]))
            queries.append(QueryRound(initial=initial, steps=steps))

    def cap_list(tree):
        return [tuple(int(x) for x in d) for d in tree.cap_u64()]

    return Proof(
        public_inputs=pub_values,
        wires_cap=cap_list(wires_oracle.tree),
        z_cap=cap_list(z_oracle.tree),
        quotient_cap=cap_list(quotient_oracle.tree),
        openings=openings,
        fri_caps=[cap_list(t) for t in fri_trees],
        fri_final_coeffs=final_coeffs,
        fri_pow_witness=pow_witness,
        fri_queries=queries,
    )
