"""Host-side proof verifier (python-int scalar math, O(queries * log n)).

Functional analog of the reference's VerifyAction -> verify_compressed
(actions/verify_action.rs:10-18): raises AssertionError on a bad proof,
returns None on success.  Re-derives the full Fiat-Shamir transcript, checks
the PLONK gate + permutation + LogUp lookup identity at zeta against the
quotient opening, then checks every FRI query round (Merkle paths, fold
chain, final poly).  See prover/prove.py's module docstring for the full
constraint list this must mirror.
"""

from __future__ import annotations

from typing import List

from ..circuit.builder import lookup_groups, perm_groups
from ..field import gl as _gl
from ..field.ext import e_add, e_sub, e_mul, e_inv, e_pow
from ..field.gl import P
from .challenger import Challenger
from .fri import verify_fri_query, check_final_poly_degree
from .merkle import verify_merkle_path
from .proof import Proof, VerifyingKey

U = 7  # extension defining constant, u^2 = 7


def _mul_u(y):
    """u * (y0 + y1 u) = 7 y1 + y0 u."""
    return ((U * y[1]) % P, y[0])


def _ext_from_parts(re, im):
    """re + u*im where re, im are ext values (openings of base polys)."""
    return e_add(re, _mul_u(im))


class VerificationError(AssertionError):
    pass


def vk_shape(vk: VerifyingKey):
    """Derived column counts: (num_pairs, num_selectors, const_w, wires_w,
    K, nh, num_z_ext)."""
    W = vk.num_wires
    npair = W // 2
    nsel = npair + W + 2
    has_lk = vk.lookup_bits > 0
    K = len(perm_groups(W))
    nh = len(lookup_groups(W)) if has_lk else 0
    num_z_ext = K + ((nh + 2) if has_lk else 0)
    const_w = nsel + W + (1 if has_lk else 0)
    wires_w = W + (1 if has_lk else 0)
    return npair, nsel, const_w, wires_w, K, nh, num_z_ext


def derive_transcript(vk: VerifyingKey, proof: Proof):
    """Replay the Fiat-Shamir transcript over the proof's commitments.

    Returns (beta, gamma, lam, alpha, zeta, fri_alpha, betas, pow_challenge,
    indices).  Shared by verify(), the decompressor and the proof
    compressor (compress.py) when its caller holds no query indices: it
    needs them to prune Merkle paths — the analog of the reference's
    `proof.compress(circuit_digest, common)` needing CommonData
    (prove_action.rs:75-78).  ``api.prove_file`` hands the compressor the
    prover's own indices instead."""
    m = (1 << vk.log_n) << vk.rate_bits
    ch = Challenger()
    for d in vk.constants_cap:
        ch.observe_many(d)
    ch.observe_many(proof.public_inputs)
    ch.observe_cap(proof.wires_cap)
    beta = ch.get_ext_challenge()
    gamma = ch.get_ext_challenge()
    lam = ch.get_ext_challenge() if vk.lookup_bits else (0, 0)
    ch.observe_cap(proof.z_cap)
    alpha = ch.get_ext_challenge()
    ch.observe_cap(proof.quotient_cap)
    zeta = ch.get_ext_challenge()
    for (a, b) in proof.openings.ordered():
        ch.observe(a)
        ch.observe(b)
    fri_alpha = ch.get_ext_challenge()
    betas = []
    cur = m
    li = 0
    while cur > vk.final_poly_domain:
        if li >= len(proof.fri_caps):
            raise VerificationError("missing FRI layer caps")
        ch.observe_cap(proof.fri_caps[li])
        betas.append(ch.get_ext_challenge())
        cur //= 2
        li += 1
    if li != len(proof.fri_caps):
        raise VerificationError("extra FRI layer caps")
    if len(proof.fri_final_coeffs) != vk.final_poly_domain:
        raise VerificationError("final poly length mismatch")
    for c0, c1 in proof.fri_final_coeffs:
        ch.observe(c0)
        ch.observe(c1)
    ch.observe(proof.fri_pow_witness)
    pow_challenge = ch.get_challenge()
    indices = ch.get_indices(vk.num_queries, m)
    return beta, gamma, lam, alpha, zeta, fri_alpha, betas, pow_challenge, \
        indices


def verify(vk: VerifyingKey, proof: Proof) -> None:
    n = 1 << vk.log_n
    m = n << vk.rate_bits
    W = vk.num_wires
    nch = vk.num_quotient_chunks
    op = proof.openings
    has_lk = vk.lookup_bits > 0
    npair, nsel, const_w, wires_w, K, nh, num_z_ext = vk_shape(vk)
    p_groups = perm_groups(W)
    lk_groups = lookup_groups(W) if has_lk else []

    if len(proof.public_inputs) != vk.num_public_inputs:
        raise VerificationError("public input count mismatch")
    if len(op.constants_sigmas) != const_w or len(op.wires) != wires_w \
            or len(op.z) != 2 * num_z_ext or len(op.z_next) != 2 * num_z_ext \
            or len(op.quotient) != 2 * nch:
        raise VerificationError("malformed openings")

    (beta, gamma, lam, alpha, zeta, fri_alpha, betas, pow_challenge,
     indices) = derive_transcript(vk, proof)
    if pow_challenge >= (1 << (64 - vk.pow_bits)):
        raise VerificationError("proof-of-work check failed")
    check_final_poly_degree(proof.fri_final_coeffs, vk.final_poly_domain,
                            vk.rate_bits)

    # ---- gate + permutation + lookup identity at zeta -----------------------
    omega = _gl.root_of_unity(vk.log_n)
    zeta_n = e_pow(zeta, n)
    zh_zeta = e_sub(zeta_n, (1, 0))
    if zh_zeta == (0, 0):
        raise VerificationError("zeta in evaluation domain")

    # PI(zeta) = sum_j (-pub_j) * L_j(zeta),
    # L_j(zeta) = omega^j (zeta^n - 1) / (n (zeta - omega^j))
    pi_zeta = (0, 0)
    wj = 1
    for pub in proof.public_inputs:
        lj = e_mul((wj, 0), e_mul(zh_zeta,
                                  e_inv(e_mul((n, 0), e_sub(zeta, (wj, 0))))))
        pi_zeta = e_sub(pi_zeta, e_mul((pub % P, 0), lj))
        wj = (wj * omega) % P

    qms = op.constants_sigmas[:npair]
    qs = op.constants_sigmas[npair:npair + W]
    qc = op.constants_sigmas[npair + W]
    qlk = op.constants_sigmas[npair + W + 1]
    sigmas = op.constants_sigmas[nsel:nsel + W]
    table = op.constants_sigmas[nsel + W] if has_lk else None
    wires = op.wires[:W]
    mult = op.wires[W] if has_lk else None

    c_gate = (0, 0)
    for j in range(npair):
        c_gate = e_add(c_gate, e_mul(qms[j],
                                     e_mul(wires[2 * j], wires[2 * j + 1])))
    for i in range(W):
        c_gate = e_add(c_gate, e_mul(qs[i], wires[i]))
    c_gate = e_add(c_gate, qc)
    c_gate = e_add(c_gate, pi_zeta)

    zv = [_ext_from_parts(op.z[2 * t], op.z[2 * t + 1])
          for t in range(num_z_ext)]
    zgv = [_ext_from_parts(op.z_next[2 * t], op.z_next[2 * t + 1])
           for t in range(num_z_ext)]
    z_zeta = zv[0]
    z_gzeta = zgv[0]

    # L_1(zeta) = (zeta^n - 1) / (n (zeta - 1))
    l1 = e_mul(zh_zeta, e_inv(e_mul((n, 0), e_sub(zeta, (1, 0)))))
    constraints = [c_gate, e_mul(l1, e_sub(z_zeta, (1, 0)))]

    # permutation partial-product transitions
    chain = [z_zeta] + zv[1:K] + [z_gzeta]
    for t, (s, e) in enumerate(p_groups):
        fnum = (1, 0)
        fden = (1, 0)
        for i in range(s, e):
            kx = e_mul((vk.k_shifts[i], 0), zeta)
            fnum = e_mul(fnum, e_add(e_add(wires[i], e_mul(beta, kx)), gamma))
            fden = e_mul(fden, e_add(e_add(wires[i], e_mul(beta, sigmas[i])),
                                     gamma))
        constraints.append(e_sub(e_mul(chain[t], fnum),
                                 e_mul(chain[t + 1], fden)))

    if has_lk:
        facs = [e_sub(lam, wires[i]) for i in range(W)]
        for t, (s, e) in enumerate(lk_groups):
            h_g = zv[K + t]
            prod = (1, 0)
            for i in range(s, e):
                prod = e_mul(prod, facs[i])
            rhs = (0, 0)
            for i in range(s, e):
                term = (1, 0)
                for k2 in range(s, e):
                    if k2 != i:
                        term = e_mul(term, facs[k2])
                rhs = e_add(rhs, term)
            constraints.append(e_sub(e_mul(h_g, prod), e_mul(qlk, rhs)))
        h_t = zv[K + nh]
        constraints.append(e_sub(e_mul(h_t, e_sub(lam, table)), (1, 0)))
        s_z = zv[K + nh + 1]
        s_gz = zgv[K + nh + 1]
        c_s = e_sub(s_gz, s_z)
        for t in range(nh):
            c_s = e_sub(c_s, zv[K + t])
        c_s = e_add(c_s, e_mul(mult, h_t))
        constraints.append(c_s)
        constraints.append(e_mul(l1, s_z))

    c_all = (0, 0)
    apow = (1, 0)
    for c in constraints:
        c_all = e_add(c_all, e_mul(apow, c))
        apow = e_mul(apow, alpha)

    t_zeta = (0, 0)
    zeta_kn = (1, 0)
    for k in range(nch):
        tk = _ext_from_parts(op.quotient[k], op.quotient[nch + k])
        t_zeta = e_add(t_zeta, e_mul(zeta_kn, tk))
        zeta_kn = e_mul(zeta_kn, zeta_n)
    if c_all != e_mul(t_zeta, zh_zeta):
        raise VerificationError("gate/permutation/lookup identity check failed")

    # ---- FRI query rounds -----------------------------------------------------
    g = _gl.MULTIPLICATIVE_GENERATOR
    omega_m = _gl.root_of_unity(m.bit_length() - 1)
    gzeta = e_mul((omega, 0), zeta)
    num_cols = const_w + wires_w + 2 * num_z_ext + 2 * nch
    zcols = 2 * num_z_ext
    alphas = [e_pow(fri_alpha, i) for i in range(num_cols + zcols)]
    caps = [vk.constants_cap, proof.wires_cap, proof.z_cap, proof.quotient_cap]
    expected_widths = [const_w, wires_w, 2 * num_z_ext, 2 * nch]
    ys = (op.constants_sigmas + op.wires + op.z + op.quotient)

    if len(proof.fri_queries) != vk.num_queries:
        raise VerificationError("query round count mismatch")
    for qi, (q, round_) in enumerate(zip(indices, proof.fri_queries)):
        if len(round_.initial) != 4:
            raise VerificationError("malformed query round")
        rows: List[int] = []
        for oi, opening in enumerate(round_.initial):
            if len(opening.row) != expected_widths[oi]:
                raise VerificationError("oracle row width mismatch")
            if not verify_merkle_path(opening.row, q, opening.path, caps[oi]):
                raise VerificationError(
                    f"query {qi}: oracle {oi} merkle path failed")
            rows.extend(opening.row)
        xq = (g * _gl.s_pow(omega_m, q)) % P
        inv_xz = e_inv(e_sub((xq, 0), zeta))
        inv_xgz = e_inv(e_sub((xq, 0), gzeta))
        e0 = (0, 0)
        for i, (rv, y) in enumerate(zip(rows, ys)):
            e0 = e_add(e0, e_mul(alphas[i],
                                 e_mul(e_sub((rv % P, 0), y), inv_xz)))
        z_rows = round_.initial[2].row
        for j in range(zcols):
            e0 = e_add(e0, e_mul(alphas[num_cols + j],
                                 e_mul(e_sub((z_rows[j] % P, 0),
                                             op.z_next[j]), inv_xgz)))
        try:
            verify_fri_query(q, e0, round_.steps, betas,
                             [c for c in proof.fri_caps],
                             proof.fri_final_coeffs, m.bit_length() - 1,
                             g, vk.final_poly_domain, vk.rate_bits)
        except AssertionError as e:
            raise VerificationError(f"query {qi}: {e}") from e
