"""Synthetic circuits for benchmarking: build CompiledCircuit arrays
directly (vectorized numpy) so a 2^20-row prover benchmark doesn't spend
minutes in the python gadget layer.

A copy of ``tpu_acir_prover/utils/bench_circuits.py``."""

from __future__ import annotations

import numpy as np

from ..circuit import builder as B
from ..circuit.compile import (CompiledCircuit, GenBatch, powers_u64, _GNP)
from ..field import gl as _gl
from ..field.gl import P


def mul_chain_circuit(log_n: int) -> CompiledCircuit:
    """n rows of qM*w0*w1 - w2 = 0 with all wires = var 1 (value 1): a
    maximal-occupancy trace exercising LDE/Merkle/Z/quotient at scale."""
    n = 1 << log_n
    W = B.NUM_WIRES
    selectors = np.zeros((B.NUM_SELECTORS, n), dtype=np.uint64)
    selectors[B.SEL_QM0, :] = 1
    selectors[B.SEL_Q0 + 2, :] = P - 1
    wire_vars = np.zeros((W, n), dtype=np.int64)
    wire_vars[0:3, :] = 1  # all slots -> var 1 (value 1)

    omega_pows = powers_u64(_gl.root_of_unity(log_n), n)
    g = _gl.MULTIPLICATIVE_GENERATOR
    k_shifts = tuple(pow(g, i, P) for i in range(W))
    ids = np.empty((W, n), dtype=np.uint64)
    for col, k in enumerate(k_shifts):
        klo, khi = _GNP.const(k, (n,))
        plo = (omega_pows & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        phi = (omega_pows >> np.uint64(32)).astype(np.uint32)
        ids[col] = _GNP.to_u64(_GNP.mul((klo, khi), (plo, phi)))
    flat = wire_vars.reshape(-1)
    order = np.argsort(flat, kind="stable")
    svars = flat[order]
    bounds = np.nonzero(np.diff(svars))[0] + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [flat.size]])
    nxt = np.arange(1, flat.size + 1)
    nxt[ends - 1] = starts
    perm = np.empty(flat.size, dtype=np.int64)
    perm[order] = order[nxt]
    sigma = ids.reshape(-1)[perm].reshape(W, n)

    return CompiledCircuit(
        n=n, log_n=log_n, num_vars=2,
        selectors=selectors, wire_vars=wire_vars, sigma=sigma,
        k_shifts=k_shifts,
        gen_batches=[GenBatch(op=B.GEN_CONST,
                              out=np.array([0, 1], dtype=np.int64),
                              a=np.zeros(2, dtype=np.int64),
                              b=np.zeros(2, dtype=np.int64),
                              const=np.array([0, 1], dtype=np.uint64))],
        hints=[], external_vars=np.array([], dtype=np.int64),
        public_input_vars=np.array([], dtype=np.int64),
        num_public_inputs=0)
