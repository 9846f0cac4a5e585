"""The whole proof after witness generation as one device program.

Counterpart of ``tpu_acir_prover/prover/fused.py``.  The per-phase prover
(``prove.prove``) reads each Merkle cap, opening and the proof-of-work
nonce back to the host and runs the Fiat-Shamir transcript there.  Here the
transcript runs on the device too (``GraphChallenger``, a duplex sponge on
a (12,) state, each duplex one ``duplex`` kernel launch that reads the
buffered inputs by address), the grind is one kernel launch, and the query
rows and paths are gathered on the device, so the body ``_fused_graph``
makes no host read and copies nothing from the host.

On CUDA, ``prove_fused`` captures that body once per proving key as a CUDA
graph and replays it for every proof: one copy of the inputs in, one
replay, one copy of the outputs out.  On the CPU it runs the body eagerly.
Either way it calls the per-phase prover's phase bodies, so the proof
bytes equal ``prove.prove``'s.

Unlike the JAX package, which re-runs each oracle's LDE in a second program
to gather the query rows within a 16 GB TPU chip, the graph gathers them
from the live LDEs.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..field import ext as E
from ..field import gl
from ..field.gl import MULTIPLICATIVE_GENERATOR, P
from ..field.poseidon import RATE, WIDTH
from ..kernels import field as kf
from ..kernels import poseidon as kp
from ..utils.timing import PhaseTimer
from .merkle import gather_paths
from .ntt import coset_intt
from .proof import FriStep, Openings, OracleOpening, Proof, QueryRound
from .prove import (ProvingKey, fri_combine_body, fri_fold_body, open_body,
                    quotient_body, round2_body)


class GraphChallenger:
    """Duplex Poseidon2 sponge on the device.

    Mirrors ``challenger.Challenger`` rule for rule: the same buffering, the
    same duplex points, a squeeze that pops from the end.  Values are 0-d
    int64 tensors holding canonical field elements."""

    def __init__(self, device):
        self.state = torch.zeros(WIDTH, dtype=torch.int64, device=device)
        self.input_buf = []
        self.output_buf = []

    def observe(self, x: torch.Tensor):
        self.input_buf.append(x)
        if len(self.input_buf) == RATE:
            self._duplex()

    def observe_vec(self, v: torch.Tensor):
        """Observe every element of a tensor, in row-major order."""
        for x in v.reshape(-1).unbind():
            self.observe(x)

    def _duplex(self):
        self.state = kp.duplex(self.state, self.input_buf)
        self.output_buf = list(self.state[:RATE].unbind())
        self.input_buf = []

    def get_challenge(self) -> torch.Tensor:
        if self.input_buf or not self.output_buf:
            self._duplex()
        return self.output_buf.pop()

    def get_ext_challenge(self):
        return (self.get_challenge(), self.get_challenge())


def _fused_graph(pk: ProvingKey, vals, pub, mcol=None):
    """The prover from the solved variable vector to the proof's values,
    on the device.

    vals: the (num_vars,) solved variables; pub: the (npub,) public inputs;
    mcol: the (n,) lookup multiplicity column, or None.  Returns a dict of
    device tensors (and lists of them) that ``_assemble_proof`` reads."""
    n, m = pk.n, pk.m
    ch = GraphChallenger(pk.device)
    # the device cap that vk.constants_cap was read from: same values
    ch.observe_vec(pk.constants_oracle.tree.cap)
    ch.observe_vec(pub)

    # ---- wires commitment
    wires = pk.build_wires(vals, mcol)
    wires_oracle = pk.commit(wires)
    ch.observe_vec(wires_oracle.tree.cap)
    beta = ch.get_ext_challenge()
    gamma = ch.get_ext_challenge()
    lam = ch.get_ext_challenge() if pk.has_lookups else None

    # ---- round 2
    z_oracle = pk.commit(round2_body(pk, wires, beta, gamma, lam))
    ch.observe_vec(z_oracle.tree.cap)
    alpha = ch.get_ext_challenge()

    # ---- quotient
    quotient_oracle = pk.commit(
        quotient_body(pk, wires_oracle.lde, z_oracle.lde, pub, beta, gamma,
                      lam, alpha), from_coeffs=True)
    ch.observe_vec(quotient_oracle.tree.cap)
    zeta = ch.get_ext_challenge()

    # ---- openings at zeta, and at g*zeta for the round-2 oracle
    zpows = E.powers_table(zeta, n)
    gzeta = E.mul_base(zeta, gl.const(pk.omega, zeta[0]))
    gzpows = E.powers_table(gzeta, n)
    oracles = [pk.constants_oracle, wires_oracle, z_oracle, quotient_oracle]
    opens = [open_body(o.coeffs, zpows) for o in oracles]
    z_next = open_body(z_oracle.coeffs, gzpows)
    # transcript order: constants, wires, z, z_next, quotient
    for re, im in opens[:3] + [z_next] + opens[3:]:
        for a, b in zip(re.unbind(), im.unbind()):
            ch.observe(a)
            ch.observe(b)
    fri_alpha = ch.get_ext_challenge()

    # ---- FRI: combine, then commit and fold layer by layer
    ys = tuple(torch.cat([o[i] for o in opens]) for i in (0, 1))
    cur = fri_combine_body(pk, [o.lde for o in oracles], z_oracle.lde,
                           fri_alpha, ys, z_next, zeta, gzeta)
    fri_trees = []
    cur_shift = MULTIPLICATIVE_GENERATOR
    size = m
    while size > pk.vk.final_poly_domain:
        tree = pk.fri_commit_layer(cur)
        ch.observe_vec(tree.cap)
        cur = fri_fold_body(cur, ch.get_ext_challenge(), cur_shift)
        fri_trees.append(tree)
        cur_shift = (cur_shift * cur_shift) % P
        size //= 2
    final = [coset_intt(c, shift=cur_shift)[:, 0] for c in cur]
    for a, b in zip(final[0].unbind(), final[1].unbind()):
        ch.observe(a)
        ch.observe(b)

    # ---- proof of work, query indices, query rows and paths
    pow_witness = kp.grind(ch.state, len(ch.input_buf), pk.config.pow_bits,
                           ch.input_buf)
    ch.observe(pow_witness)
    ch.get_challenge()
    indices = torch.stack([ch.get_challenge() for _ in
                           range(pk.config.num_queries)]) & (m - 1)
    fri_idx, cur_idx = [], indices
    for tree in fri_trees:
        cur_idx = cur_idx & (tree.num_leaves - 1)
        fri_idx.append(cur_idx)

    def opened(tree, idx):
        return (tree.leaves.index_select(0, idx),
                gather_paths(tree.levels, idx))

    return {
        "caps": [o.tree.cap for o in oracles[1:]],
        "opens": opens[:3] + [z_next] + opens[3:],
        "fri_caps": [t.cap for t in fri_trees],
        "final": final,
        "pow": pow_witness,
        "indices": indices,
        "oracle_queries": [opened(o.tree, indices) for o in oracles],
        "fri_queries": [opened(t, i) for t, i in zip(fri_trees, fri_idx)],
    }


def _flat_graph(pk, vals, pub, mcol=None):
    """``_fused_graph`` with its outputs concatenated into one (N,) tensor,
    and the pytree spec and leaf shapes that split it again."""
    leaves, spec = tree_flatten(_fused_graph(pk, vals, pub, mcol))
    flat = torch.cat([t.reshape(-1) for t in leaves])
    return flat, (spec, [tuple(t.shape) for t in leaves])


def _unflatten(flat_u64: np.ndarray, layout):
    spec, shapes = layout
    leaves, off = [], 0
    for shape in shapes:
        size = int(np.prod(shape, dtype=np.int64))
        leaves.append(flat_u64[off:off + size].reshape(shape))
        off += size
    return tree_unflatten(leaves, spec)


def all_launches() -> dict:
    """Every kernel wrapper's launch count: the Poseidon2 kernels' and the
    field kernels'."""
    return {**kp.launches, **kf.launches}


class CapturedProof:
    """The fused prover of one proving key as a CUDA graph, with its static
    input buffers and pinned host staging; built at first use and cached on
    the key.  Each ``run`` overwrites the outputs of the last one."""

    def __init__(self, pk: ProvingKey, vals, pub, mcol):
        dev = pk.device
        host = [a for a in (vals, pub, mcol) if a is not None]
        self.staging = [torch.empty(a.shape, dtype=torch.int64,
                                    pin_memory=True) for a in host]
        self.inputs = [torch.empty(a.shape, dtype=torch.int64, device=dev)
                       for a in host]
        self._load(host)
        args = self.inputs + [None] * (3 - len(self.inputs))
        # one eager run first, off the capture: it builds and loads the
        # kernels and copies the Poseidon2 constants to the card, none of
        # which a capture may do
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _flat_graph(pk, *args)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = all_launches()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph):
            self.flat, self.layout = _flat_graph(pk, *args)
        self.capture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.graph.instantiate()
        torch.cuda.synchronize(dev)
        self.instantiate_s = time.perf_counter() - t0
        # the kernel launches the graph holds, by wrapper: one replay's
        self.launches = {k: v - before[k]
                         for k, v in all_launches().items()}
        # device memory the graph's pool keeps between replays
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.out = torch.empty(self.flat.shape, dtype=torch.int64,
                               pin_memory=True)
        # the replay's device time, recorded for an enabled timer only
        self.replay_events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))

    def _load(self, host):
        for st, dst, a in zip(self.staging, self.inputs, host):
            st.numpy()[...] = np.ascontiguousarray(a, np.uint64).view(np.int64)
            dst.copy_(st, non_blocking=True)

    def run(self, vals, pub, mcol, timer: PhaseTimer = None) -> np.ndarray:
        """Inputs in, one replay, the outputs out as a flat uint64 array;
        an enabled ``timer`` counts the replay's device time
        (``replay_device_s``)."""
        timed = timer is not None and timer.enabled
        start, end = self.replay_events
        stream = torch.cuda.current_stream(self.flat.device)
        self._load([a for a in (vals, pub, mcol) if a is not None])
        if timed:
            start.record(stream)
        self.graph.replay()
        if timed:
            end.record(stream)
        self.out.copy_(self.flat, non_blocking=True)
        stream.synchronize()
        if timed:
            timer.count("replay_device_s", start.elapsed_time(end) * 1e-3)
        return self.out.numpy().view(np.uint64).copy()


def prove_fused(pk: ProvingKey, external_values: np.ndarray,
                timer: PhaseTimer = None, with_indices: bool = False):
    """Same proof as ``prove.prove``; on CUDA a replay of the key's graph,
    on the CPU an eager run of the same body.  With ``with_indices``,
    ``(proof, indices)`` as ``prove.prove`` gives them."""
    if not pk.fusable:
        raise TypeError(f"prove_fused proves on one device; a "
                        f"{type(pk).__name__} proves with prove_sharded")
    timer = timer or PhaseTimer(enabled=False)
    cc = pk.compiled
    with timer.phase("witness_fill"):
        vals = cc.generate_witness(external_values)
    with timer.phase("inputs"):
        pub_values = cc.public_values(vals)
        pub = np.array(pub_values, dtype=np.uint64)
        mcol = cc.multiplicities(cc.wire_values(vals)) if pk.has_lookups \
            else None
    with timer.phase("fused_device"):
        if pk.device.type == "cuda":
            if pk._captured is None:
                pk._captured = CapturedProof(pk, vals, pub, mcol)
            flat = pk._captured.run(vals, pub, mcol, timer)
            layout = pk._captured.layout
        else:
            flat, layout = _flat_graph(pk, *(None if a is None else pk._dev(a)
                                             for a in (vals, pub, mcol)))
            flat = gl.to_u64(flat)
    with timer.phase("assemble"):
        out = _unflatten(flat, layout)
        proof = _assemble_proof(pub_values, out)
        indices = [int(i) for i in out["indices"]]
    return (proof, indices) if with_indices else proof


def _assemble_proof(pub_values, out) -> Proof:
    """The Proof from the host copy of ``_fused_graph``'s outputs."""

    def ints(a):
        return [int(x) for x in a]

    def ext_list(pair):
        return list(zip(ints(pair[0]), ints(pair[1])))

    def cap_list(cap):
        return [tuple(ints(d)) for d in cap]

    def paths(levels, q):
        return [tuple(ints(lev[q])) for lev in levels]

    indices = out["indices"]
    queries = []
    for q in range(len(indices)):
        initial = [OracleOpening(row=ints(rows[q]), path=paths(levels, q))
                   for rows, levels in out["oracle_queries"]]
        steps = []
        for rows, levels in out["fri_queries"]:
            r = ints(rows[q])
            steps.append(FriStep(pair=((r[0], r[1]), (r[2], r[3])),
                                 path=paths(levels, q)))
        queries.append(QueryRound(initial=initial, steps=steps))
    wires_cap, z_cap, quotient_cap = (cap_list(c) for c in out["caps"])
    return Proof(
        public_inputs=pub_values,
        wires_cap=wires_cap,
        z_cap=z_cap,
        quotient_cap=quotient_cap,
        openings=Openings(*(ext_list(o) for o in out["opens"])),
        fri_caps=[cap_list(c) for c in out["fri_caps"]],
        fri_final_coeffs=ext_list(out["final"]),
        fri_pow_witness=int(out["pow"]),
        fri_queries=queries,
    )
