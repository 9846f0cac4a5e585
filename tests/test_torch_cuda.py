"""The Poseidon2 and field CUDA kernels against their plain torch twins, on
the card, bit for bit (the field kernels also on 0-d, broadcast, strided
and empty operands, on a second card where there is one, and inside a
captured CUDA graph); the fused prover's CUDA graph against the per-phase prover on
the card, also with commits over several column blocks; the sharded
prover and FRI layer with every shard on the card against their CPU
runs.

Skips where torch.cuda.is_available() is false.  Imports no JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from tpu_acir_prover_torch.acir.translator import translate_program
from tpu_acir_prover_torch.circuit.builder import CircuitBuilder
from tpu_acir_prover_torch.circuit.compile import compile_circuit
from tpu_acir_prover_torch.field import ext as E
from tpu_acir_prover_torch.field import ext_plain, gl, gl_plain
from tpu_acir_prover_torch.field import poseidon as plain
from tpu_acir_prover_torch.field.gl import P
from tpu_acir_prover_torch.kernels import field as kf
from tpu_acir_prover_torch.kernels import poseidon as kp
from tpu_acir_prover_torch.parallel.fri import (layer_inv2x_padded,
                                                make_sharded_fri_layer)
from tpu_acir_prover_torch.parallel.mesh import Mesh
from tpu_acir_prover_torch.parallel.prove import (ShardedProvingKey,
                                                  prove_sharded)
from tpu_acir_prover_torch.prover import prove as prove_mod
from tpu_acir_prover_torch.prover.config import TEST_CONFIG
from tpu_acir_prover_torch.prover.fused import prove_fused
from tpu_acir_prover_torch.prover.merkle import merkle_levels
from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
from tpu_acir_prover_torch.prover.serialization import serialize_proof
from tpu_acir_prover_torch.prover.verify import verify
from tpu_acir_prover_torch.utils import circuits

EDGES = np.array([0, P - 1, 1 << 32, (1 << 32) - 1], dtype=np.uint64)


def _rand_u64(shape, seed):
    """Canonical values from a seed, with the edge values mixed in."""
    v = np.random.default_rng(seed).integers(0, P, size=shape,
                                             dtype=np.uint64).reshape(-1)
    k = min(v.size, 4 * EDGES.size)
    v[:k] = np.tile(EDGES, 4)[:k]
    return v.reshape(shape)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 4, 8, 9, 12, 17, 18, 43])
def test_leaf_hash_kernel_matches_twin(cuda, c):
    for rows in (1, 127, 4096 + 3):  # not multiples of the 128-row block
        x = gl.from_u64(_rand_u64((rows, c), seed=c * rows), cuda)
        n0 = kp.launches["leaf_hash"]
        got = kp.leaf_hash(x)
        assert kp.launches["leaf_hash"] == n0 + 1
        assert torch.equal(got, plain.hash_no_pad(x)), (c, rows)


# tests/test_torch_field.py's edge values
FIELD_EDGES = np.array([0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32,
                        (1 << 32) + 1, 1 << 63, P >> 1], dtype=np.uint64)
POW_E = 0xDEADBEEF12345678 % P
# op: (operands, kernel, plain twin, launch counter)
FIELD_OPS = {
    "add": (2, lambda t: [kf.add(*t)], lambda t: [gl_plain.add(*t)],
            "gl_binary"),
    "sub": (2, lambda t: [kf.sub(*t)], lambda t: [gl_plain.sub(*t)],
            "gl_binary"),
    "mul": (2, lambda t: [kf.mul(*t)], lambda t: [gl_plain.mul(*t)],
            "gl_binary"),
    "inv": (1, lambda t: [kf.pow_const(t[0], P - 2)],
            lambda t: [gl_plain.inv(t[0])], "gl_pow"),
    "pow": (1, lambda t: [kf.pow_const(t[0], POW_E)],
            lambda t: [gl_plain.pow_const(t[0], POW_E)], "gl_pow"),
    "pow0": (1, lambda t: [kf.pow_const(t[0], 0)],
             lambda t: [gl_plain.pow_const(t[0], 0)], "gl_pow"),
    "ext_mul": (4, lambda t: list(kf.ext_mul(t[:2], t[2:])),
                lambda t: list(ext_plain.mul(t[:2], t[2:])), "ext_mul"),
    "ext_inv": (2, lambda t: list(kf.ext_inv(t)),
                lambda t: list(ext_plain.inv(t)), "ext_inv"),
}


def _field_values(n, seed, k):
    """n values: operand k of every pair of edge values first (operand 0
    repeats each edge, operand 1 tiles them), then random canonical ones."""
    e = FIELD_EDGES.size
    pairs = np.repeat(FIELD_EDGES, e) if k % 2 == 0 else np.tile(FIELD_EDGES,
                                                                   e)
    v = np.random.default_rng(seed).integers(0, P, size=max(n, e * e),
                                             dtype=np.uint64)
    v[:e * e] = pairs
    return v[:n]


def _field_operands(layout, count, dev, seed=0):
    """``count`` int64 operands on ``dev`` in one of the layouts the
    prover gives the field ops."""
    out = []
    for k in range(count):
        def make(shape):
            n = int(np.prod(shape))
            v = _field_values(n, seed + k, k).reshape(shape)
            return gl.from_u64(v, dev).reshape(shape)
        if layout == "dense":
            out.append(make((1000,)))
        elif layout == "0-d":
            out.append(make(()) if k == 0 else make((37, 5)))
        elif layout == "row":
            out.append(make((1, 64)) if k % 2 == 0 else make((33, 64)))
        elif layout == "column":
            out.append(make((33, 1)) if k % 2 == 0 else make((33, 64)))
        elif layout == "strided":
            # the NTT's v[:, 0, 1] of a (-1, 2, 2, h, c) reshape, and the
            # (1, h, 1) twiddles
            if k % 2 == 0:
                out.append(make((512, 3)).reshape(-1, 2, 2, 4, 3)[:, 0, 1])
            else:
                out.append(make((4,)).reshape(1, 4, 1))
        elif layout == "transposed":
            out.append(make((20, 7)).t() if k % 2 == 0
                       else make((7, 20))[:, ::1])
        elif layout == "empty":
            out.append(make((0, 5)) if k % 2 == 0 else make((1, 5)))
    return out


FIELD_LAYOUTS = ["dense", "0-d", "row", "column", "strided", "transposed",
                 "empty"]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", FIELD_LAYOUTS)
@pytest.mark.parametrize("op", sorted(FIELD_OPS))
def test_field_kernel_matches_twin(cuda, op, layout):
    count, kern, twin, counter = FIELD_OPS[op]
    ops = _field_operands(layout, count, cuda)
    n0 = kf.launches[counter]
    got = kern(ops)
    want = twin(ops)
    assert kf.launches[counter] == n0 + (want[0].numel() > 0)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.device == w.device
        assert g.shape == w.shape and torch.equal(g, w), (op, layout)


def _path_operands(name, dev):
    """Operands of one path of the binary and ext_mul kernels (the binary
    kernel's path in the name): aligned and 8 bytes off 16, tails,
    broadcast rows, columns and scalars, transposed and rank-3 views."""
    def make(shape, seed):
        n = int(np.prod(shape))
        return gl.from_u64(_field_values(n, seed, seed).reshape(shape),
                           dev).reshape(shape)
    a = make((1 << 16) + 7, 1)
    m = make((300, 32), 2)
    v = make((4096, 8), 3).reshape(-1, 2, 2, 64, 8)
    return {
        "flat": (a[:1 << 16], make(1 << 16, 4)),
        "flat 8 bytes off 16": (a[1:(1 << 16) + 1], a[3:(1 << 16) + 3]),
        "general column and scalar": (m[:, 5], make((), 5)),
        "flat tail": (a[:1001], a[2:1003]),
        "rows column": (make((1000, 43), 6), make((1000, 1), 7)),
        "rows odd rows": (make((129, 45), 8)[:, 1:44], make((1, 43), 9)),
        "rows ntt": (v[:, 0, 1], make((64,), 10).reshape(1, 64, 1)),
        "rows rank 3": (make((4, 37, 300), 11), make((1, 37, 1), 12)),
        "tiled": (m[:, :16].t(), m[:, 16:].t()),
        "tiled ragged": (make((70, 1000), 13).t(), make((1000, 70), 14)),
        "tiled rank 3": (make((3, 40, 50), 15).transpose(1, 2),
                         make((3, 50, 40), 16)),
        "tiled 4 rows": (make((5000, 4), 19).t(), make((4, 5000), 20)),
        "general": (make((2, 3, 40, 5), 17).permute(0, 2, 1, 3),
                    make((2, 1, 3, 1), 18)),
    }[name]


PATH_CASES = ["flat", "flat 8 bytes off 16", "general column and scalar",
              "flat tail", "rows column", "rows odd rows", "rows ntt",
              "rows rank 3", "tiled", "tiled ragged", "tiled rank 3",
              "tiled 4 rows", "general"]


def _path_of(tensors, tiled):
    """The path of the field kernel that the wrapper plans for operands."""
    _, sizes, strides = kf.layout(*tensors)
    return kf.PATHS[kf.plan(sizes, strides, tiled)[0]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", PATH_CASES)
def test_field_kernel_paths_match_twin(cuda, name):
    a, b = _path_operands(name, cuda)
    path = name.split()[0]
    assert _path_of((a, b), True) == path
    for op in ("add", "sub", "mul"):
        n0 = kf.launches["gl_binary"]
        got = getattr(kf, op)(a, b)
        assert kf.launches["gl_binary"] == n0 + 1, op
        assert torch.equal(got, getattr(gl_plain, op)(a, b)), op
    # ext_mul has no tiled path: rows reads those views
    x, y = (a, b), (b, a)
    assert _path_of(x + y, False) == ("rows" if path == "tiled" else path)
    n0 = kf.launches["ext_mul"]
    got = kf.ext_mul(x, y)
    assert kf.launches["ext_mul"] == n0 + 1
    for g, w in zip(got, ext_plain.mul(x, y)):
        assert torch.equal(g, w)


def _partitions(k):
    """Groups of ext_prod over k columns: the permutation's 6-wide and the
    lookup's 4-wide runs, single columns (at most 8), one group of up to 8
    columns, and odd starts with gaps."""
    out = [[(s, min(s + 6, k)) for s in range(0, k, 6)],
           [(s, min(s + 4, k)) for s in range(0, k, 4)],
           [(c, c + 1) for c in range(min(k, 8))],
           [(k - min(k, 8), k)]]
    if k >= 5:
        out.append([(k - 2, k), (1, 3)])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3 * 128 + 5, (1 << 17) + 3])
@pytest.mark.parametrize("k", [16, 9, 5, 1])
def test_ext_prod_kernel_matches_twin(cuda, k, rows):
    """Every partition, with and without the leave-one-out sums, on halves
    that are staged (contiguous), direct (8 bytes off 16, rows of k + 1,
    transposed) and broadcast, against the plain twin bit for bit; one
    launch a call, each output a contiguous (rows,) vector."""
    def rand(shape, seed):
        return gl.from_u64(_rand_u64(shape, seed=seed), cuda)

    views = {
        "contiguous": rand((rows, k), k),
        "8 bytes off 16": rand((rows * k + 1,), k + 1)[1:].reshape(rows, k),
        "rows of k + 1": rand((rows, k + 1), k + 2)[:, :k],
        "transposed": rand((k, rows), k + 3).t(),
        "broadcast": gl.const(12345, device=cuda).expand(rows, k),
    }
    pairs = [("contiguous", "contiguous"), ("contiguous", "broadcast")]
    if rows < 1000:
        pairs += [(a, b) for a in views for b in views
                  if (a, b) not in pairs]
    modes = set()
    for first, second in pairs:
        t = (views[first], views[second])
        modes.add(tuple(kf.half_mode(h, k) for h in t))
        for groups in _partitions(k):
            for allbut in (False, True):
                n0 = kf.launches["ext_prod"]
                got = kf.ext_prod(t, groups, allbut)
                assert kf.launches["ext_prod"] == n0 + 1
                want = ext_plain.group_prod(t, groups, allbut)
                if not allbut:
                    got, want = (got,), (want,)
                for gs, ws in zip(got, want):
                    assert len(gs) == len(groups)
                    for g, w in zip(gs, ws):
                        for a, b in zip(g, w):
                            assert a.shape == (rows,) and a.is_contiguous()
                            assert torch.equal(a, b.expand(rows)), \
                                (first, second, groups, allbut)
    assert (kf.STAGED, kf.STAGED) in modes and (kf.STAGED, kf.BCAST) in modes
    for groups in ([(c, c + 1) for c in range(9)], [(0, 2), (1, 3)]):
        with pytest.raises(ValueError):
            kf.ext_prod((views["contiguous"],) * 2, groups)


@pytest.mark.cuda
@pytest.mark.parametrize("profiler_sees", [True, False])
def test_device_ms_names_its_method(cuda, monkeypatch, profiler_sees):
    from tpu_acir_prover_torch.kernels import field_bench as fb
    a = gl.from_u64(_rand_u64((1 << 16,), seed=5), cuda)
    if not profiler_sees:
        monkeypatch.setattr(fb, "device_totals",
                            lambda prof, kernels: (0, 0, {}, {}))
    ms, method = fb.device_ms(lambda: kf.add(a, a), ("gl_binary_kernel",))
    assert 0 < ms < 1
    if profiler_sees:
        assert method in fb.METHODS
    else:
        assert method == fb.METHODS[1]


@pytest.mark.cuda
def test_field_ops_reach_the_kernels_through_gl_and_ext(cuda):
    a, b = _field_operands("column", 2, cuda)
    before = dict(kf.launches)
    results = [gl.add(a, b), gl.sub(a, b), gl.mul(a, b), gl.sqr(a),
               gl.mul_const(b, 7), gl.pow_const(a, 5), gl.inv(b),
               *E.mul((a, b), (b, a)), *E.inv((a, b)), *E.sqr((a, b))]
    want = [gl_plain.add(a, b), gl_plain.sub(a, b), gl_plain.mul(a, b),
            gl_plain.sqr(a), gl_plain.mul_const(b, 7),
            gl_plain.pow_const(a, 5), gl_plain.inv(b),
            *ext_plain.mul((a, b), (b, a)), *ext_plain.inv((a, b)),
            *ext_plain.mul((a, b), (a, b))]
    for g, w in zip(results, want):
        assert torch.equal(g, w)
    grew = {k: kf.launches[k] - before[k] for k in before}
    assert grew == {"gl_binary": 5, "gl_pow": 2, "ext_mul": 2, "ext_inv": 1,
                    "ext_prod": 0}


@pytest.mark.cuda
def test_field_kernels_on_a_second_card(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    with torch.cuda.device(0):
        for op, (count, kern, twin, _) in sorted(FIELD_OPS.items()):
            ops = _field_operands("column", count, dev, seed=5)
            got = kern(ops)
            for g, w in zip(got, twin(ops)):
                assert g.device == dev and torch.equal(g, w), op


@pytest.mark.cuda
def test_field_kernels_in_a_cuda_graph(cuda):
    """A chain of every field kernel captured in a CUDA graph, replayed on
    new inputs copied into the captured ones, against the twins' chain."""
    a, b = (torch.empty((33, 64), dtype=torch.int64, device=cuda)
            for _ in range(2))
    col = torch.empty((33, 1), dtype=torch.int64, device=cuda)

    def chain(g, x, y, c):
        s = g["mul"](g["add"](x, c), g["sub"](y, c))
        t = g["inv"](s)
        e = g["ext_mul"]((s, t), (x, c))
        prods, sums = g["prod"]((s.reshape(-1, 16), t.reshape(-1, 16)),
                                [(0, 6), (6, 12), (12, 16)], True)
        return list(g["ext_inv"](e)) + [g["pow"](t)] + \
            [v for pair in prods + sums for v in pair]

    kern = {"add": kf.add, "sub": kf.sub, "mul": kf.mul,
            "inv": lambda x: kf.pow_const(x, P - 2),
            "pow": lambda x: kf.pow_const(x, POW_E),
            "ext_mul": kf.ext_mul, "ext_inv": kf.ext_inv,
            "prod": kf.ext_prod}
    twin = {"add": gl_plain.add, "sub": gl_plain.sub, "mul": gl_plain.mul,
            "inv": gl_plain.inv,
            "pow": lambda x: gl_plain.pow_const(x, POW_E),
            "ext_mul": ext_plain.mul, "ext_inv": ext_plain.inv,
            "prod": ext_plain.group_prod}

    def load(seed):
        x, y = _field_operands("row", 2, cuda, seed)
        a.copy_(x.expand(33, 64))
        b.copy_(y)
        col.copy_(_field_operands("column", 1, cuda, seed + 7)[0])

    load(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain(kern, a, b, col)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = dict(kf.launches)
    with torch.cuda.graph(graph):
        out = chain(kern, a, b, col)
    assert {k: kf.launches[k] - n0[k] for k in n0} == \
        {"gl_binary": 3, "gl_pow": 2, "ext_mul": 1, "ext_inv": 1,
         "ext_prod": 1}
    for seed in (11, 12):
        load(seed)
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(out, chain(twin, a, b, col)):
            assert torch.equal(g, w), seed


@functools.lru_cache(maxsize=None)
def _plain_tree(log_m):
    """Leaves (2^log_m, 4) on the card and every level above them, by the
    plain twin."""
    leaf = gl.from_u64(_rand_u64((1 << log_m, 4), seed=log_m), "cuda")
    return [leaf] + plain.two_to_one_levels(leaf, log_m)


def _launches_per_level_run(log_m, n):
    """Levels hashed by each launch of ``n`` levels above 2^log_m leaves:
    up to LEVELS_PER_LAUNCH while the child level is wide, up to
    NARROW_LEVELS from NARROW_CHILDREN children down."""
    runs = []
    while sum(runs) < n:
        wide = (1 << (log_m - sum(runs))) > kp.NARROW_CHILDREN
        runs.append(min(kp.LEVELS_PER_LAUNCH if wide else kp.NARROW_LEVELS,
                        n - sum(runs)))
    return runs


# Every launch the wrapper can make: 2^1 .. 2^12 leaves take only narrow
# launches (3 levels, and tails of 1 and 2); 2^16 .. 2^18 leaves start with
# wide launches of 2 levels, and of 1 up to a cap of half the leaves.
@pytest.mark.cuda
@pytest.mark.parametrize("log_m", list(range(1, 13)) + [16, 17, 18])
def test_merkle_levels_kernel_matches_twin(cuda, log_m):
    """Every tree to caps 1, 2, 16 and half its leaves, bit for bit, with
    the launches the wrapper's schedule makes."""
    want = _plain_tree(log_m)
    for cap in (1, 2, 16, 1 << (log_m - 1)):
        n = log_m - cap.bit_length() + 1
        if n < 1:
            continue
        n0 = kp.launches["two_to_one_level"]
        got = merkle_levels(want[0], cap)
        assert kp.launches["two_to_one_level"] - n0 == \
            len(_launches_per_level_run(log_m, n))
        assert len(got) == n + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), (log_m, cap)


@pytest.mark.cuda
def test_permute_kernel_matches_twin(cuda):
    st = gl.from_u64(_rand_u64((5000, 12), seed=10), cuda)
    assert torch.equal(kp.permute(st), plain.permute(st))
    with pytest.raises(ValueError):
        kp.permute(st.T.contiguous().T)  # not contiguous


def _views(n, seed, device):
    """n 0-d int64 views at nonzero offsets into two distinct tensors."""
    a = gl.from_u64(_rand_u64(n + 3, seed), device)
    b = gl.from_u64(_rand_u64(n + 5, seed + 1), device)
    return [a[2 + i] if i % 2 == 0 else b[n + 4 - i] for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(9))
def test_duplex_kernel_matches_twin(cuda, k):
    for seed in range(3):
        state = gl.from_u64(_rand_u64(12, seed=100 * k + seed), cuda)
        inputs = _views(k, 1000 * k + seed, cuda)
        n0 = kp.launches["duplex"]
        got = kp.duplex(state, inputs)
        assert kp.launches["duplex"] == n0 + 1
        assert torch.equal(got, plain.duplex(state, inputs)), (k, seed)


@pytest.mark.cuda
def test_duplex_chain_in_a_graph(cuda):
    """50 duplexes captured in one CUDA graph, each absorbing views into
    tensors that the graph reads, replayed twice with new values in those
    tensors: equal to the eager twin each time."""
    pool = gl.from_u64(_rand_u64((50, 10), seed=7), cuda)
    state0 = gl.from_u64(_rand_u64(12, seed=8), cuda)

    def chain():
        st = state0
        for i in range(50):
            st = kp.duplex(st, list(pool[i, 1:1 + (i % 9)].unbind()))
        return st

    chain()  # loads the kernels and the constants, off the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n0 = kp.launches["duplex"]
    with torch.cuda.graph(graph):
        out = chain()
    assert kp.launches["duplex"] == n0 + 50
    for seed in (9, 10):
        pool.copy_(gl.from_u64(_rand_u64((50, 10), seed=seed), cuda))
        state0.copy_(gl.from_u64(_rand_u64(12, seed=seed + 5), cuda))
        graph.replay()
        st = state0
        for i in range(50):
            st = plain.duplex(st, list(pool[i, 1:1 + (i % 9)].unbind()))
        assert torch.equal(out, st), seed


@pytest.mark.cuda
@pytest.mark.parametrize("pow_bits", [1, 4, 8, 16, 20])
def test_grind_kernel_matches_twin(cuda, pow_bits):
    """The smallest hit, as the twin's scan of batches in order finds it,
    for every nonce lane with that many inputs pending (views into other
    tensors), and from an absorbed state with none pending."""
    for lane in range(8):
        st = gl.from_u64(_rand_u64(12, seed=lane + 16 * pow_bits), cuda)
        inputs = _views(lane, 50 * pow_bits + lane, cuda)
        n0 = kp.launches["grind"]
        got = kp.grind(st, lane, pow_bits, inputs)
        assert kp.launches["grind"] == n0 + 1
        want = plain.grind(st, lane, pow_bits, inputs)
        assert int(got) == int(want) < 1 << 32, (pow_bits, lane)
        got = kp.grind(plain.absorb(st, inputs), lane, pow_bits)
        assert int(got) == int(want)


def _lookup_circuit():
    b = CircuitBuilder(lookup_bits=8)
    for bits in (8, 5, 19):
        b.range_check(b.add_external(), bits)
    return compile_circuit(b)


def _small(name):
    if name == "fibonacci":
        prog, wm = circuits.fibonacci()
        tr = translate_program(prog)
        return compile_circuit(tr.builder), tr.external_values(wm)
    return _lookup_circuit(), np.array([200, 31, (1 << 19) - 3], np.uint64)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fibonacci", "lookup_bits=8"])
def test_fused_graph_bytes_equal_per_phase(cuda, name):
    cc, ext = _small(name)
    pk = ProvingKey(cc, TEST_CONFIG, device=cuda)
    want = serialize_proof(prove(pk, ext))
    proof = prove_fused(pk, ext)
    verify(pk.vk, proof)
    assert serialize_proof(proof) == want
    # the proof came from a replay of a captured graph that holds every
    # kernel of the path; the batched permute is not one of them since the
    # transcript duplexes with its own kernel
    held = pk._captured.launches
    assert held["permute"] == 0
    assert all(held[k] > 0 for k in {**kp.launches, **kf.launches}
               if k != "permute")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fibonacci", "lookup_bits=8"])
def test_column_blocked_commits_in_a_graph_equal_cpu(cuda, name,
                                                     monkeypatch):
    """Two columns a block: the key's commit, the proof's commits and the
    FRI combination run over several column blocks, in the fused graph and
    per-phase on the card; the bytes of the one-block proof on the CPU."""
    cc, ext = _small(name)
    want = serialize_proof(prove(ProvingKey(cc, TEST_CONFIG, device="cpu"),
                                 ext))
    monkeypatch.setattr(prove_mod, "COMMIT_BLOCK",
                        2 << (cc.log_n + TEST_CONFIG.rate_bits))
    pk = ProvingKey(cc, TEST_CONFIG, device=cuda)
    proof = prove_fused(pk, ext)
    verify(pk.vk, proof)
    assert serialize_proof(proof) == want
    assert serialize_proof(prove(pk, ext)) == want


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", ["fibonacci", "lookup_bits=8"])
def test_sharded_proof_on_the_card_equals_cpu(cuda, name, shards):
    """prove_sharded with every shard on the card: the bytes of the port's
    single-device proof on the CPU, through the kernels."""
    cc, ext = _small(name)
    want = serialize_proof(prove(ProvingKey(cc, TEST_CONFIG, device="cpu"),
                                 ext))
    mesh = Mesh.on(cuda, shards)
    spk = ShardedProvingKey(cc, TEST_CONFIG, mesh=mesh)
    before = dict(kp.launches)
    proof = prove_sharded(spk, ext)
    verify(spk.vk, proof)
    assert serialize_proof(proof) == want
    for k in ("leaf_hash", "two_to_one_level", "grind"):
        assert kp.launches[k] > before[k], k


@pytest.mark.cuda
def test_sharded_fri_layer_on_the_card_equals_cpu(cuda):
    m, cap_height, d = 1 << 14, 4, 4
    shift = gl.MULTIPLICATIVE_GENERATOR
    vals = [_rand_u64(m, seed=s) for s in (30, 31)]
    beta = (int(_rand_u64(1, 32)[0]), int(_rand_u64(1, 33)[0]))
    inv2x = layer_inv2x_padded(m, shift)
    got = []
    for dev in ("cpu", cuda):
        mesh = Mesh.on(dev, d)
        run = make_sharded_fri_layer(mesh, m, cap_height)
        caps, nxt = run(tuple(mesh.scatter(gl.from_u64(v, dev))
                              for v in vals),
                        mesh.scatter(gl.from_u64(inv2x, dev)), beta)
        got.append((caps, [gl.to_u64(torch.cat(c)) for c in nxt]))
    (caps_cpu, nxt_cpu), (caps_card, nxt_card) = got
    assert caps_card == caps_cpu and len(caps_cpu) == 16
    for a, b in zip(nxt_card, nxt_cpu):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_one_graph_proves_two_witnesses(cuda):
    """A replay overwrites the last one's inputs and outputs: two different
    witnesses in a row, and the first again, through one captured graph."""
    pk = ProvingKey(_lookup_circuit(), TEST_CONFIG, device=cuda)
    a, b = [200, 31, (1 << 19) - 3], [17, 3, 12345]
    exts = [np.array(v, np.uint64) for v in (a, b, a)]
    got = []
    for ext in exts:
        proof = prove_fused(pk, ext)
        verify(pk.vk, proof)
        got.append(serialize_proof(proof))
        if len(got) == 1:
            graph = pk._captured
        assert pk._captured is graph
    assert got[0] == got[2] != got[1]
    assert got[1] == serialize_proof(prove(pk, exts[1]))
