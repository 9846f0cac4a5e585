"""The field kernels' paths (``kernels/field.plan``) and ext_prod's reads
on the CPU: each path's index map, written here as ``csrc/field.cu``
computes it, reads the elements ``torch.broadcast_tensors`` gives and
writes each output element once; the per-phase, fused and sharded
provers' operand tuples each get a path; ``ext_plain.prod`` (the twin of
``ext_prod_kernel``) against the JAX package's numpy ``make_ext`` fold.
The kernels themselves run in ``tests/test_torch_cuda.py`` on the card."""

import numpy as np
import pytest
import torch

from tpu_acir_prover.field import ext as jext
from tpu_acir_prover.field import gl as jgl
from tpu_acir_prover_torch.field import ext as E
from tpu_acir_prover_torch.field import ext_plain, gl
from tpu_acir_prover_torch.field.gl import P
from tpu_acir_prover_torch.kernels import field as kf
from tpu_acir_prover_torch.prover.prove import _fold

torch.set_num_threads(1)

G = jgl.make_gl(np)
EXT = jext.make_ext(G)
EDGES = [0, P - 1, 1 << 32, (1 << 32) - 1]


def _u64(shape, seed):
    """Canonical values from a seed, the edge values at the front."""
    v = np.random.default_rng(seed).integers(0, P, size=shape,
                                             dtype=np.uint64).reshape(-1)
    k = min(v.size, len(EDGES))
    v[:k] = np.array(EDGES[:k], dtype=np.uint64)
    return v.reshape(shape)


def _t(shape, seed=0):
    return gl.from_u64(_u64(shape, seed), "cpu").reshape(shape)


def _path_reads(sizes, strides, path, grid, block):
    """(offsets, writes) of a launch as the path's kernel computes them:
    offsets[k][i], the element of operand k read for output element i
    (row-major over ``sizes``), and writes[i], how often element i is
    stored."""
    n = int(np.prod(sizes))
    rank = len(sizes)
    st = [np.array(s, dtype=np.int64) for s in strides]
    offs = [np.full(n, -1, dtype=np.int64) for _ in strides]
    writes = np.zeros(n, dtype=np.int64)
    gx, gy, gz = grid
    bx, by = block

    def put(out, reads, ok):
        out, ok = out[ok], ok
        np.add.at(writes, out, 1)
        for k, r in enumerate(reads):
            offs[k][out] = r[ok]

    if path == kf.FLAT:
        # block b's thread t: the pairs at 4 b B + 2 t and 4 b B + 2 B + 2 t
        assert rank == 1 and by == 1 and gx * bx * kf.VEC >= n
        b, t = np.meshgrid(np.arange(gx), np.arange(bx), indexing="ij")
        first = (kf.VEC * b * bx + 2 * t).ravel()
        for d in (0, 1, 2 * bx, 2 * bx + 1):
            i = first + d
            put(i, [i * s[0] for s in st], (i < n) & (first < n))
    elif path == kf.ROWS:
        # thread x of the grid: the four elements from 4 x of each row
        assert rank in (2, 3) and bx * by <= kf.THREADS
        length, rows = sizes[-1], sizes[-2]
        outer = sizes[0] if rank == 3 else 1
        assert gx * bx * kf.VEC >= length and gy <= kf.MAX_GRID_YZ
        c = kf.VEC * np.arange(gx * bx, dtype=np.int64)
        for z0 in range(gz):
            for z in range(z0, outer, gz):
                for y0 in range(gy * by):
                    for y in range(y0, rows, gy * by):
                        base = [(z * s[0] if rank == 3 else 0) + y * s[-2]
                                for s in st]
                        for e in range(kf.VEC):
                            col = c + e
                            put((z * rows + y) * length + col,
                                [b + col * s[-1] for b, s in zip(base, st)],
                                (c < length) & (col < length))
    elif path == kf.TILED:
        assert rank in (2, 3) and block == (kf.THREADS, 1)
        cols, rows = sizes[-1], sizes[-2]
        outer = sizes[0] if rank == 3 else 1
        staged = [s[-2] == 1 and s[-1] not in (0, 1) for s in st]
        tr = kf.tile_rows(rows)
        tc = kf.TILE // tr
        assert any(staged) and gx * tc >= cols
        # thread t's elements u = t + 256 q: staged at (row u mod tr, col
        # u / tr) into tile[col (tr + 1) + row], computed at (row u / tc,
        # col u mod tc) from there
        u = np.arange(kf.TILE)
        si, sj = u % tr, u // tr
        ci, cj = u // tc, u % tc
        for z0 in range(gz):
            for z in range(z0, outer, gz):
                zoff = [z * s[0] if rank == 3 else 0 for s in st]
                for bxi in range(gx):
                    j0 = bxi * tc
                    for t0 in range(gy):
                        for t in range(t0, -(-rows // tr), gy):
                            i0 = t * tr
                            tiles = []
                            for k, s in enumerate(st):
                                tk = np.full(tc * (tr + 1), -1,
                                             dtype=np.int64)
                                ok = (i0 + si < rows) & (j0 + sj < cols)
                                tk[sj[ok] * (tr + 1) + si[ok]] = \
                                    zoff[k] + i0 + si[ok] + \
                                    (j0 + sj[ok]) * s[-1]
                                tiles.append(tk)
                            i, j = i0 + ci, j0 + cj
                            ok = (i < rows) & (j < cols)
                            reads = [tiles[k][cj * (tr + 1) + ci]
                                     if staged[k] else
                                     zoff[k] + i * s[-2] + j * s[-1]
                                     for k, s in enumerate(st)]
                            put((z * rows + i) * cols + j, reads, ok)
    else:
        assert path == kf.GENERAL and gx * bx >= n
        i = np.arange(n, dtype=np.int64)
        rem, reads = i.copy(), [np.zeros(n, dtype=np.int64) for _ in st]
        for d in range(rank - 1, -1, -1):
            c = rem % sizes[d] if d else rem
            rem = rem // sizes[d]
            for r, s in zip(reads, st):
                r += c * s[d]
        put(i, reads, np.ones(n, dtype=bool))
    return offs, writes


def _check_paths(tensors, tiled=True, want=None):
    """The launch's path reads each operand as torch broadcasts it and
    writes every output element once; returns the path's name."""
    shape, sizes, strides = kf.layout(*tensors)
    path, grid, block = kf.plan(sizes, strides, tiled)
    if want is not None:
        assert kf.PATHS[path] == want, (sizes, strides)
    offs, writes = _path_reads(sizes, strides, path, grid, block)
    assert (writes == 1).all()
    for t, off, w in zip(tensors, offs, torch.broadcast_tensors(*tensors)):
        flat = torch.as_strided(t, (t.untyped_storage().nbytes() // 8,),
                                (1,), 0)
        got = flat[torch.from_numpy(off + t.storage_offset())]
        assert torch.equal(got.reshape(w.shape), w)
    return kf.PATHS[path]


def _views():
    """Operand tuples of every path, each with the binary kernel's path
    for it."""
    a = _t((4099,), 1)
    m = _t((100, 32), 2)
    v = _t((512, 3), 3).reshape(-1, 2, 2, 4, 3)
    tw = _t((4,), 4).reshape(1, 4, 1)
    w3 = _t((3, 40, 50), 5).transpose(1, 2)
    return {
        "flat": ((a[:4097], _t((4097,), 6)), "flat"),
        "flat, 8 bytes off 16": ((a[1:4098], a[2:4099]), "flat"),
        "general, a column and a scalar": ((m[:, 3], gl.const(5, m)),
                                           "general"),
        "flat, a tail": ((a[:7], a[5:12]), "flat"),
        "rows, a coset column": ((_t((70, 43), 7), _t((70, 1), 8)), "rows"),
        "rows, a broadcast row": ((_t((33, 64), 9), _t((1, 64), 10)),
                                  "rows"),
        "rows, odd rows off 16": ((_t((9, 45), 11)[:, 1:44],
                                   _t((9, 43), 12)), "rows"),
        "rows, NTT quarter x twiddles": ((v[:, 0, 1], tw), "rows"),
        "rows, rank 3": ((_t((4, 6, 21), 13), _t((1, 6, 1), 14)), "rows"),
        "rows, 2 columns": ((_t((300, 2), 15), _t((300, 1), 16)), "rows"),
        "tiled, both transposed": ((m[:, :16].t(), m[:, 16:].t()), "tiled"),
        "tiled, ragged": ((_t((70, 40), 17).t(), _t((40, 70), 18)),
                          "tiled"),
        "tiled, rank 3": ((w3, _t((3, 50, 40), 19)), "tiled"),
        "tiled, 3 rows": ((_t((1500, 3), 24).t(), _t((3, 1500), 25)),
                          "tiled"),
        "tiled, second operand": ((_t((7, 20), 20), _t((20, 7), 21).t()),
                                  "tiled"),
        "general, rank 4": ((_t((2, 3, 4, 5), 22).permute(0, 2, 1, 3),
                             _t((2, 1, 3, 1), 23)), "general"),
    }


VIEWS = _views()


@pytest.mark.parametrize("name", sorted(VIEWS))
def test_path_index_map_reads_the_broadcast_operands(name):
    tensors, want = VIEWS[name]
    assert _check_paths(tensors, want=want) == want
    # ext_mul's four operands have no tiled path: rows takes those views
    ext = _check_paths(tensors + tensors, tiled=False)
    assert ext == ("rows" if want == "tiled" else want)


@pytest.mark.parametrize("sizes,strides,want", [
    # the largest recorded layout of some classes the provers gave the
    # binary kernel at 2^17-2^20 rows
    ([16, 1 << 21], [[1, 32], [1, 32]], "tiled"),
    ([1 << 21, 42], [[42, 1], [1, 0]], "rows"),
    ([4, 256, 21504], [[5505024, 21504, 1], [0, 4, 0]], "rows"),
    ([1 << 18], [[0], [43]], "general"),
    ([44040192], [[1], [1]], "flat"),
    ([2, 3, 4, 5], [[60, 20, 5, 1], [0, 0, 0, 1]], "general"),
])
def test_plan_of_the_main_paths_layouts(sizes, strides, want):
    path, grid, block = kf.plan(sizes, strides)
    assert kf.PATHS[path] == want
    assert max(grid[1:]) <= kf.MAX_GRID_YZ
    assert block[0] * block[1] <= kf.THREADS
    if want in ("flat", "rows", "tiled"):
        width = kf.TILE // kf.tile_rows(sizes[-2]) if want == "tiled" \
            else kf.VEC * block[0]
        assert grid[0] * width >= sizes[-1]


def _prod_reads(t, cols):
    """The value ext_prod_kernel reads for (row, column j of cols) of each
    half, as it reads them (row * row stride + column * column stride from
    the half's storage offset), from each half's storage."""
    rows, _ = t[0].shape
    got = []
    for h in t:
        rs, cs = h.stride()
        flat = gl.to_u64(torch.as_strided(
            h, (h.untyped_storage().nbytes() // 8,), (1,), 0)).view(np.int64)
        r = np.arange(rows)[:, None]
        c = np.array(cols)[None, :]
        got.append(torch.from_numpy(flat[h.storage_offset() + r * rs +
                                         c * cs]))
    return got


@pytest.mark.parametrize("k,cols", [
    (16, [0, 1, 2, 3, 4, 5]), (16, [6, 7, 8, 9, 10, 11]),
    (16, [12, 13, 14, 15]), (16, [13, 15]), (17, [1, 2, 3]),
    (5, [0, 1, 2, 3, 4]), (16, [0, 15]), (9, [8, 0, 4])])
def test_ext_prod_reads_the_listed_columns(k, cols):
    rows = 2 * kf.PROD_ROWS + 3
    re = _t((rows, k), k)
    off = _t((rows * k + 1,), k + 3)[1:].reshape(rows, k)
    for first in (re, off):
        for im in (_t((rows, k), k + 1), gl.const(9, re).expand(rows, k),
                   _t((k, rows), k + 2).t()):
            got = _prod_reads((first, im), cols)
            for g, h in zip(got, (first, im)):
                assert torch.equal(g, h[:, cols])


def _limbs(v):
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


@pytest.mark.parametrize("count", range(1, 9))
def test_prod_matches_the_numpy_ext_fold(count):
    rows, k = 40, 16
    v0, v1 = _u64((rows, k), count), _u64((rows, k), 50 + count)
    # the edge values in every listed column, against each other
    edge = np.array(EDGES, dtype=np.uint64)
    v0[:16] = np.repeat(edge, 4)[:, None]
    v1[:16] = np.tile(edge, 4)[:, None]
    t = (gl.from_u64(v0, "cpu"), gl.from_u64(v1, "cpu"))
    starts = sorted({0, k - count, (k - count) // 2})
    for s in starts:
        cols = list(range(s, s + count))
        got = ext_plain.prod(t, cols)
        assert all(torch.equal(a, b) for a, b in
                   zip(got, E.prod(t, cols)))
        assert all(torch.equal(a, b) for a, b in zip(got, _fold(
            E.mul, [(t[0][:, c], t[1][:, c]) for c in cols])))
        want = None
        for c in cols:
            x = (_limbs(v0[:, c]), _limbs(v1[:, c]))
            want = x if want is None else EXT.mul(want, x)
        for g, w in zip(got, want):
            assert np.array_equal(gl.to_u64(g), G.to_u64(w))


def test_prod_allbut_sets_match_the_numpy_ext_fold():
    """The lookup constraint's products over a group's columns without
    column i, on a broadcast imaginary half, as the quotient takes them."""
    rows, k = 33, 16
    re = _t((rows, k), 90)
    im = gl.const((1 << 32) - 1, re).expand(rows, k)
    for s, e in ((0, 4), (12, 16), (4, 8)):
        cols = list(range(s, e))
        for i in range(len(cols)):
            sub = cols[:i] + cols[i + 1:]
            got = E.prod((re, im), sub)
            want = None
            for c in sub:
                x = (_limbs(gl.to_u64(re[:, c])),
                     _limbs(gl.to_u64(im[:, c]).copy()))
                want = x if want is None else EXT.mul(want, x)
            for g, w in zip(got, want):
                assert np.array_equal(gl.to_u64(g), G.to_u64(w))


def test_prod_raises_on_what_the_kernel_does_not_take():
    t = (_t((8, 16), 1), _t((8, 16), 2))
    for cols in ([], list(range(9)), [16], [-1]):
        with pytest.raises(ValueError):
            E.prod(t, cols)
    with pytest.raises(ValueError):
        E.prod((t[0], t[1][:, :8]), [0, 1])
    with pytest.raises(ValueError):
        E.prod((t[0][0], t[1][0]), [0, 1])


def test_every_prover_operand_tuple_gets_a_path(monkeypatch):
    """Every operand tuple the per-phase, fused and sharded provers hand
    the binary kernel, ext_mul and ext_prod on a small lookup circuit: the
    path's index map reads it as torch broadcasts it, and no tuple of
    2^8 or more elements takes the general path but a strided column
    (rank 1)."""
    from tpu_acir_prover_torch.circuit.builder import CircuitBuilder
    from tpu_acir_prover_torch.circuit.compile import compile_circuit
    from tpu_acir_prover_torch.parallel.mesh import Mesh
    from tpu_acir_prover_torch.parallel.prove import (ShardedProvingKey,
                                                      prove_sharded)
    from tpu_acir_prover_torch.prover.config import TEST_CONFIG
    from tpu_acir_prover_torch.prover.fused import prove_fused
    from tpu_acir_prover_torch.prover.prove import ProvingKey, prove

    seen, prods = {}, {}
    route, ext_prod = kf._route, kf.ext_prod

    def spy(tensors, what):
        key = (what,) + tuple((tuple(t.shape), t.stride()) for t in tensors)
        seen.setdefault(key, tuple(tensors))
        return route(tensors, what)

    def prod_spy(t, cols):
        cols = list(cols)
        prods.setdefault((tuple(cols), t[0].stride(), t[1].stride()),
                         (t, cols))
        return ext_prod(t, cols)

    monkeypatch.setattr(kf, "_route", spy)
    monkeypatch.setattr(kf, "ext_prod", prod_spy)
    b = CircuitBuilder(lookup_bits=8)
    x = b.add_external()
    b.range_check(x, 8)
    y = b.add_external()
    b.range_check(y, 5)
    cc = compile_circuit(b)
    ext = np.array([200, 31], dtype=np.uint64)
    pk = ProvingKey(cc, TEST_CONFIG, device="cpu")
    prove(pk, ext)
    prove_fused(pk, ext)
    prove_sharded(ShardedProvingKey(cc, TEST_CONFIG,
                                    mesh=Mesh.on("cpu", 2)), ext)
    paths = set()
    for key, tensors in seen.items():
        if key[0] in ("add", "sub", "mul", "ext_mul"):
            path = _check_paths(tensors, tiled=key[0] != "ext_mul")
            if torch.broadcast_shapes(*(t.shape for t in tensors)) \
                    .numel() >= 256 and path == "general":
                assert len(kf.layout(*tensors)[1]) == 1, key
            paths.add(path)
    assert {"flat", "rows", "tiled"} <= paths
    assert prods
    for (cols, _, _), (t, cols) in prods.items():
        assert 1 <= len(cols) <= kf.PROD_MAX_COLS
        got = _prod_reads(t, cols)
        for g, h in zip(got, t):
            assert torch.equal(g, h[:, cols])
