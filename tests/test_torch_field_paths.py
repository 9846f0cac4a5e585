"""The field kernels' paths (``kernels/field.plan``) and ext_prod's reads
on the CPU: each path's index map, written here as ``csrc/field.cu``
computes it, reads the elements ``torch.broadcast_tensors`` gives and
writes each output element once; ext_prod's staged tiles and direct reads
read the listed columns; the per-phase, fused and sharded provers' operand
tuples each get a path; ``ext_plain.group_prod`` (the twin of
``ext_prod_kernel``) against the JAX package's numpy ``grouped_fold`` and
prefix x suffix sums, and its ``make_ext`` fold.  The kernels themselves
run in ``tests/test_torch_cuda.py`` on the card."""

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


def _storage(h):
    """The u64 bits of the whole storage under the view ``h``, as int64."""
    return gl.to_u64(torch.as_strided(
        h, (h.untyped_storage().nbytes() // 8,), (1,), 0)).view(np.int64)


def _group_reads(t, groups):
    """The value ext_prod_kernel reads for (row, column c) of each half, c
    over the groups' columns, as it reads them: a broadcast half once from
    its storage offset; a direct half at row * row stride + c * column
    stride; a staged half from the tile of its row, which holds the
    tile's rows * k values from the row's storage, chunk q (values 2q, 2q
    + 1; the last one's second zero past the tile) in slot
    ``kf.tile_slot(q)``, read as value f = r k + c of the tile, local row
    r: at f & 1 in slot tile_slot(f >> 1).  Returns each half's (rows,
    columns) values and its mode."""
    rows, k = t[0].shape
    cols = np.array([c for s, e in groups for c in range(s, e)])
    got = []
    for h in t:
        mode = kf.half_mode(h, k)
        flat, off = _storage(h), h.storage_offset()
        rs, cs = h.stride()
        if mode == kf.BCAST:
            vals = np.full((rows, len(cols)), flat[off], dtype=np.int64)
        elif mode == kf.DIRECT:
            r = np.arange(rows)[:, None]
            vals = flat[off + r * rs + cols[None, :] * cs]
        else:
            assert (rs, cs) == (k, 1) and h.data_ptr() % 16 == 0
            vals = np.empty((rows, len(cols)), dtype=np.int64)
            for row0 in range(0, rows, kf.GP_ROWS):
                words = min(kf.GP_ROWS, rows - row0) * k
                q = np.arange((words + 1) // 2)
                slot = kf.tile_slot(q)
                # slots: one a chunk, inside the tile's GP_ROWS * k values
                assert len(set(slot.tolist())) == len(q)
                assert slot.max() < kf.GP_ROWS * k // 2
                tile = np.full(kf.GP_ROWS * k, -1, dtype=np.int64)
                src = flat[off + row0 * k:off + row0 * k + words]
                tile[2 * slot] = src[2 * q]
                tile[2 * slot + 1] = np.where(
                    2 * q + 1 < words, src[np.minimum(2 * q + 1, words - 1)],
                    0)
                r = np.arange(words // k)[:, None]
                f = r * k + cols[None, :]
                vals[row0:row0 + words // k] = \
                    tile[2 * kf.tile_slot(f >> 1) + (f & 1)]
        got.append((torch.from_numpy(vals), mode))
    return got


def _layouts(rows, k, seed):
    """Halves of a (rows, k) pair in every layout ext_prod takes, each
    with the mode it reads it in: contiguous (staged), broadcast, 8 bytes
    off 16 (direct), rows of k + 1 (direct), transposed (direct)."""
    return {
        "contiguous": (_t((rows, k), seed), kf.STAGED),
        "broadcast": (gl.const((1 << 32) - 1, device="cpu").expand(rows, k),
                      kf.BCAST),
        "8 bytes off 16": (_t((rows * k + 1,), seed + 1)[1:].reshape(rows, k),
                           kf.DIRECT),
        "rows of k + 1": (_t((rows, k + 1), seed + 2)[:, :k], kf.DIRECT),
        "transposed": (_t((k, rows), seed + 3).t(), kf.DIRECT),
    }


# (k, groups) of ext_prod: the permutation's and the lookup's partitions of
# the 16 wires, groups of 1 to 8 columns, gaps, odd starts, k from 1 to 16
PARTITIONS = {
    "perm 6, 6, 4": (16, [(0, 6), (6, 12), (12, 16)]),
    "lookup 4 x 4": (16, [(0, 4), (4, 8), (8, 12), (12, 16)]),
    "1, 2, 3, 4, 5 columns": (16, [(0, 1), (1, 3), (3, 6), (6, 10),
                                   (10, 15)]),
    "8, 6, 2 columns": (16, [(8, 16), (2, 8), (0, 2)]),
    "7 and 3, gaps": (16, [(9, 16), (1, 4)]),
    "8 groups of 1": (16, [(c, c + 1) for c in range(1, 16, 2)]),
    "k 1": (1, [(0, 1)]),
    "k 5, odd": (5, [(0, 2), (2, 5)]),
    "k 9, odd, gaps": (9, [(8, 9), (0, 4), (5, 8)]),
    "k 12": (12, [(3, 11)]),
}


@pytest.mark.parametrize("first", ["contiguous", "8 bytes off 16",
                                   "rows of k + 1", "transposed"])
@pytest.mark.parametrize("name", sorted(PARTITIONS))
def test_ext_prod_reads_the_listed_columns(name, first):
    """The kernel's index map, staged and direct, against the halves'
    values for each partition, the second half in every layout."""
    k, groups = PARTITIONS[name]
    rows = 2 * kf.GP_ROWS + 3      # a last tile of 3 rows
    views = _layouts(rows, k, k)
    cols = [c for s, e in groups for c in range(s, e)]
    for second in views:
        t = (views[first][0], views[second][0])
        for (vals, mode), h, want in zip(_group_reads(t, groups), t,
                                         (views[first][1],
                                          views[second][1])):
            assert mode == want
            assert torch.equal(vals, h[:, cols])


def test_staged_tile_reads_are_free_of_bank_conflicts():
    """At k = 16 the eight rows of a quarter warp read two neighbouring
    columns from even values with one 16-byte load each: eight different
    16-byte bank groups (of eight) for every column pair and row offset."""
    k = 16
    for r0 in range(0, kf.GP_ROWS, 8):
        for c in range(0, k, 2):
            f = (r0 + np.arange(8)) * k + c
            assert len(set((kf.tile_slot(f >> 1) % 8).tolist())) == 8


def _limbs(v):
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


def _jax_group_values(v0, v1, groups, k):
    """The JAX package's numpy grouped products and leave-one-out sums of
    the (rows, k) u64 halves v0, v1, as its quotient computes them
    (``grouped_fold``; ``_axis_excl_products`` prefix x suffix, masked,
    folded with add): two lists of (re, im) u64 arrays."""
    from tpu_acir_prover.prover import prove as jprove
    fmat = (_limbs(v0), _limbs(v1))
    prods = jprove.grouped_fold(G, EXT, fmat, groups, EXT.mul,
                                jprove._EXT_ONE_NEUTRAL)
    idxd, maskd, _ = jprove._group_gather(G, groups, k)
    tens = jprove._group_tensor(G, fmat, idxd, maskd,
                                jprove._EXT_ONE_NEUTRAL)
    allbut = EXT.mul(jprove._axis_excl_products(EXT, tens),
                     jprove._axis_excl_products(EXT, tens, reverse=True))
    ab0 = tuple(tuple(np.where(maskd, c, np.uint32(0)) for c in comp)
                for comp in allbut)
    sums = jprove._fold_last_axis(EXT.add, ab0)

    def split(x):
        return [(G.to_u64(x[0])[:, g], G.to_u64(x[1])[:, g])
                for g in range(len(groups))]
    return split(prods), split(sums)


@pytest.mark.parametrize("allbut", [False, True])
@pytest.mark.parametrize("im", ["values", "broadcast"])
@pytest.mark.parametrize("name", sorted(PARTITIONS))
def test_group_prod_matches_the_jax_grouped_fold(name, im, allbut):
    """The plain twin (``E.group_prod`` on CPU tensors) against the JAX
    package's numpy ``grouped_fold`` and prefix x suffix sums."""
    k, groups = PARTITIONS[name]
    rows = 40
    v0 = _u64((rows, k), k)
    v1 = _u64((rows, k), 50 + k) if im == "values" else \
        np.full((rows, k), (1 << 32) - 1, dtype=np.uint64)
    t = (gl.from_u64(v0, "cpu"), gl.from_u64(v1, "cpu"))
    if im == "broadcast":
        t = (t[0], gl.const((1 << 32) - 1, device="cpu").expand(rows, k))
    got = E.group_prod(t, groups, allbut)
    prods, sums = _jax_group_values(v0, v1, groups, k)
    for lists in ((got[0], prods), (got[1], sums)) if allbut else \
            ((got, prods),):
        assert len(lists[0]) == len(groups)
        for g, w in zip(*lists):
            for a, b in zip(g, w):
                assert np.array_equal(gl.to_u64(a.expand(rows)), b)


@pytest.mark.parametrize("count", range(1, 9))
def test_prod_matches_the_numpy_ext_fold(count):
    """A group of ``count`` columns at three starts, with every edge value
    against every other, against a sequential fold of the JAX package's
    numpy ext ``mul``; the grouped twin also against ``_fold`` of
    ``E.mul``."""
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
        (got,) = E.group_prod(t, [(s, s + count)])
        assert all(torch.equal(a, b) for a, b in zip(got, _fold(
            E.mul, [(t[0][:, c], t[1][:, c]) for c in cols])))
        want = None
        for c in cols:
            x = (_limbs(v0[:, c]), _limbs(v1[:, c]))
            want = x if want is None else EXT.mul(want, x)
        for g, w in zip(got, want):
            assert np.array_equal(gl.to_u64(g), G.to_u64(w))


def test_prod_allbut_sets_match_the_numpy_ext_fold():
    """The lookup constraint's sum over a group's columns i of the product
    of the others, on a broadcast imaginary half, as the quotient takes
    them, against sequential folds of the JAX package's numpy ext ``mul``
    and ``add``; a group of one column sums to 1."""
    rows, k = 33, 16
    re = _t((rows, k), 90)
    im = gl.const((1 << 32) - 1, re).expand(rows, k)
    groups = [(0, 4), (12, 16), (4, 8), (9, 10), (10, 12)]
    prods, sums = E.group_prod((re, im), groups, allbut=True)
    for (s, e), got in zip(groups, sums):
        cols = list(range(s, e))
        want = None
        for i in range(len(cols)):
            term = (_limbs(np.ones(rows, dtype=np.uint64)),
                    _limbs(np.zeros(rows, dtype=np.uint64)))
            for c in cols[:i] + cols[i + 1:]:
                term = EXT.mul(term, (_limbs(gl.to_u64(re[:, c])),
                                      _limbs(gl.to_u64(im[:, c]).copy())))
            want = term if want is None else EXT.add(want, term)
        for g, w in zip(got, want):
            assert np.array_equal(gl.to_u64(g.expand(rows)), G.to_u64(w))


@pytest.mark.parametrize("case", [
    "no group", "9 groups", "9 columns", "overlap", "past k", "empty group",
    "17 columns", "halves of two shapes", "rank 1", "int32"])
def test_prod_raises_on_what_the_kernel_does_not_take(case):
    t = (_t((8, 16), 1), _t((8, 16), 2))
    groups = [(0, 4)]
    if case == "no group":
        groups = []
    elif case == "9 groups":
        t = (_t((8, 9), 1), _t((8, 9), 2))
        groups = [(c, c + 1) for c in range(9)]
    elif case == "9 columns":
        groups = [(0, 9)]
    elif case == "overlap":
        groups = [(0, 4), (3, 6)]
    elif case == "past k":
        groups = [(14, 17)]
    elif case == "empty group":
        groups = [(2, 2)]
    elif case == "17 columns":
        t = (_t((8, 17), 1), _t((8, 17), 2))
    elif case == "halves of two shapes":
        t = (t[0], t[1][:, :8])
    elif case == "rank 1":
        t = (t[0][0], t[1][0])
    else:
        t = (t[0].to(torch.int32), t[1].to(torch.int32))
    with pytest.raises((ValueError, TypeError)):
        E.group_prod(t, groups)


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

    seen, prods, calls = {}, {}, []
    route, ext_prod = kf._route, kf.ext_prod

    def spy(tensors, what):
        key = (what,) + tuple((tuple(t.shape), t.stride()) for t in tensors)
        seen.setdefault(key, tuple(tensors))
        return route(tensors, what)

    def prod_spy(t, groups, allbut=False):
        groups = [tuple(g) for g in groups]
        calls.append((tuple(groups), allbut))
        prods.setdefault((tuple(groups), allbut, t[0].stride(),
                          t[1].stride()), (t, groups))
        return ext_prod(t, groups, allbut)

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
    # one grouped product a factor matrix: round 2's two, and in each
    # quotient chunk (one here) the two permutation ones and the lookup's
    perm, lk = (tuple(pk.perm_groups), False), (tuple(pk.lk_groups), True)
    for run in (prove, prove_fused):
        calls.clear()
        run(pk, ext)
        assert calls == [perm, perm, perm, perm, lk]
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
    assert {(g, a) for g, a, _, _ in prods} == {perm, lk}
    modes = set()
    for (groups, _, _, _), (t, _) in prods.items():
        cols = [c for s, e in groups for c in range(s, e)]
        for (vals, mode), h in zip(_group_reads(t, groups), t):
            assert torch.equal(vals, h[:, cols])
            modes.add(mode)
    # the permutation's halves and the lookup's real half are staged
    assert kf.STAGED in modes and kf.BCAST in modes
