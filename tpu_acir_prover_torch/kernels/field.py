"""Wrappers of the field kernels in ``csrc/field.cu``: the port's Goldilocks
and GF(p^2) ops on the card.

Each elementwise wrapper takes ``int64`` tensors holding u64 field bits,
broadcast against each other as torch broadcasts them, and returns
contiguous tensors of the broadcast shape:

- ``add``, ``sub``, ``mul``: one ``gl_binary_kernel`` launch each
  (``field/gl.py``'s ``add``, ``sub``, ``mul``, so ``sqr`` and
  ``mul_const``);
- ``pow_const``: ``a^e`` for a host exponent 0 <= e < 2^64, one
  ``gl_pow_kernel`` launch (``field/gl.py``'s ``pow_const`` and ``inv``);
- ``ext_mul``, ``ext_inv``: the GF(p^2) product and inverse of ``(re, im)``
  pairs, one ``ext_mul_kernel`` / ``ext_inv_kernel`` launch writing both
  halves (``field/ext.py``'s ``mul`` and ``inv``).

``ext_prod`` multiplies listed columns of an ext pair of ``(rows, k)``
matrices into ``(rows,)`` ext values in one ``ext_prod_kernel`` launch
(``field/ext.py``'s ``prod``).

Operands are passed by address with the sizes and strides of their
broadcast views (``layout``), so broadcast rows and columns, 0-d constants
and strided views are read in place.  ``plan`` chooses, from that layout on
the host, the path a binary or ``ext_mul`` launch takes in the kernel
(flat, rows, tiled or general; ``csrc/field.cu`` says what each does) and
its grid.

A CPU tensor goes to the plain twin in ``field/gl_plain.py`` or
``field/ext_plain.py``.  A CUDA tensor goes to the kernel, launched on that
tensor's card and its current stream (so a CUDA graph captures it), or the
wrapper raises: there is no fallback.  ``launches`` counts kernel launches
per kernel; an empty output launches nothing.

The library is built with ``nvcc`` at first use into ``_build/``
(``kernels/nvcc.py``) and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple

import torch

from ..field import ext_plain, gl_plain
from . import nvcc

SOURCES = (nvcc.CSRC / "field.cu",)
# as in csrc/field.cu
MAX_RANK = 6
MAX_ELEMENTS = 1 << 31            # outputs index in 32 bits there
THREADS = 256                     # threads a block but in ext_prod
VEC = 4                           # elements a thread but in general
TILE, MAX_TILE_ROWS = 1024, 32    # tiled: elements of a tile, its rows
MAX_GRID_YZ = 65535
PROD_ROWS = 128                   # ext_prod: rows a block
PROD_MAX_COLS = 8
FLAT, ROWS, TILED, GENERAL = range(4)
PATHS = ("flat", "rows", "tiled", "general")
ROWS_TX = 64                      # rows: most threads along the run
_U64 = 1 << 64
_OPS = {"add": 0, "sub": 1, "mul": 2}
_TWINS = {"add": gl_plain.add, "sub": gl_plain.sub, "mul": gl_plain.mul}

launches = {"gl_binary": 0, "gl_pow": 0, "ext_mul": 0, "ext_inv": 0,
            "ext_prod": 0}

_lib = None
_arrays = {}


class Launch(NamedTuple):
    """A launch's layout and plan: ``sizes`` and per-operand ``strides``
    (``layout``'s; for ext_prod the (rows, k) and the strides of each
    half), its ``path`` (one of ``PATHS``, or "prod"), ``desc``, the int64
    array the library reads them from, and ext_prod's ``cols``."""
    sizes: tuple
    strides: tuple
    path: str
    desc: object
    cols: tuple = ()


def reset_launches():
    for k in launches:
        launches[k] = 0


def build() -> Path:
    """Compile the kernels (if not already built) and return the library."""
    return nvcc.build("field", SOURCES)


def ptxas_report() -> list:
    """ptxas's lines on each kernel's registers, spills and shared memory,
    from the build of the library."""
    return nvcc.ptxas_report(build())


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fd_gl_binary.argtypes = [ci, vp, vp, vp, vp, vp]
    lib.fd_gl_pow.argtypes = [vp, ctypes.c_uint64, vp, vp, vp]
    lib.fd_ext_mul.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp]
    lib.fd_ext_inv.argtypes = [vp, vp, vp, vp, vp, vp]
    lib.fd_ext_prod.argtypes = [vp, vp, vp, vp, vp, vp]
    for fn in (lib.fd_gl_binary, lib.fd_gl_pow, lib.fd_ext_mul,
               lib.fd_ext_inv, lib.fd_ext_prod):
        fn.restype = ci
    lib.fd_error_string.argtypes = [ci]
    lib.fd_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _int64s(values):
    """A ctypes int64 array of ``values``; its type is made once a
    length."""
    kind = _arrays.get(len(values))
    if kind is None:
        kind = _arrays[len(values)] = ctypes.c_int64 * len(values)
    return kind(*values)


def _broadcast(shapes) -> torch.Size:
    """torch.broadcast_shapes of ``shapes``; torch's goes through
    ``torch._refs`` in Python, and with it the wrappers measured slower a
    call (PERF.md)."""
    rank = max(len(s) for s in shapes)
    out = [1] * rank
    for s in shapes:
        for d, x in enumerate(s, rank - len(s)):
            if x != 1:
                if out[d] == 1:
                    out[d] = x
                elif out[d] != x:
                    raise ValueError(f"shapes {[tuple(s) for s in shapes]} "
                                     f"do not broadcast")
    return torch.Size(out)


def layout(*tensors):
    """(shape, sizes, strides) of the operands broadcast together: the
    broadcast shape, and the sizes and each operand's element strides (0
    where it is broadcast) over that shape's dimensions with the size-1
    ones dropped and neighbours merged where every operand is contiguous
    across them; at least one dimension.  Operand k's element at output
    index i (row-major over ``sizes``) lies at its ``data_ptr()`` plus
    sum_d i_d * strides[k][d] elements."""
    shapes = [t.shape for t in tensors]
    steps = [t.stride() for t in tensors]
    shape = _broadcast(shapes)
    rank = len(shape)
    sizes, strides = [], [[] for _ in tensors]
    for d, size in enumerate(shape):
        if size == 1:
            continue
        st = []
        for sh, step in zip(shapes, steps):
            j = d - rank + len(sh)
            st.append(step[j] if j >= 0 and sh[j] != 1 else 0)
        if sizes and all(s[-1] == x * size for s, x in zip(strides, st)):
            sizes[-1] *= size
            for s, x in zip(strides, st):
                s[-1] = x
        else:
            sizes.append(size)
            for s, x in zip(strides, st):
                s.append(x)
    if not sizes:
        sizes, strides = [1], [[0] for _ in tensors]
    return shape, sizes, strides


def plan(sizes, strides, tiled=True):
    """(path, grid (x, y, z), block (x, y)) of a launch on ``layout``'s
    sizes and strides: flat at rank 1 where every stride is 0 or 1; at rank
    2 or 3 tiled where an operand is contiguous along the second-innermost
    dimension and strided along the innermost (only if ``tiled``: ext_mul
    has no tiled path), else rows; general for a strided rank-1 operand (a
    column of a matrix: one thread an element, measured faster there than
    flat's four, PERF.md) and above rank 3.  Flat's, rows' and tiled's
    grids cover the innermost run once, VEC elements a thread."""
    rank = len(sizes)
    if rank == 1 and all(st[0] in (0, 1) for st in strides):
        return FLAT, (-(-sizes[0] // (VEC * THREADS)), 1, 1), (THREADS, 1)
    if rank == 1 or rank > 3:
        return GENERAL, (-(-math.prod(sizes) // THREADS), 1, 1), (THREADS, 1)
    inner, rows = sizes[-1], sizes[-2]
    z = min(sizes[0] if rank == 3 else 1, MAX_GRID_YZ)
    if tiled and any(st[-2] == 1 and st[-1] not in (0, 1) for st in strides):
        tr = tile_rows(rows)
        return TILED, (-(-inner // (TILE // tr)),
                       min(-(-rows // tr), MAX_GRID_YZ), z), (THREADS, 1)
    tx = min(ROWS_TX, -(-inner // VEC))    # threads a row
    ty = THREADS // tx
    return ROWS, (-(-inner // (VEC * tx)), min(-(-rows // ty), MAX_GRID_YZ),
                  z), (tx, ty)


def tile_rows(rows: int) -> int:
    """The rows of a tiled launch's tile: ``rows`` rounded up to a power of
    two, at most MAX_TILE_ROWS; its cols are TILE over that."""
    return min(MAX_TILE_ROWS, 1 << (rows - 1).bit_length())


def _route(tensors, what: str) -> bool:
    """True for the kernel, False for the plain twin; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int64:
            raise TypeError(f"{what}: expected int64 tensors, got "
                            f"{getattr(t, 'dtype', type(t))}")
        if t.device != dev:
            raise ValueError(f"{what}: operands on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    return True


def _outputs(tensors, count: int, pathed: bool, tiled: bool = True):
    """The launch (layout, path and its description) and ``count``
    contiguous outputs of the broadcast shape; ``pathed``: the kernel takes
    ``plan``'s paths, else the general one."""
    shape, sizes, strides = layout(*tensors)
    n = shape.numel()
    if n >= MAX_ELEMENTS:
        raise ValueError(f"an output of shape {tuple(shape)}: at most "
                         f"2^31 - 1 elements")
    if len(sizes) > MAX_RANK:
        raise ValueError(f"operands of shapes "
                         f"{[tuple(t.shape) for t in tensors]} need "
                         f"{len(sizes)} dimensions, at most {MAX_RANK}")
    dev = tensors[0].device
    outs = [torch.empty(shape, dtype=torch.int64, device=dev)
            for _ in range(count)]
    if not n:
        return None, outs
    if pathed:
        path, grid, block = plan(sizes, strides, tiled)
    else:
        path, grid, block = GENERAL, (-(-n // THREADS), 1, 1), (THREADS, 1)
    desc = _int64s([n, len(sizes), path, *grid, *block, *sizes,
                    *(x for s in strides for x in s)])
    return Launch(tuple(sizes), tuple(map(tuple, strides)), PATHS[path],
                  desc), outs


def _launch(what: str, fn, dev, launch: Launch, *args):
    """``fn(*args, launch.desc, stream)`` with ``dev`` current, on its
    current stream; counts the launch."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args, launch.desc, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, launch.desc,
                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = _lib.fd_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
    launches[what] += 1


def _binary(op: str, a, b):
    if not _route((a, b), op):
        return _TWINS[op](a, b)
    launch, (out,) = _outputs((a, b), 1, pathed=True)
    if launch:
        _launch("gl_binary", _load().fd_gl_binary, a.device, launch,
                _OPS[op], a.data_ptr(), b.data_ptr(), out.data_ptr())
    return out


def add(a, b):
    return _binary("add", a, b)


def sub(a, b):
    return _binary("sub", a, b)


def mul(a, b):
    return _binary("mul", a, b)


def pow_const(a, e: int):
    """a ** e for a python-int exponent 0 <= e < 2^64."""
    e = int(e)
    if not 0 <= e < _U64:
        raise ValueError(f"pow_const: exponent {e} outside [0, 2^64)")
    if not _route((a,), "pow_const"):
        return gl_plain.pow_const(a, e)
    launch, (out,) = _outputs((a,), 1, pathed=False)
    if launch:
        _launch("gl_pow", _load().fd_gl_pow, a.device, launch, a.data_ptr(),
                e, out.data_ptr())
    return out


def ext_mul(x, y):
    """(x0 + x1 u)(y0 + y1 u) for ext pairs of tensors."""
    ops = (x[0], x[1], y[0], y[1])
    if not _route(ops, "ext_mul"):
        return ext_plain.mul(x, y)
    launch, (c0, c1) = _outputs(ops, 2, pathed=True, tiled=False)
    if launch:
        _launch("ext_mul", _load().fd_ext_mul, x[0].device, launch,
                *(t.data_ptr() for t in ops), c0.data_ptr(), c1.data_ptr())
    return (c0, c1)


def ext_inv(x):
    """1 / (x0 + x1 u) for an ext pair of tensors; the inverse of 0 is 0."""
    if not _route(x, "ext_inv"):
        return ext_plain.inv(x)
    launch, (c0, c1) = _outputs(x, 2, pathed=False)
    if launch:
        _launch("ext_inv", _load().fd_ext_inv, x[0].device, launch,
                x[0].data_ptr(), x[1].data_ptr(), c0.data_ptr(),
                c1.data_ptr())
    return (c0, c1)


def ext_prod(t, cols):
    """prod over ``cols`` (1 to PROD_MAX_COLS column indices) of column j
    of the ext pair ``t`` of (rows, k) tensors: a (rows,) ext value.  One
    ``ext_prod_kernel`` launch; one column is returned as its views, as the
    twin does."""
    re, im = t
    cols = [int(c) for c in cols]
    if not 1 <= len(cols) <= PROD_MAX_COLS:
        raise ValueError(f"ext_prod: {len(cols)} columns, 1 to "
                         f"{PROD_MAX_COLS}")
    if re.dim() != 2 or re.shape != im.shape:
        raise ValueError(f"ext_prod: halves of shapes {tuple(re.shape)} "
                         f"and {tuple(im.shape)}, not one (rows, k)")
    rows, k = re.shape
    if not all(0 <= c < k for c in cols):
        raise ValueError(f"ext_prod: columns {cols} of {k}")
    if not _route(t, "ext_prod"):
        return ext_plain.prod(t, cols)
    if len(cols) == 1:
        return (re[:, cols[0]], im[:, cols[0]])
    if rows >= MAX_ELEMENTS:
        raise ValueError(f"ext_prod: {rows} rows, at most 2^31 - 1")
    c0 = torch.empty(rows, dtype=torch.int64, device=re.device)
    c1 = torch.empty_like(c0)
    if rows:
        strides = (re.stride(), im.stride())
        desc = _int64s([rows, len(cols), *strides[0], *strides[1], *cols])
        _launch("ext_prod", _load().fd_ext_prod, re.device,
                Launch((rows, k), strides, "prod", desc, tuple(cols)),
                re.data_ptr(), im.data_ptr(), c0.data_ptr(), c1.data_ptr())
    return (c0, c1)
