"""Wrappers of the field kernels in ``csrc/field.cu``: the port's Goldilocks
and GF(p^2) ops on the card.

Each wrapper takes ``int64`` tensors holding u64 field bits, broadcast
against each other as torch broadcasts them, and returns contiguous
tensors of the broadcast shape:

- ``add``, ``sub``, ``mul``: one ``gl_binary_kernel`` launch each
  (``field/gl.py``'s ``add``, ``sub``, ``mul``, so ``sqr`` and
  ``mul_const``);
- ``pow_const``: ``a^e`` for a host exponent 0 <= e < 2^64, one
  ``gl_pow_kernel`` launch (``field/gl.py``'s ``pow_const`` and ``inv``);
- ``ext_mul``, ``ext_inv``: the GF(p^2) product and inverse of ``(re, im)``
  pairs, one ``ext_mul_kernel`` / ``ext_inv_kernel`` launch writing both
  halves (``field/ext.py``'s ``mul`` and ``inv``).

Operands are passed by address with the sizes and strides of their
broadcast views (``layout``), so broadcast rows and columns, 0-d constants
and strided views are read in place.

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

import torch

from ..field import ext_plain, gl_plain
from . import nvcc

SOURCES = (nvcc.CSRC / "field.cu",)
MAX_RANK = 6                      # as in csrc/field.cu
MAX_ELEMENTS = 1 << 31            # outputs index in 32 bits there
_U64 = 1 << 64
_OPS = {"add": 0, "sub": 1, "mul": 2}
_TWINS = {"add": gl_plain.add, "sub": gl_plain.sub, "mul": gl_plain.mul}

launches = {"gl_binary": 0, "gl_pow": 0, "ext_mul": 0, "ext_inv": 0}

_lib = None


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
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    shape = [i64, ci, vp, vp, vp]     # n, rank, sizes, strides, stream
    lib.fd_gl_binary.argtypes = [ci, vp, vp, vp, *shape]
    lib.fd_gl_pow.argtypes = [vp, ctypes.c_uint64, vp, *shape]
    lib.fd_ext_mul.argtypes = [vp, vp, vp, vp, vp, vp, *shape]
    lib.fd_ext_inv.argtypes = [vp, vp, vp, vp, *shape]
    for fn in (lib.fd_gl_binary, lib.fd_gl_pow, lib.fd_ext_mul,
               lib.fd_ext_inv):
        fn.restype = ci
    lib.fd_error_string.argtypes = [ci]
    lib.fd_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def layout(*tensors):
    """(shape, sizes, strides) of the operands broadcast together: the
    broadcast shape, and the sizes and each operand's element strides (0
    where it is broadcast) over that shape's dimensions with the size-1
    ones dropped and neighbours merged where every operand is contiguous
    across them; at least one dimension.  Operand k's element at output
    index i (row-major over ``sizes``) lies at its ``data_ptr()`` plus
    sum_d i_d * strides[k][d] elements."""
    shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    rank = len(shape)
    sizes, strides = [], [[] for _ in tensors]
    for d, size in enumerate(shape):
        if size == 1:
            continue
        st = []
        for t in tensors:
            j = d - rank + t.dim()
            st.append(t.stride(j) if j >= 0 and t.shape[j] != 1 else 0)
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


def _outputs(tensors, count: int):
    """The broadcast layout's arguments (n, rank, sizes, strides) and
    ``count`` contiguous outputs of the broadcast shape."""
    shape, sizes, strides = layout(*tensors)
    n = math.prod(shape)
    if n >= MAX_ELEMENTS:
        raise ValueError(f"an output of shape {tuple(shape)}: at most "
                         f"2^31 - 1 elements")
    if len(sizes) > MAX_RANK:
        raise ValueError(f"operands of shapes "
                         f"{[tuple(t.shape) for t in tensors]} need "
                         f"{len(sizes)} dimensions, at most {MAX_RANK}")
    outs = [torch.empty(shape, dtype=torch.int64, device=tensors[0].device)
            for _ in range(count)]
    rank = len(sizes)
    flat = [x for s in strides for x in s]
    args = (n, rank, (ctypes.c_int64 * rank)(*sizes),
            (ctypes.c_int64 * len(flat))(*flat))
    return args, outs


def _launch(what: str, fn, dev, *args):
    """Launch ``fn`` with ``dev`` current, on its current stream."""
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = _lib.fd_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
    launches[what] += 1


def _binary(op: str, a, b):
    if not _route((a, b), op):
        return _TWINS[op](a, b)
    shape_args, (out,) = _outputs((a, b), 1)
    if out.numel():
        lib = _load()
        _launch("gl_binary", lib.fd_gl_binary, a.device, _OPS[op],
                a.data_ptr(), b.data_ptr(), out.data_ptr(), *shape_args)
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
    shape_args, (out,) = _outputs((a,), 1)
    if out.numel():
        lib = _load()
        _launch("gl_pow", lib.fd_gl_pow, a.device, a.data_ptr(), e,
                out.data_ptr(), *shape_args)
    return out


def ext_mul(x, y):
    """(x0 + x1 u)(y0 + y1 u) for ext pairs of tensors."""
    ops = (x[0], x[1], y[0], y[1])
    if not _route(ops, "ext_mul"):
        return ext_plain.mul(x, y)
    shape_args, (c0, c1) = _outputs(ops, 2)
    if c0.numel():
        lib = _load()
        _launch("ext_mul", lib.fd_ext_mul, x[0].device,
                *(t.data_ptr() for t in ops), c0.data_ptr(), c1.data_ptr(),
                *shape_args)
    return (c0, c1)


def ext_inv(x):
    """1 / (x0 + x1 u) for an ext pair of tensors; the inverse of 0 is 0."""
    if not _route(x, "ext_inv"):
        return ext_plain.inv(x)
    shape_args, (c0, c1) = _outputs(x, 2)
    if c0.numel():
        lib = _load()
        _launch("ext_inv", lib.fd_ext_inv, x[0].device, x[0].data_ptr(),
                x[1].data_ptr(), c0.data_ptr(), c1.data_ptr(), *shape_args)
    return (c0, c1)
