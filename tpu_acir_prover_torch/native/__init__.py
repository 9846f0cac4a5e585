"""ctypes loader/builder for the native witness core (witnesscore.c).

A copy of ``tpu_acir_prover/native``.  The shared library is compiled on
first use with the system C compiler into the package's ``_build/``
directory (the library is Python.h-free and loaded via ctypes).  Every
entry point has a pure-Python fallback in circuit/compile.py, so a box
with no C compiler only loses speed; a compiler that fails raises with its
stderr.

Each process compiles to a temporary name of its own and renames it into
place, so processes that build at once (test workers) all end up loading a
whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "witnesscore.c")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def build_lib(build_dir=BUILD_DIR) -> str:
    """Compile witnesscore.c into a cached .so in ``build_dir``; returns its
    path.  Raises FileNotFoundError when there is no C compiler and
    RuntimeError with the compiler's stderr when it fails."""
    os.makedirs(build_dir, exist_ok=True)
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so_path = os.path.join(build_dir, f"witnesscore_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    cc = os.environ.get("CC", "cc")
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [cc, "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cc} failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so_path)
    return so_path


def get_lib():
    """The loaded library, or None if the native core is unavailable (no C
    compiler, or TPU_ACIR_NO_NATIVE=1)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    if os.environ.get("TPU_ACIR_NO_NATIVE") == "1":
        _TRIED = True
        return None
    try:
        path = build_lib()
    except FileNotFoundError as e:  # no C compiler on this box
        _TRIED = True
        print(f"tpu_acir_prover_torch: native witness core unavailable ({e}); "
              "using the Python fallback", file=sys.stderr)
        return None
    lib = ctypes.CDLL(path)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.gl_schedule.restype = ctypes.c_long
    lib.gl_schedule.argtypes = [ctypes.c_long, i32p, i64p, i64p, i64p,
                                i64p, i64p, ctypes.c_int64, i64p]
    lib.gl_run_ops.restype = ctypes.c_long
    lib.gl_run_ops.argtypes = [ctypes.c_long, ctypes.c_long, i64p, i32p,
                               i64p, i64p, i64p, u64p, u64p]
    lib.gl_check_rows.restype = ctypes.c_long
    lib.gl_check_rows.argtypes = [ctypes.c_int64, ctypes.c_int64, u64p,
                                  u64p, u64p, ctypes.c_int64]
    _LIB = lib
    _TRIED = True
    return _LIB


def as_ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def schedule_levels(op, out, a, b, hint_in_off, hint_in, n_vars):
    """Native topological level assignment; returns level array or None."""
    lib = get_lib()
    if lib is None:
        return None
    level = np.zeros(n_vars, dtype=np.int64)
    rc = lib.gl_schedule(
        len(op), as_ptr(op, ctypes.c_int32), as_ptr(out, ctypes.c_int64),
        as_ptr(a, ctypes.c_int64), as_ptr(b, ctypes.c_int64),
        as_ptr(hint_in_off, ctypes.c_int64), as_ptr(hint_in, ctypes.c_int64),
        n_vars, as_ptr(level, ctypes.c_int64))
    if rc < 0:
        raise AssertionError(f"native scheduler failed (rc={rc})")
    return level


def run_ops(start, end, order, op, out, a, b, cst, vals):
    lib = get_lib()
    rc = lib.gl_run_ops(
        start, end, as_ptr(order, ctypes.c_int64), as_ptr(op, ctypes.c_int32),
        as_ptr(out, ctypes.c_int64), as_ptr(a, ctypes.c_int64),
        as_ptr(b, ctypes.c_int64), as_ptr(cst, ctypes.c_uint64),
        as_ptr(vals, ctypes.c_uint64))
    if rc != 0:
        raise AssertionError(f"native generator execution failed (rc={rc})")


def check_rows(selectors, wires, pi, npair):
    lib = get_lib()
    if lib is None:
        return None
    n = selectors.shape[1]
    W = wires.shape[0]
    sel = np.ascontiguousarray(selectors, dtype=np.uint64)
    wv = np.ascontiguousarray(wires, dtype=np.uint64)
    piv = np.ascontiguousarray(pi, dtype=np.uint64)
    return int(lib.gl_check_rows(n, W, as_ptr(sel, ctypes.c_uint64),
                                 as_ptr(wv, ctypes.c_uint64),
                                 as_ptr(piv, ctypes.c_uint64), npair))
