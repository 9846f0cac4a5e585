"""Wrappers of the Poseidon2 CUDA kernels in ``csrc/poseidon2.cu``.

Each wrapper takes ``int64`` tensors holding u64 field bits:

- ``leaf_hash``: ``(M, C)`` rows -> ``(M, 4)`` sponge digests;
- ``two_to_one_levels``: child level ``(N, 4)`` -> the ``n`` parent levels
  ``(N / 2, 4)`` .. ``(N / 2^n, 4)``, several levels per launch, a narrow
  level with four threads per permutation (each launch counts under
  ``two_to_one_level``, the name of the Pallas kernel it replaces);
- ``permute``: ``(B, 12)`` states -> ``(B, 12)``;
- ``duplex``: one duplex of the transcript's ``(12,)`` sponge state, the
  buffered 0-d inputs read by address inside the kernel;
- ``grind``: the proof-of-work search from a ``(12,)`` sponge state and its
  buffered inputs, in one launch with no host loop, so that a CUDA graph can
  hold it.

A CPU tensor goes to the plain twin in ``field/poseidon.py``.  A CUDA
tensor goes to the kernel, launched on that tensor's card, or the wrapper
raises: there is no fallback.  ``launches`` counts kernel launches per
wrapper.

The library is built with ``nvcc`` at first use into ``_build/``, keyed by
a hash of the sources, the shared header ``csrc/goldilocks.cuh`` and the
flags (``kernels/nvcc.py``), and loaded with ctypes; ptxas's register and
spill report is kept beside it (``ptxas_report``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..field import poseidon as plain
from ..field.poseidon import (DIAG_M1, DIGEST, INTERNAL_CONSTANTS, RATE,
                              ROUND_CONSTANTS, WIDTH)
from . import nvcc

SOURCES = (nvcc.CSRC / "poseidon2.cu",)
# Merkle levels: a launch hashes up to LEVELS_PER_LAUNCH levels with one
# thread per permutation; from a child level of at most NARROW_CHILDREN
# digests up, it hashes up to NARROW_LEVELS levels with four threads per
# permutation.  Chosen from a measurement at the main path's shapes (PERF.md);
# neither may exceed MAX_LEVELS in csrc/poseidon2.cu.
LEVELS_PER_LAUNCH = 2
NARROW_CHILDREN = 1 << 15
NARROW_LEVELS = 3

launches = {"leaf_hash": 0, "two_to_one_level": 0, "permute": 0,
            "duplex": 0, "grind": 0}

_lib = None
_ready_devices = set()


def reset_launches():
    for k in launches:
        launches[k] = 0


def build() -> Path:
    """Compile the kernels (if not already built) and return the library."""
    return nvcc.build("poseidon2", SOURCES)


def ptxas_report() -> list:
    """ptxas's lines on each kernel's registers, spills and shared memory,
    from the build of the library."""
    return nvcc.ptxas_report(build())


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.p2_set_constants.argtypes = [vp, vp, vp]
    ci = ctypes.c_int
    lib.p2_leaf_hash.argtypes = [vp, i64, ci, vp, vp]
    lib.p2_merkle_levels.argtypes = [vp, i64, ci, ctypes.POINTER(vp), ci, vp]
    lib.p2_permute.argtypes = [vp, i64, vp, vp]
    lib.p2_duplex.argtypes = [vp, ctypes.POINTER(vp), ci, vp, vp]
    lib.p2_grind.argtypes = [vp, ctypes.POINTER(vp), ci, ci, ctypes.c_uint64,
                             vp, vp]
    lib.p2_mul_chain.argtypes = [ctypes.c_uint64, ci, vp, vp]
    for fn in (lib.p2_set_constants, lib.p2_leaf_hash, lib.p2_merkle_levels,
               lib.p2_permute, lib.p2_duplex, lib.p2_grind,
               lib.p2_mul_chain):
        fn.restype = ctypes.c_int
    lib.p2_error_string.argtypes = [ctypes.c_int]
    lib.p2_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.p2_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _lib_for(t: torch.Tensor):
    """The loaded library with the constants on ``t``'s device."""
    lib = _load()
    dev = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    if dev not in _ready_devices:
        consts = [np.ascontiguousarray(a, dtype=np.uint64)
                  for a in (ROUND_CONSTANTS, INTERNAL_CONSTANTS, DIAG_M1)]
        with torch.cuda.device(dev):
            _check(lib, lib.p2_set_constants(
                *(c.ctypes.data for c in consts)), "p2_set_constants")
        _ready_devices.add(dev)
    return lib


def _route(t: torch.Tensor, shape_ok: bool, what: str) -> bool:
    """True for the kernel, False for the plain twin; raises otherwise."""
    if t.dtype != torch.int64:
        raise TypeError(f"{what}: expected int64, got {t.dtype}")
    if not shape_ok:
        raise ValueError(f"{what}: bad shape {tuple(t.shape)}")
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    return True


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(lib, t: torch.Tensor, what: str, fn, *args):
    """Launch ``fn`` with ``t``'s device current, on that device's current
    stream: the kernel runs on the tensor's card, whichever card is
    current."""
    with torch.cuda.device(t.device):
        _check(lib, fn(*args, _stream(t)), what)
    launches[what] += 1


def _check_inputs(state: torch.Tensor, inputs, most: int, what: str):
    """Sponge inputs: at most ``most`` 0-d int64 tensors on the state's
    device."""
    if len(inputs) > most:
        raise ValueError(f"{what}: {len(inputs)} inputs, at most {most}")
    for x in inputs:
        if x.dtype != torch.int64:
            raise TypeError(f"{what}: expected int64 inputs, got {x.dtype}")
        if x.dim() != 0:
            raise ValueError(f"{what}: inputs must be 0-d, got "
                             f"{tuple(x.shape)}")
        if x.device != state.device:
            raise ValueError(f"{what}: input on {x.device}, state on "
                             f"{state.device}")


def _addresses(inputs):
    """The inputs' device addresses as the kernels' array of RATE."""
    return (ctypes.c_void_p * RATE)(*(x.data_ptr() for x in inputs))


def leaf_hash(matrix: torch.Tensor) -> torch.Tensor:
    """(M, C) rows -> (M, 4) digests."""
    ok = matrix.dim() == 2 and matrix.shape[1] >= 1
    if not _route(matrix, ok, "leaf_hash"):
        return plain.hash_no_pad(matrix)
    lib = _lib_for(matrix)
    m, c = matrix.shape
    out = torch.empty((m, DIGEST), dtype=torch.int64, device=matrix.device)
    _launch(lib, matrix, "leaf_hash", lib.p2_leaf_hash, matrix.data_ptr(), m,
            c, out.data_ptr())
    return out


def two_to_one_levels(child: torch.Tensor, n_levels: int):
    """(N, 4) child digests -> the ``n_levels`` levels above them, a list of
    (N / 2^l, 4) tensors for l = 1..n_levels; parent i of a level compresses
    children 2i and 2i+1."""
    ok = child.dim() == 2 and child.shape[1] == DIGEST and n_levels >= 1 \
        and child.shape[0] % (1 << n_levels) == 0
    if not _route(child, ok, "two_to_one_levels"):
        return plain.two_to_one_levels(child, n_levels)
    lib = _lib_for(child)
    if child.data_ptr() % 16:
        raise ValueError("two_to_one_levels: child must be 16-byte aligned")
    levels = []
    cur = child
    while len(levels) < n_levels:
        narrow = cur.shape[0] <= NARROW_CHILDREN
        k = min(NARROW_LEVELS if narrow else LEVELS_PER_LAUNCH,
                n_levels - len(levels))
        outs = [torch.empty((cur.shape[0] >> l, DIGEST), dtype=torch.int64,
                            device=child.device) for l in range(1, k + 1)]
        ptrs = (ctypes.c_void_p * k)(*(o.data_ptr() for o in outs))
        _launch(lib, child, "two_to_one_level", lib.p2_merkle_levels,
                cur.data_ptr(), cur.shape[0], k, ptrs, int(narrow))
        levels += outs
        cur = outs[-1]
    return levels


def permute(states: torch.Tensor) -> torch.Tensor:
    """(B, 12) states -> (B, 12) permuted states."""
    ok = states.dim() == 2 and states.shape[1] == WIDTH
    if not _route(states, ok, "permute"):
        return plain.permute(states)
    lib = _lib_for(states)
    b = states.shape[0]
    out = torch.empty_like(states)
    _launch(lib, states, "permute", lib.p2_permute, states.data_ptr(), b,
            out.data_ptr())
    return out


def duplex(state: torch.Tensor, inputs) -> torch.Tensor:
    """One duplex of the ``(12,)`` sponge state: lanes 0..k-1 overwritten by
    the k <= 8 buffered inputs (0-d tensors on the state's device, read by
    address), then permuted; returns a new canonical ``(12,)`` state."""
    _check_inputs(state, inputs, RATE, "duplex")
    if not _route(state, state.shape == (WIDTH,), "duplex"):
        return plain.duplex(state, inputs)
    lib = _lib_for(state)
    out = torch.empty_like(state)
    _launch(lib, state, "duplex", lib.p2_duplex, state.data_ptr(),
            _addresses(inputs), len(inputs), out.data_ptr())
    return out


def grind(state: torch.Tensor, lane: int, pow_bits: int,
          inputs=()) -> torch.Tensor:
    """The smallest nonce n < 2^32 for which lane RATE - 1 of the permuted
    ``(12,)`` state, with the buffered inputs over lanes 0..k-1 (k <=
    ``lane``) and lane ``lane`` set to n, is below 2^(64 - pow_bits), as a
    0-d tensor on the state's device (2^32 if none)."""
    ok = state.shape == (WIDTH,) and len(inputs) <= lane < RATE and \
        1 <= pow_bits <= 32
    _check_inputs(state, inputs, RATE - 1, "grind")
    if not _route(state, ok, "grind"):
        return plain.grind(state, lane, pow_bits, inputs)
    lib = _lib_for(state)
    best = torch.full((1,), 1 << 32, dtype=torch.int64, device=state.device)
    _launch(lib, state, "grind", lib.p2_grind, state.data_ptr(),
            _addresses(inputs), len(inputs), lane, 1 << (64 - pow_bits),
            best.data_ptr())
    return best.reshape(())
