"""Poseidon2 width 12 over Goldilocks as plain torch ops.

Counterpart of ``make_poseidon`` in ``tpu_acir_prover/field/poseidon.py``.
The constant derivation (SHA-256 in counter mode, the invertible internal
diagonal) and the python-int permutation used by the host challenger and
verifier are copies of that module's.  The torch functions are the plain
twins of the CUDA kernels in ``kernels/poseidon.py``: the kernel wrappers
call them for CPU tensors, and the tests and ``chip_smoke.py`` hold the
kernels to them.  Their field arithmetic is ``field/gl_plain.py``'s, so
they are plain torch ops on the card too.

States are ``(..., 12)`` int64 tensors and digests ``(..., 4)``: the lane
axis is last, the row-major layout of the LDE matrices.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from . import gl
from .gl_plain import add, mul

WIDTH = 12
RATE = 8
CAP = 4
DIGEST = 4
EXTERNAL_ROUNDS = 8  # 4 at the beginning + 4 at the end
INTERNAL_ROUNDS = 22
ALPHA = 7


def _h64(tag: str) -> int:
    h = hashlib.sha256(tag.encode()).digest()
    return int.from_bytes(h[:8], "little") % gl.P


def _derive_round_constants():
    """External rounds use full-width constants; internal rounds add a
    constant to lane 0 only (stored in column 0)."""
    ext = np.zeros((EXTERNAL_ROUNDS, WIDTH), dtype=np.uint64)
    for r in range(EXTERNAL_ROUNDS):
        for i in range(WIDTH):
            ext[r, i] = _h64(f"tpu-acir-prover.poseidon2.ext.{r}.{i}")
    internal = np.zeros(INTERNAL_ROUNDS, dtype=np.uint64)
    for r in range(INTERNAL_ROUNDS):
        internal[r] = _h64(f"tpu-acir-prover.poseidon2.int.{r}")
    return ext, internal


def _derive_diag():
    """Internal-matrix diagonal mu: M_I = J + diag(mu - 1) (J = all-ones),
    i.e. M_I[i][j] = 1 for i != j and mu_i on the diagonal.  Re-derive
    until det(M_I) != 0 mod p (a random matrix is invertible w.h.p.)."""
    ctr = 0
    while True:
        mu = [_h64(f"tpu-acir-prover.poseidon2.diag.{ctr}.{i}")
              for i in range(WIDTH)]
        # det via Gaussian elimination mod p
        m = [[1] * WIDTH for _ in range(WIDTH)]
        for i in range(WIDTH):
            m[i][i] = mu[i]
        det = 1
        singular = False
        for c in range(WIDTH):
            piv = next((r for r in range(c, WIDTH) if m[r][c]), None)
            if piv is None:
                singular = True
                break
            if piv != c:
                m[c], m[piv] = m[piv], m[c]
                det = gl.P - det
            det = det * m[c][c] % gl.P
            inv = pow(m[c][c], gl.P - 2, gl.P)
            for r in range(c + 1, WIDTH):
                f = m[r][c] * inv % gl.P
                if f:
                    for k in range(c, WIDTH):
                        m[r][k] = (m[r][k] - f * m[c][k]) % gl.P
        if not singular and det:
            return np.array(mu, dtype=np.uint64)
        ctr += 1


# the Poseidon2 paper's M4; M_E = circ(2*M4, M4, M4) expanded to 12x12
_M4 = [[5, 7, 1, 3], [4, 6, 1, 1], [1, 3, 5, 7], [1, 1, 4, 6]]
_ME_INT = [[(2 if a == b else 1) * _M4[i][j]
            for b in range(WIDTH // 4) for j in range(4)]
           for a in range(WIDTH // 4) for i in range(4)]

_EXT_RC, _INT_RC = _derive_round_constants()
ROUND_CONSTANTS = _EXT_RC  # (8, 12) uint64 — external-round constants
INTERNAL_CONSTANTS = _INT_RC  # (22,) uint64
DIAG = _derive_diag()  # (12,) uint64: internal-matrix diagonal mu
# precomputed mu - 1 for the out_i = sum + (mu_i - 1) x_i form
DIAG_M1 = ((DIAG.astype(object) - 1) % gl.P).astype(np.uint64)


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    def dev(a):
        return gl.from_u64(np.asarray(a, dtype=np.uint64), device)

    return dev(ROUND_CONSTANTS), dev(INTERNAL_CONSTANTS), dev(DIAG_M1)


def _sbox(x):
    x2 = mul(x, x)
    x3 = mul(x2, x)
    x6 = mul(x3, x3)
    return mul(x6, x)


def _m4(x):
    """M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] on the last axis by
    the Poseidon2 paper's add chain."""
    x0, x1, x2, x3 = x.unbind(-1)
    t0 = add(x0, x1)
    t1 = add(x2, x3)
    t2 = add(add(x1, x1), t1)
    t3 = add(add(x3, x3), t0)
    d1 = add(t1, t1)
    t4 = add(add(d1, d1), t3)
    d0 = add(t0, t0)
    t5 = add(add(d0, d0), t2)
    t6 = add(t3, t5)
    t7 = add(t2, t4)
    return torch.stack([t6, t5, t7, t4], dim=-1)


def _external_matrix(s):
    """M_E = circ(2*M4, M4, M4)."""
    v = _m4(s.reshape(s.shape[:-1] + (3, 4)))
    tot = add(add(v[..., 0, :], v[..., 1, :]), v[..., 2, :])
    return add(v, tot.unsqueeze(-2)).reshape(s.shape)


def _internal_matrix(s, dm1):
    """out_i = sum_j x_j + (mu_i - 1) * x_i."""
    tot = s[..., 0]
    for j in range(1, WIDTH):
        tot = add(tot, s[..., j])
    return add(mul(s, dm1), tot.unsqueeze(-1))


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of ``(..., 12)`` states."""
    ext_rc, int_rc, dm1 = _constants(state.device)
    half = EXTERNAL_ROUNDS // 2
    s = _external_matrix(state)
    for r in range(half):
        s = _external_matrix(_sbox(add(s, ext_rc[r])))
    for r in range(INTERNAL_ROUNDS):
        l0 = _sbox(add(s[..., :1], int_rc[r]))
        s = _internal_matrix(torch.cat([l0, s[..., 1:]], dim=-1), dm1)
    for r in range(half, EXTERNAL_ROUNDS):
        s = _external_matrix(_sbox(add(s, ext_rc[r])))
    return s


def hash_no_pad(inputs: torch.Tensor) -> torch.Tensor:
    """Sponge hash of ``(..., C)`` rows -> ``(..., 4)`` digests: overwrite
    absorb in chunks of RATE, no padding."""
    c = inputs.shape[-1]
    state = torch.zeros(inputs.shape[:-1] + (WIDTH,), dtype=torch.int64,
                        device=inputs.device)
    for off in range(0, c, RATE):
        k = min(RATE, c - off)
        state = permute(torch.cat([inputs[..., off:off + k],
                                   state[..., k:]], dim=-1))
    return state[..., :DIGEST]


def two_to_one(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Compress ``(..., 4)`` digest pairs into one digest each."""
    z = torch.zeros(left.shape[:-1] + (WIDTH - RATE,), dtype=torch.int64,
                    device=left.device)
    return permute(torch.cat([left, right, z], dim=-1))[..., :DIGEST]


def two_to_one_levels(child: torch.Tensor, n_levels: int) -> list:
    """The ``n_levels`` Merkle levels above ``(N, 4)`` child digests, level
    by level: parent i compresses children 2i and 2i+1."""
    levels = [child]
    for _ in range(n_levels):
        levels.append(two_to_one(levels[-1][0::2], levels[-1][1::2]))
    return levels[1:]


def absorb(state: torch.Tensor, inputs) -> torch.Tensor:
    """The (12,) sponge state with the k buffered 0-d inputs written over
    lanes 0..k-1."""
    if not inputs:
        return state
    return torch.cat([torch.stack(list(inputs)), state[len(inputs):]])


def duplex(state: torch.Tensor, inputs) -> torch.Tensor:
    """One duplex of the (12,) sponge state: absorb the inputs, permute."""
    return permute(absorb(state, inputs))


# most nonces one step of the plain grind tries
GRIND_BATCH = 1 << 17


def grind(state: torch.Tensor, lane: int, pow_bits: int,
          inputs=()) -> torch.Tensor:
    """Proof-of-work search: the smallest nonce n < 2^32 for which lane
    RATE - 1 of ``permute(state)``, with the buffered inputs absorbed into
    the (12,) state and lane ``lane`` set to n, is below 2^(64 -
    pow_bits), as a 0-d tensor (2^32 if there is none).  Nonces go in
    batches, in increasing order, and the first hit wins; reading the hit
    back to the host ends each batch."""
    state = absorb(state, inputs)
    batch = min(GRIND_BATCH, 1 << (pow_bits + 2))
    bound = gl.const(1 << (64 - pow_bits), state)
    for start in range(0, 1 << 32, batch):
        st = state.repeat(batch, 1)
        st[:, lane] = start + torch.arange(batch, device=state.device)
        ok = gl.ult(permute(st)[:, RATE - 1], bound)
        if bool(ok.any()):
            return start + ok.to(torch.int8).argmax()
    return torch.full((), 1 << 32, dtype=torch.int64, device=state.device)


# ---------------------------------------------------------------------------
# Scalar (python-int) permutation for the host challenger and proof
# verification paths.

_EXT_INT = [[int(_EXT_RC[r, i]) for i in range(WIDTH)]
            for r in range(EXTERNAL_ROUNDS)]
_INT_INT = [int(v) for v in _INT_RC]
_DIAG_M1_INT = [int(v) for v in DIAG_M1]
_P = gl.P


def _sbox_int(x):
    x2 = x * x % _P
    x3 = x2 * x % _P
    return x3 * x3 % _P * x % _P


def _external_matrix_int(state):
    return [sum(_ME_INT[i][j] * state[j] for j in range(WIDTH)) % _P
            for i in range(WIDTH)]


def _internal_matrix_int(state):
    s = sum(state) % _P
    return [(s + _DIAG_M1_INT[i] * state[i]) % _P for i in range(WIDTH)]


def permute_ints(state):
    """Poseidon2 permutation on a list of 12 python ints (host scalar path).

    Bit-identical to the vectorized `make_poseidon(...).permute` (tested)."""
    assert len(state) == WIDTH
    state = _external_matrix_int(list(state))
    half = EXTERNAL_ROUNDS // 2
    for r in range(half):
        state = [_sbox_int((state[i] + _EXT_INT[r][i]) % _P)
                 for i in range(WIDTH)]
        state = _external_matrix_int(state)
    for r in range(INTERNAL_ROUNDS):
        state = list(state)
        state[0] = _sbox_int((state[0] + _INT_INT[r]) % _P)
        state = _internal_matrix_int(state)
    for r in range(half, EXTERNAL_ROUNDS):
        state = [_sbox_int((state[i] + _EXT_INT[r][i]) % _P)
                 for i in range(WIDTH)]
        state = _external_matrix_int(state)
    return state


def hash_no_pad_ints(inputs):
    state = [0] * WIDTH
    for off in range(0, len(inputs), RATE):
        chunk = inputs[off:off + RATE]
        state = list(chunk) + state[len(chunk):]
        state = permute_ints(state)
    return tuple(state[:DIGEST])


def two_to_one_ints(left, right):
    state = list(left) + list(right) + [0] * (WIDTH - RATE)
    state = permute_ints(state)
    return tuple(state[:DIGEST])
