"""NTT, inverse NTT and coset LDE over Goldilocks as plain torch ops.

Counterpart of the natural-order radix-2/4 pipeline in
``tpu_acir_prover/prover/ntt.py`` (``ntt``, ``intt``, ``coset_lde``,
``coset_intt``, ``device_powers``).  Values are ``(n, C)`` int64 tensors:
rows are the evaluation domain, columns are polynomials.
"""

from __future__ import annotations

import torch

from ..field import gl
from ..field.gl import MULTIPLICATIVE_GENERATOR, root_of_unity, s_inv


def _bit_reverse(log_n: int, device) -> torch.Tensor:
    idx = torch.arange(1 << log_n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def ntt(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """NTT along axis 0 of an ``(n,)`` or ``(n, C)`` tensor, natural order
    in and out (bit reversal applied first)."""
    squeeze = values.dim() == 1
    x = values.reshape(values.shape[0], -1)
    n, c = x.shape
    log_n = n.bit_length() - 1
    assert (1 << log_n) == n, "NTT size must be a power of two"
    x = x.index_select(0, _bit_reverse(log_n, x.device))
    w_last = root_of_unity(log_n)
    if inverse:
        w_last = s_inv(w_last)
    # one power table; stage s twiddles are a strided view of it
    ptab = gl.powers(w_last, max(n // 2, 1), x.device)

    def stage_tw(s):
        return ptab[::1 << (log_n - 1 - s)][:1 << s]

    s = 0
    while s < log_n:
        h = 1 << s
        tw1 = stage_tw(s).reshape(1, h, 1)
        if s + 1 < log_n:
            # two radix-2 stages in one pass (radix 4)
            tw2 = stage_tw(s + 1)
            wa, wb = tw2[:h].reshape(1, h, 1), tw2[h:].reshape(1, h, 1)
            v = x.reshape(-1, 2, 2, h, c)
            a, b, cc, d = v[:, 0, 0], v[:, 0, 1], v[:, 1, 0], v[:, 1, 1]
            t1 = gl.mul(b, tw1)
            p0, p1 = gl.add(a, t1), gl.sub(a, t1)
            t2 = gl.mul(d, tw1)
            q0, q1 = gl.add(cc, t2), gl.sub(cc, t2)
            ta, tb = gl.mul(q0, wa), gl.mul(q1, wb)
            x = torch.stack([gl.add(p0, ta), gl.add(p1, tb),
                             gl.sub(p0, ta), gl.sub(p1, tb)],
                            dim=1).reshape(n, c)
            s += 2
            continue
        v = x.reshape(-1, 2, h, c)
        t = gl.mul(v[:, 1], tw1)
        x = torch.stack([gl.add(v[:, 0], t), gl.sub(v[:, 0], t)],
                        dim=1).reshape(n, c)
        s += 1
    if inverse:
        x = gl.mul(x, gl.const(s_inv(n), x))
    return x.reshape(-1) if squeeze else x


def intt(values: torch.Tensor) -> torch.Tensor:
    return ntt(values, inverse=True)


def coset_lde(coeffs: torch.Tensor, rate_bits: int,
              shift: int = MULTIPLICATIVE_GENERATOR) -> torch.Tensor:
    """Evaluate ``(n, C)`` coefficient columns on the coset
    shift * H_{n * 2^rate_bits}."""
    x = coeffs.reshape(coeffs.shape[0], -1)
    n, c = x.shape
    x = gl.mul(x, gl.powers(shift, n, x.device).reshape(n, 1))
    pad = torch.zeros(((n << rate_bits) - n, c), dtype=torch.int64,
                      device=x.device)
    return ntt(torch.cat([x, pad]))


def coset_intt(values: torch.Tensor,
               shift: int = MULTIPLICATIVE_GENERATOR) -> torch.Tensor:
    """Interpolate values on coset shift * H_m back to coefficients."""
    x = intt(values.reshape(values.shape[0], -1))
    m = x.shape[0]
    return gl.mul(x, gl.powers(s_inv(shift), m, x.device).reshape(m, 1))
