"""The field kernels' wrappers (``kernels/field.py``) on the CPU: the
dispatch to the plain twins and the broadcast layout the kernels are
given.  The twins against the JAX package's numpy field, on broadcast
shapes too, are ``tests/test_torch_field.py``'s; the kernels themselves
run in ``tests/test_torch_cuda.py`` on the card."""

import numpy as np
import pytest
import torch

from tpu_acir_prover_torch.field import ext as E
from tpu_acir_prover_torch.field import ext_plain, gl, gl_plain
from tpu_acir_prover_torch.field.gl import P
from tpu_acir_prover_torch.kernels import field as kf

torch.set_num_threads(1)

EDGES = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
         1 << 63, P >> 1]


def _u64(shape, seed):
    """Canonical values from a seed, the edge values at the front."""
    v = np.random.default_rng(seed).integers(0, P, size=shape,
                                             dtype=np.uint64).reshape(-1)
    k = min(v.size, len(EDGES))
    v[:k] = np.array(EDGES[:k], dtype=np.uint64)
    return v.reshape(shape)


def _t(v):
    """A u64 array as a tensor of its shape (0-d included)."""
    return gl.from_u64(v, "cpu").reshape(np.shape(v))


# broadcast operand shapes the prover gives the field ops
BROADCAST = [((64, 5), (64, 1)), ((), (9, 4)), ((1, 8, 1), (4, 8, 3)),
             ((6, 1), (1, 7)), ((12,), ())]


def test_cpu_tensors_reach_the_plain_twins_and_launch_nothing():
    a, b = _t(_u64((33, 4), 1)), _t(_u64((33, 1), 2))
    x, y = (a, b.expand(33, 4)), (b, a)
    before = dict(kf.launches)
    pairs = [
        (gl.add(a, b), gl_plain.add(a, b)),
        (gl.sub(a, b), gl_plain.sub(a, b)),
        (gl.mul(a, b), gl_plain.mul(a, b)),
        (gl.sqr(a), gl_plain.sqr(a)),
        (gl.mul_const(a, 12345), gl_plain.mul_const(a, 12345)),
        (gl.pow_const(a, 1000003), gl_plain.pow_const(a, 1000003)),
        (gl.inv(a), gl_plain.inv(a)),
        *zip(E.mul(x, y), ext_plain.mul(x, y)),
        *zip(E.inv(x), ext_plain.inv(x)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert kf.launches == before


@pytest.mark.parametrize("call", [
    lambda: gl.add(torch.zeros(3, dtype=torch.int32),
                   torch.zeros(3, dtype=torch.int64)),
    lambda: gl.mul(torch.zeros(3, dtype=torch.int64), 5),
    lambda: E.inv((torch.zeros(3, dtype=torch.int64),
                   torch.zeros(3, dtype=torch.float64))),
])
def test_wrappers_take_int64_tensors_only(call):
    with pytest.raises(TypeError):
        call()


def test_wrappers_raise_on_other_devices_and_exponents():
    m = torch.zeros(3, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gl.add(m, m)
    a = torch.zeros(3, dtype=torch.int64)
    for e in (-1, 1 << 64):
        with pytest.raises(ValueError, match="exponent"):
            gl.pow_const(a, e)


def _check_layout(tensors):
    """Each operand read through ``layout``'s sizes and strides from its
    own storage is its broadcast view, element for element."""
    shape, sizes, strides = kf.layout(*tensors)
    want = torch.broadcast_tensors(*tensors)
    assert tuple(shape) == tuple(want[0].shape)
    assert 1 <= len(sizes) <= len(shape) + 1
    for t, st, w in zip(tensors, strides, want):
        assert len(st) == len(sizes)
        if w.numel() == 0:
            continue
        got = torch.as_strided(t, sizes, st, t.storage_offset())
        assert torch.equal(got.reshape(w.shape), w)
    return sizes, strides


@pytest.mark.parametrize("shapes", BROADCAST + [((0, 3), (1, 3))])
def test_layout_matches_broadcast_tensors(shapes):
    ts = [_t(_u64(s, i)) for i, s in enumerate(shapes)]
    _check_layout(ts)


def test_layout_of_strided_views_and_merged_dimensions():
    # the NTT's radix-4 views v[:, i, j] of a (-1, 2, 2, h, c) reshape
    # against the (1, h, 1) twiddles
    v = _t(_u64((64, 3), 3)).reshape(-1, 2, 2, 4, 3)
    tw = _t(_u64((4,), 4)).reshape(1, 4, 1)
    for i in (0, 1):
        for j in (0, 1):
            sizes, strides = _check_layout((v[:, i, j], tw))
            assert len(sizes) == 3
    # contiguous operands of one shape: one dimension of stride 1
    a, b = _t(_u64((16, 5), 5)), _t(_u64((16, 5), 6))
    assert _check_layout((a, b)) == ([80], [[1], [1]])
    # a column expanded over rows, a transposed operand, a 0-d constant
    assert _check_layout((a, gl.const(7, a))) == ([80], [[1], [0]])
    _check_layout((a.t(), b.t()))
    _check_layout((a[:, 1::2], _t(_u64((2,), 7))))
    _check_layout((_t(_u64((5,), 8)).expand(16, 5), a))


def test_layout_rank_limit():
    shapes = [(2, 1, 3, 1, 2, 1, 2), (1, 2, 1, 2, 1, 2, 1)]
    ts = [_t(_u64(s, i)) for i, s in enumerate(shapes)]
    sizes, _ = _check_layout(ts)
    assert len(sizes) == kf.MAX_RANK + 1
    # the CPU path computes it; the kernel path would raise
    assert torch.equal(gl.add(*ts), gl_plain.add(*ts))


def test_layout_on_the_provers_operands(monkeypatch):
    """Every operand tuple the per-phase, fused and sharded provers hand
    the field ops on a small lookup circuit: its layout reads each operand
    as torch broadcasts it, within the kernels' rank."""
    from tpu_acir_prover_torch.circuit.builder import CircuitBuilder
    from tpu_acir_prover_torch.circuit.compile import compile_circuit
    from tpu_acir_prover_torch.parallel.mesh import Mesh
    from tpu_acir_prover_torch.parallel.prove import (ShardedProvingKey,
                                                      prove_sharded)
    from tpu_acir_prover_torch.prover.config import TEST_CONFIG
    from tpu_acir_prover_torch.prover.fused import prove_fused
    from tpu_acir_prover_torch.prover.prove import ProvingKey, prove

    seen = {}
    route = kf._route

    def spy(tensors, what):
        key = (what,) + tuple((tuple(t.shape), t.stride()) for t in tensors)
        seen.setdefault(key, tuple(tensors))
        return route(tensors, what)

    monkeypatch.setattr(kf, "_route", spy)
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
    kinds = {k[0] for k in seen}
    assert kinds == {"add", "sub", "mul", "pow_const", "ext_mul", "ext_inv",
                     "ext_prod"}
    assert any(not t.is_contiguous() for ts in seen.values() for t in ts)
    for tensors in seen.values():
        sizes, _ = _check_layout(tensors)
        assert len(sizes) <= kf.MAX_RANK
