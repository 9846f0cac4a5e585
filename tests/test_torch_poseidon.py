"""Port Poseidon2 (plain twins and kernel wrappers) against the JAX
package: the scalar permutation and the Pallas kernels run in interpret
mode, as tests/test_pallas.py runs them (same shapes, so a warm compile
cache serves both).  Bit-equal comparisons throughout.

The CUDA kernels are held to the plain twins on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_acir_prover.field import poseidon as jpz
from tpu_acir_prover.field.gl import P
from tpu_acir_prover.kernels import poseidon_pallas as pallas
from tpu_acir_prover_torch.field import gl
from tpu_acir_prover_torch.field import poseidon as plain
from tpu_acir_prover_torch.kernels import poseidon as kp

torch.set_num_threads(1)


def _rand_u64(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


def _jax_pair(v):
    return (jnp.asarray((v & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((v >> np.uint64(32)).astype(np.uint32)))


def _from_jax(pair):
    """(lo, hi) JAX pair of (k, M) -> (M, k) port tensor."""
    return gl.from_limbs(np.asarray(pair[0]), np.asarray(pair[1]), "cpu").T


def test_permute_matches_permute_ints():
    st = _rand_u64((6, 12), seed=1)
    st[0] = 0
    st[1] = P - 1
    got = gl.to_u64(kp.permute(gl.from_u64(st, "cpu")))
    for i in range(st.shape[0]):
        assert [int(x) for x in got[i]] == \
            jpz.permute_ints([int(x) for x in st[i]])


@pytest.mark.parametrize("c", [1, 8, 9, 43])
def test_hash_no_pad_matches_ints(c):
    m = _rand_u64((5, c), seed=c)
    got = gl.to_u64(plain.hash_no_pad(gl.from_u64(m, "cpu")))
    for i in range(m.shape[0]):
        assert tuple(int(x) for x in got[i]) == \
            jpz.hash_no_pad_ints([int(x) for x in m[i]])


@pytest.mark.parametrize("c", [4, 12, 17])
def test_leaf_hash_matches_pallas_interpret(c):
    v = _rand_u64((c, 256), seed=c)
    want = pallas.leaf_hash(_jax_pair(v), tile=128, interpret=True)
    got = kp.leaf_hash(gl.from_u64(np.ascontiguousarray(v.T), "cpu"))
    assert torch.equal(got, _from_jax(want))


def test_two_to_one_level_matches_pallas_interpret():
    left, right = _rand_u64((4, 256), seed=1), _rand_u64((4, 256), seed=2)
    want = pallas.two_to_one_level(_jax_pair(left), _jax_pair(right),
                                   tile=128, interpret=True)
    # child level (2N, 4): children 2i and 2i+1 are left i and right i
    child = np.stack([left.T, right.T], axis=1).reshape(512, 4)
    got = kp.two_to_one_levels(gl.from_u64(child, "cpu"), 2)
    assert torch.equal(got[0], _from_jax(want))
    # the next level up: parents of Pallas level entries 2i and 2i+1
    want2 = pallas.two_to_one_level((want[0][:, 0::2], want[1][:, 0::2]),
                                    (want[0][:, 1::2], want[1][:, 1::2]),
                                    tile=128, interpret=True)
    assert torch.equal(got[1], _from_jax(want2))


def test_two_to_one_matches_ints():
    d = _rand_u64((3, 8), seed=5)
    got = gl.to_u64(plain.two_to_one(gl.from_u64(d[:, :4], "cpu"),
                                     gl.from_u64(d[:, 4:], "cpu")))
    for i in range(3):
        assert tuple(int(x) for x in got[i]) == jpz.two_to_one_ints(
            [int(x) for x in d[i, :4]], [int(x) for x in d[i, 4:]])


@pytest.mark.parametrize("k", range(9))
def test_duplex_twin_matches_permute_ints(k):
    """The duplex (its plain twin here) on k inputs that are 0-d views at
    offsets into two tensors, against the JAX package's scalar permutation
    of the absorbed state and against the twin's own permute."""
    st = _rand_u64(12, seed=20 + k)
    a, b = _rand_u64(7, seed=40 + k), _rand_u64(5, seed=60 + k)
    ta, tb = gl.from_u64(a, "cpu"), gl.from_u64(b, "cpu")
    inputs = [ta[1 + i // 2] if i % 2 == 0 else tb[3 - i // 2]
              for i in range(k)]
    state = gl.from_u64(st, "cpu")
    got = kp.duplex(state, inputs)
    want = [int(x) for x in st]
    want[:k] = [int(gl.to_u64(x)) for x in inputs]
    assert [int(x) for x in gl.to_u64(got)] == jpz.permute_ints(want)
    assert torch.equal(got, plain.permute(plain.absorb(state, inputs)))
    assert torch.equal(state, gl.from_u64(st, "cpu"))  # a new state


def test_wrappers_check_inputs_and_count_only_kernel_launches():
    before = dict(kp.launches)
    x = gl.from_u64(_rand_u64((4, 12), seed=3), "cpu")
    kp.permute(x)
    kp.leaf_hash(x)
    kp.two_to_one_levels(x[:, :4], 2)
    kp.duplex(x[0], list(x[1, :8].unbind()))
    kp.grind(x[0], 3, 2, list(x[1, :3].unbind()))
    assert kp.launches == before  # CPU tensors run the plain twins
    with pytest.raises(TypeError):
        kp.permute(x.to(torch.int32))
    with pytest.raises(ValueError):
        kp.permute(x[:, :8])
    with pytest.raises(ValueError):
        kp.two_to_one_levels(x[:3, :4], 1)
    with pytest.raises(ValueError):
        kp.leaf_hash(x.to("meta"))
    # the sponge inputs of duplex and grind: int64, 0-d, at most 8 (at
    # most the nonce lane for the grind), on the state's device
    state, one = x[0], x[1, 0]
    with pytest.raises(TypeError):
        kp.duplex(state, [one.to(torch.int32)])
    with pytest.raises(ValueError):
        kp.duplex(state, [x[1, :1]])
    with pytest.raises(ValueError):
        kp.duplex(state, [one] * 9)
    with pytest.raises(ValueError):
        kp.duplex(state, [one.to("meta")])
    with pytest.raises(ValueError):
        kp.duplex(x[:1], [one])
    with pytest.raises(TypeError):
        kp.grind(state, 1, 2, [one.to(torch.int32)])
    with pytest.raises(ValueError):
        kp.grind(state, 1, 2, [x[1, :1]])
    with pytest.raises(ValueError):
        kp.grind(state, 1, 2, [one, one])
    with pytest.raises(ValueError):
        kp.grind(state, 1, 2, [one.to("meta")])
