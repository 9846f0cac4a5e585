"""The port's mesh modules (``tpu_acir_prover_torch/parallel/``) against the
JAX package on the CPU, bit for bit: the collectives, the four-step NTT
(single-device and over 8 shards), the sharded FRI layer and chain, the
leaf permutation and the (dp, sp) wire commitment.  The shards are CPU
devices; the kernel wrappers take the plain twins there."""

import numpy as np
import pytest
import torch

from tpu_acir_prover.field import gl as jgl
from tpu_acir_prover.field.gl import P, make_gl
from tpu_acir_prover.parallel import mesh as jmesh
from tpu_acir_prover.parallel import pipeline as jpipeline
from tpu_acir_prover.parallel.fri import layer_inv2x_padded as j_inv2x
from tpu_acir_prover_torch.field import gl
from tpu_acir_prover_torch.parallel.fri import (fri_chain_plan,
                                                layer_inv2x_padded,
                                                make_sharded_fri_layer)
from tpu_acir_prover_torch.parallel.mesh import (Mesh, _twiddle_matrix,
                                                 four_step_ntt_reference,
                                                 make_sharded_ntt)
from tpu_acir_prover_torch.parallel.pipeline import (grid_dims,
                                                     leaf_permutation,
                                                     make_sharded_wire_commit)
from tpu_acir_prover_torch.prover.ntt import ntt

from test_parallel_fri import BETA, _single_chip
from test_sharded_commit import host_reference_caps

torch.set_num_threads(1)

GNP = make_gl(np)


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, P, size=n, dtype=np.uint64)


def _blocks(v, d):
    """A (n,) uint64 array as d CPU row blocks."""
    return Mesh.on("cpu", d).scatter(gl.from_u64(v, "cpu"))


def _u64(blocks):
    return gl.to_u64(torch.cat(blocks))


def test_collectives_on_a_two_axis_mesh():
    mesh = Mesh([["cpu"] * 4] * 2, ("dp", "sp"))
    assert mesh.shape == {"dp": 2, "sp": 4} and mesh.size == 8
    assert [mesh.axis_index("sp", s) for s in range(8)] == [0, 1, 2, 3] * 2
    assert [mesh.axis_index("dp", s) for s in range(8)] == [0] * 4 + [1] * 4
    assert mesh.groups("sp") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.groups("dp") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    xs = [torch.arange(8).reshape(2, 4) + 100 * s for s in range(8)]
    got = mesh.all_gather(xs, "sp", dim=1)
    for s in range(8):
        g = mesh.groups("sp")[s // 4]
        assert torch.equal(got[s], torch.cat([xs[i] for i in g], 1))
    stacked = mesh.all_gather(xs, "dp", tiled=False)
    assert torch.equal(stacked[5], torch.stack([xs[1], xs[5]]))
    # all_to_all: member j gets piece j of every member along the axis
    a2a = mesh.all_to_all(xs, "sp", split_axis=1, concat_axis=0)
    for s in range(8):
        g, j = mesh.groups("sp")[s // 4], s % 4
        assert torch.equal(a2a[s], torch.cat([xs[i][:, j:j + 1] for i in g]))
    # ppermute: receivers get the sender's shard, the rest zeros
    pp = mesh.ppermute(xs, [(0, 1), (1, 3)], "sp")
    for s in range(8):
        base = 4 * (s // 4)
        want = {1: xs[base], 3: xs[base + 1]}.get(s % 4,
                                                 torch.zeros_like(xs[0]))
        assert torch.equal(pp[s], want)


@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_reference_matches_jax_and_plain(inverse):
    n, a, b = 256, 16, 16
    v = _rand(n, 0)
    assert np.array_equal(_twiddle_matrix(a, b, inverse),
                          jmesh._twiddle_matrix(a, b, inverse))
    got = gl.to_u64(four_step_ntt_reference(gl.from_u64(v, "cpu"), a, b,
                                            inverse))
    want = GNP.to_u64(jmesh.four_step_ntt_reference(
        GNP, GNP.from_u64(v), a, b, inverse=inverse))
    assert np.array_equal(got, want)
    assert np.array_equal(got, gl.to_u64(ntt(gl.from_u64(v, "cpu"),
                                             inverse)))


@pytest.mark.parametrize("inverse", [False, True])
def test_sharded_ntt_matches_plain(inverse):
    n, a, b, d = 1024, 32, 32, 8
    v = _rand(n, 1)
    mesh = Mesh.on("cpu", d)
    run = make_sharded_ntt(mesh, "sp", a, b, inverse)
    out = run(mesh.scatter(gl.from_u64(v.reshape(a, b), "cpu"), dim=1))
    assert all(o.shape == (b, a // d) for o in out)
    got = gl.to_u64(torch.cat(out, dim=1)).reshape(-1)
    assert np.array_equal(got, gl.to_u64(ntt(gl.from_u64(v, "cpu"),
                                             inverse)))


def test_sharded_fri_layer_matches_single_chip():
    m, cap_height, d = 512, 3, 8
    shift = jgl.MULTIPLICATIVE_GENERATOR
    re, im = _rand(m, 7), _rand(m, 8)
    exp_caps, exp_re, exp_im = _single_chip(re, im, shift, cap_height)
    inv2x = layer_inv2x_padded(m, shift)
    assert np.array_equal(inv2x, j_inv2x(m, shift))
    run = make_sharded_fri_layer(Mesh.on("cpu", d), m, cap_height)
    caps, nxt = run((_blocks(re, d), _blocks(im, d)), _blocks(inv2x, d),
                    BETA)
    assert caps == exp_caps
    assert [x.shape[0] for x in nxt[0]] == [m // 2 // d] * d
    assert np.array_equal(_u64(nxt[0]), exp_re)
    assert np.array_equal(_u64(nxt[1]), exp_im)


def test_sharded_fri_chain():
    """A whole chain of shardable layers: every layer's caps and the
    surviving vector equal the single-chip reference's."""
    m, cap_height, final_domain, d = 1024, 2, 32, 8
    sizes, rest = fri_chain_plan(m, d, final_domain)
    assert sizes == [1024, 512, 256, 128, 64] and rest == 32
    mesh = Mesh.on("cpu", d)
    cur_re, cur_im = _rand(m, 11), _rand(m, 12)
    cur = (_blocks(cur_re, d), _blocks(cur_im, d))
    shift = jgl.MULTIPLICATIVE_GENERATOR
    for m_l in sizes:
        exp_caps, cur_re, cur_im = _single_chip(cur_re, cur_im, shift,
                                                cap_height)
        run = make_sharded_fri_layer(mesh, m_l, cap_height)
        caps, cur = run(cur, _blocks(layer_inv2x_padded(m_l, shift), d),
                        BETA)
        assert caps == exp_caps, f"caps diverged at layer size {m_l}"
        shift = (shift * shift) % P
    assert np.array_equal(_u64(cur[0]), cur_re)
    assert np.array_equal(_u64(cur[1]), cur_im)


@pytest.mark.parametrize("m,d", [(512, 4), (1024, 8), (64, 2), (8, 1)])
def test_leaf_permutation_matches_jax(m, d):
    got = leaf_permutation(m, d)
    assert np.array_equal(got, jpipeline.leaf_permutation(m, d))
    assert np.array_equal(np.sort(got), np.arange(m))
    assert grid_dims(m) == jpipeline.grid_dims(m)


def test_sharded_wire_commit_matches_reference():
    mesh = Mesh([["cpu"] * 4] * 2, ("dp", "sp"))
    n, c, rate_bits, bt = 64, 3, 3, 2
    wires = np.random.default_rng(7).integers(0, P, size=(bt, n, c),
                                              dtype=np.uint64)
    run = make_sharded_wire_commit(mesh, n, c, rate_bits)
    caps, evals = run(gl.from_u64(wires, "cpu"))
    A, B, Am, Bm = run.grid
    assert caps.shape == (bt, 4, 4)
    assert [e.shape for e in evals] == [(bt // 2, Bm, Am // 4, c)] * 8
    got = gl.to_u64(caps)
    for b in range(bt):
        expect = host_reference_caps(wires[b], rate_bits, 4)
        for s in range(4):
            assert tuple(int(x) for x in got[b, s]) == expect[s], (b, s)


def test_dropped_sharded_key_is_freed_without_the_cycle_collector():
    """A ShardedProvingKey's shards hold it weakly: with the cycle collector
    off, dropping the key frees it (and its device tensors) at once, and its
    proof over 2 shards keeps the single-device prover's bytes."""
    import gc
    import weakref

    from tpu_acir_prover_torch.acir.translator import translate_program
    from tpu_acir_prover_torch.circuit.compile import compile_circuit
    from tpu_acir_prover_torch.parallel.prove import (ShardedProvingKey,
                                                      prove_sharded)
    from tpu_acir_prover_torch.prover.config import TEST_CONFIG
    from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
    from tpu_acir_prover_torch.prover.serialization import serialize_proof
    from tpu_acir_prover_torch.utils import circuits

    prog, wm = circuits.fibonacci()
    tr = translate_program(prog)
    cc = compile_circuit(tr.builder)
    ext = tr.external_values(wm)
    want = serialize_proof(prove(ProvingKey(cc, TEST_CONFIG, device="cpu"),
                                 ext))
    enabled = gc.isenabled()
    gc.disable()
    try:
        spk = ShardedProvingKey(cc, TEST_CONFIG, mesh=Mesh.on("cpu", 2))
        assert serialize_proof(prove_sharded(spk, ext)) == want
        shard = spk.shards[1]
        ref = weakref.ref(spk)
        del spk
        assert ref() is None
        with pytest.raises(ReferenceError):
            shard.n
    finally:
        if enabled:
            gc.enable()
