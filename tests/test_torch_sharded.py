"""The port's multi-device prover (``parallel/prove.py``) on the CPU: the
proof of ``prove_sharded`` over 1, 2, 4 and 8 shards has the same
``serialize_proof`` bytes as the JAX package's numpy prover and as the
port's single-device prover, and the port's verifier accepts it, on the
plain circuits (the lookup circuit is in ``test_torch_sharded_lookup.py``,
so that the two files run on separate workers).  Also the key's layout
(every domain-axis tensor really split over the shards) and the guards.
The shards are CPU devices; the kernel wrappers take the plain twins
there."""

import pytest
import torch

from tpu_acir_prover_torch.parallel.mesh import Mesh
from tpu_acir_prover_torch.parallel.prove import (ShardedProvingKey,
                                                  prove_sharded)
from tpu_acir_prover_torch.prover.config import TEST_CONFIG
from tpu_acir_prover_torch.prover.fused import prove_fused
from tpu_acir_prover_torch.prover.verify import verify

from sharded_cases import SHARDS, case, check_sharded_proof

torch.set_num_threads(1)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", ["fibonacci", "range_33"])
def test_sharded_proof_bytes_match(name, shards):
    check_sharded_proof(name, shards)


def _assert_blocks(blocks, mesh, rows):
    """A list of one block per shard, shard s holding ``rows`` rows of its
    own on mesh device s (not a view into a larger tensor)."""
    assert isinstance(blocks, list) and len(blocks) == mesh.size
    for s, b in enumerate(blocks):
        assert b.device == mesh.devices[s]
        assert b.shape[0] == rows
        assert b.untyped_storage().nbytes() == b.numel() * b.element_size()
    ptrs = {b.untyped_storage().data_ptr() for b in blocks}
    assert len(ptrs) == mesh.size


def test_sharded_tensors_actually_sharded():
    """Every domain-axis tensor of the key, and every oracle's
    coefficients and LDE in a proof, is split into row blocks."""
    cc, _, ext = case("lookup_bits=8")
    mesh = Mesh.on("cpu", 4)
    spk = ShardedProvingKey(cc, TEST_CONFIG, mesh=mesh)
    n, m = spk.n, spk.m
    lde_axis = ("x_lde", "zh_lde", "zh_inv_lde")
    assert sorted(spk.domain_tables) == sorted(
        lde_axis + ("x_h", "sigma", "table", "qlk"))
    for name in spk.domain_tables:
        _assert_blocks(getattr(spk, name), mesh,
                       (m if name in lde_axis else n) // 4)
    assert [w.shape for w in spk.wire_idx] == [(spk.W, n // 4)] * 4
    oracles = [spk.constants_oracle]
    commit = spk.commit

    def spy(values, from_coeffs=False):
        oracles.append(commit(values, from_coeffs))
        return oracles[-1]

    spk.commit = spy
    verify(spk.vk, prove_sharded(spk, ext))
    assert len(oracles) == 4
    for o in oracles:
        _assert_blocks(o.coeffs, mesh, n // 4)
        _assert_blocks(o.lde, mesh, m // 4)
        assert o.tree.num_leaves == m


def test_guards():
    cc, _, ext = case("fibonacci")
    with pytest.raises(ValueError, match="power of two"):
        Mesh.on("cpu", 6)
    with pytest.raises(ValueError, match="do not divide"):
        ShardedProvingKey(cc, TEST_CONFIG, mesh=Mesh.on("cpu", 2 * cc.n))
    spk = ShardedProvingKey(cc, TEST_CONFIG, mesh=Mesh.on("cpu", 2))
    with pytest.raises(TypeError, match="prove_sharded"):
        prove_fused(spk, ext)


def test_cuda_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Mesh.on("cuda", 2)
    with pytest.raises(RuntimeError, match="cuda"):
        Mesh(["cpu", "cuda:1"])
