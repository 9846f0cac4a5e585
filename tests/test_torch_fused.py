"""The port's fused prover (``tpu_acir_prover_torch.prover.fused``) and the
device-side pieces it is built from, against the JAX package, bit for bit
(field arithmetic and hashing are exact: no tolerance).

The port runs on the CPU here, where ``prove_fused`` runs its graph body
eagerly and the kernel wrappers take their plain twins.  The JAX
package's ``prove_fused`` is not called: its XLA compile takes minutes on a
CPU (tests/test_fused.py); its numpy ``GraphChallenger`` and the numpy
``ProvingKey`` stand for it.
"""

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

from tpu_acir_prover.acir import codec, ir
from tpu_acir_prover.acir.translator import translate_program
from tpu_acir_prover.circuit.compile import compile_circuit
from tpu_acir_prover.field.ext import e_add, e_mul
from tpu_acir_prover.field.gl import P, make_gl
from tpu_acir_prover.field.poseidon import make_poseidon
from tpu_acir_prover.prover import fused as jfused
from tpu_acir_prover.prover.challenger import Challenger as JaxChallenger
from tpu_acir_prover.prover.config import TEST_CONFIG
from tpu_acir_prover.prover.merkle import merkle_commit
from tpu_acir_prover.prover.prove import ProvingKey as OracleKey
from tpu_acir_prover.prover.prove import ext_powers_u64
from tpu_acir_prover.prover.prove import prove as oracle_prove
from tpu_acir_prover.prover.serialization import serialize_proof
from tpu_acir_prover_torch import api
from tpu_acir_prover_torch.field import ext as E
from tpu_acir_prover_torch.field import gl
from tpu_acir_prover_torch.field import poseidon as plain
from tpu_acir_prover_torch.kernels import poseidon as kp
from tpu_acir_prover_torch.prover import fused
from tpu_acir_prover_torch.prover.challenger import Challenger
from tpu_acir_prover_torch.prover.merkle import gather_paths, merkle_tree
from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
from tpu_acir_prover_torch.prover.verify import verify

import factories

torch.set_num_threads(1)

G = make_gl(np)
H = make_poseidon(G)
CIRCUITS = ["fibonacci", "range_33", "memory_write"]


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


def _limbs(v):
    v = np.asarray(v, dtype=np.uint64)
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


def _int(pair):
    return int(pair[0]) | (int(pair[1]) << 32)


@functools.lru_cache(maxsize=None)
def _circuit(name):
    prog, wm = factories.ALL_SMALL[name]()
    tr = translate_program(prog)
    return compile_circuit(tr.builder), tr.external_values(wm), tr, wm


@functools.lru_cache(maxsize=None)
def _key(name):
    return ProvingKey(_circuit(name)[0], TEST_CONFIG, device="cpu")


@functools.lru_cache(maxsize=None)
def _oracle_key(name):
    return OracleKey(_circuit(name)[0], TEST_CONFIG, xp=np)


# ---------------------------------------------------------------------------
# the device transcript


@pytest.mark.parametrize("seed", range(4))
def test_graph_challenger_matches_jax(seed):
    """A seeded random run of observe, observe-vector, observe-cap,
    challenge and ext-challenge calls gives the same challenges."""
    rng = np.random.default_rng(seed)
    port = fused.GraphChallenger("cpu")
    ref = jfused.GraphChallenger(H)
    got, want = [], []
    for _ in range(60):
        op = rng.integers(5)
        if op == 0:
            v = _rand((1,), rng.integers(1 << 30))
            port.observe(gl.from_u64(v, "cpu")[0])
            ref.observe(*(x[0] for x in _limbs(v)))
        elif op == 1:
            v = _rand((int(rng.integers(1, 20)),), rng.integers(1 << 30))
            port.observe_vec(gl.from_u64(v, "cpu"))
            ref.observe_vec(*_limbs(v))
        elif op == 2:
            cap = _rand((int(rng.choice([1, 2, 4, 16])), 4),
                        rng.integers(1 << 30))
            port.observe_vec(gl.from_u64(cap, "cpu"))
            ref.observe_cap(tuple(x.T for x in _limbs(cap)))
        elif op == 3:
            got.append(port.get_challenge())
            want.append(_int(ref.get_challenge()))
        else:
            got.extend(port.get_ext_challenge())
            want.extend(_int(c) for c in ref.get_ext_challenge())
    assert len(got) > 10
    assert [int(gl.to_u64(x)) for x in got] == want


@pytest.mark.parametrize("n", [1, 7, 64])
def test_powers_table_and_dot_match_host(n):
    z = tuple(int(v) for v in _rand((2,), n))
    zt = tuple(gl.const(v, device="cpu") for v in z)
    re, im = E.powers_table(zt, n)
    want_re, want_im = ext_powers_u64(z, n)
    assert np.array_equal(gl.to_u64(re), want_re)
    assert np.array_equal(gl.to_u64(im), want_im)
    ys = _rand((2, n), 100 + n)
    got = E.dot((gl.from_u64(ys[0], "cpu"), gl.from_u64(ys[1], "cpu")),
                (re, im))
    acc = (0, 0)
    for i in range(n):
        acc = e_add(acc, e_mul((int(ys[0, i]), int(ys[1, i])),
                               (int(want_re[i]), int(want_im[i]))))
    assert tuple(int(gl.to_u64(c)) for c in got) == acc


@pytest.mark.parametrize("cap_height", [0, 2, 6])
def test_gather_paths_match_jax(cap_height):
    m = _rand((64, 5), seed=cap_height)
    ref = merkle_commit(G, H, G.from_u64(m), cap_height)
    tree = merkle_tree(gl.from_u64(m, "cpu"), cap_height)
    idx = [0, 5, 63, 32, 5, 17]
    paths = gather_paths(tree.levels, torch.tensor(idx))
    ref_rows, ref_paths = ref.rows_and_paths(idx)
    assert len(paths) == 6 - cap_height
    for q in range(len(idx)):
        for lev, want in zip(paths, ref_paths[q]):
            assert np.array_equal(gl.to_u64(lev[q]), want)
    rows, host_paths = tree.rows_and_paths(idx)
    assert np.array_equal(rows, ref_rows)
    assert all(np.array_equal(a, b) for q in range(len(idx))
               for a, b in zip(host_paths[q], ref_paths[q]))


@pytest.mark.parametrize("seed,pow_bits", [(0, 1), (1, 4), (2, 8), (3, 10)])
def test_grind_twin_matches_jax(seed, pow_bits):
    """The grind wrapper (its plain twin here) and the per-phase grind give
    the JAX numpy ProvingKey's nonce, with 1, 4, 7 and 2 inputs buffered."""
    vals = [int(v) for v in _rand((9 + seed * 3,), seed)]
    ours, ref = Challenger(), JaxChallenger()
    for v in vals:
        ours.observe(v)
        ref.observe(v)
    want = _oracle_key("fibonacci").grind(ref, pow_bits)
    state = list(ours.state)
    state[:len(ours.input_buf)] = ours.input_buf
    got = kp.grind(gl.from_u64(np.array(state, np.uint64), "cpu"),
                   len(ours.input_buf), pow_bits)
    assert int(got) == want
    assert _key("fibonacci").grind(ours, pow_bits) == want
    ours.observe(want)
    assert ours.get_challenge() < 1 << (64 - pow_bits)


@pytest.mark.parametrize("k", range(8))
def test_grind_with_inputs_matches_jax_grind_graph(k):
    """The grind wrapper (its plain twin here), given the GraphChallenger's
    state and its k buffered inputs, finds the nonce of the JAX package's
    in-graph grind (run eagerly on numpy), and the state it leaves gives a
    challenge below the bound."""
    pow_bits = 6 + k % 3
    vals = _rand((8 * (1 + k % 2) + k,), 70 + k)
    port = fused.GraphChallenger("cpu")
    ref = jfused.GraphChallenger(H)
    port.observe_vec(gl.from_u64(vals, "cpu"))
    ref.observe_vec(*_limbs(vals))
    assert len(port.input_buf) == len(ref.input_buf) == k
    pk = type("Key", (), {"G": G, "H": H})
    with jax.disable_jit():
        want = int(jfused.grind_graph(pk, ref, pow_bits, batch=1 << 10))
    got = kp.grind(port.state, k, pow_bits, port.input_buf)
    assert int(got) == want
    port.observe(got)
    assert int(gl.to_u64(port.get_challenge())) < 1 << (64 - pow_bits)


# ---------------------------------------------------------------------------
# the fused prover


@pytest.mark.parametrize("name", CIRCUITS)
def test_prove_fused_matches_per_phase_and_numpy(name):
    ext = _circuit(name)[1]
    pk = _key(name)
    proof = fused.prove_fused(pk, ext)
    verify(pk.vk, proof)
    data = serialize_proof(proof)
    assert data == serialize_proof(prove(pk, ext))
    assert data == serialize_proof(oracle_prove(_oracle_key(name), ext))


def test_fused_bad_witness_rejected():
    _, _, tr, wm = _circuit("fibonacci")
    bad = dict(wm)
    bad[2] = (bad[2] + 1) % (2 ** 64)
    pk = _key("fibonacci")
    proof = fused.prove_fused(pk, tr.external_values(bad))
    with pytest.raises(AssertionError):
        verify(pk.vk, proof)


@pytest.mark.parametrize("env,n,want", [
    (None, 1 << 18, "fused"), (None, 1 << 19, "per_phase"),
    ("0", 1 << 4, "per_phase"), ("1", 1 << 19, "fused")])
def test_dispatch_choice(monkeypatch, env, n, want):
    """Fused up to 2^18 rows, per-phase above; TPU_ACIR_FUSED forces."""
    if env is None:
        monkeypatch.delenv("TPU_ACIR_FUSED", raising=False)
    else:
        monkeypatch.setenv("TPU_ACIR_FUSED", env)
    monkeypatch.setattr(api, "prove_fused", lambda pk, ext, timer: "fused")
    monkeypatch.setattr(api, "prove", lambda pk, ext, timer: "per_phase")
    assert api._prove_dispatch(type("Key", (), {"n": n}), None) == want


def test_prove_file_same_bytes_either_path(tmp_path, monkeypatch):
    prog, wm = factories.fibonacci()
    prog_path, wit_path = str(tmp_path / "p.json"), str(tmp_path / "w.gz")
    codec.save_program_artifact(prog_path, prog)
    codec.save_witness_stack(wit_path, ir.WitnessStack([ir.StackItem(0, wm)]))
    taken = []

    def spy(name, real):
        def f(*a, **k):
            taken.append(name)
            return real(*a, **k)
        return f

    monkeypatch.setattr(api, "prove_fused", spy("fused", api.prove_fused))
    monkeypatch.setattr(api, "prove", spy("per", api.prove))
    out = []
    for env in (None, "0"):
        if env is None:
            monkeypatch.delenv("TPU_ACIR_FUSED", raising=False)
        else:
            monkeypatch.setenv("TPU_ACIR_FUSED", env)
        out.append(api.prove_file(prog_path, wit_path, str(tmp_path / "o"),
                                  TEST_CONFIG, device="cpu"))
    assert taken == ["fused", "per"]
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the graph body reads nothing back and copies nothing in


class HostRead(AssertionError):
    pass


@contextlib.contextmanager
def _no_host_io():
    """Make every host read of a tensor, and every tensor made from host
    data, raise; yields a context that lifts the ban for a while."""
    def ban(name):
        def f(*args, **kwargs):
            raise HostRead(name)
        return f

    names = ["item", "__int__", "__index__", "__float__", "__bool__",
             "tolist", "numpy", "cpu"]
    saved = {k: getattr(torch.Tensor, k) for k in names}
    fns = {k: getattr(torch, k) for k in ("tensor", "as_tensor",
                                           "from_numpy")}

    @contextlib.contextmanager
    def lifted():
        for k, v in saved.items():
            setattr(torch.Tensor, k, v)
        for k, v in fns.items():
            setattr(torch, k, v)
        try:
            yield
        finally:
            apply()

    def apply():
        for k in saved:
            setattr(torch.Tensor, k, ban(k))
        for k in fns:
            setattr(torch, k, ban(k))

    apply()
    try:
        yield lifted
    finally:
        for k, v in saved.items():
            setattr(torch.Tensor, k, v)
        for k, v in fns.items():
            setattr(torch, k, v)


@pytest.mark.parametrize("name", ["fibonacci", "range_33"])
def test_fused_graph_makes_no_host_read(monkeypatch, name):
    """What a CUDA graph capture needs, shown on the CPU: _fused_graph
    neither reads a tensor back nor builds one from host data.  The one
    exception is the grind's plain twin, which reads each batch's hit flag;
    on the card the grind is one kernel launch (tests/test_torch_cuda.py)."""
    cc, ext, _, _ = _circuit(name)
    pk = _key(name)
    vals = cc.generate_witness(ext)
    mcol = cc.multiplicities(cc.wire_values(vals)) if pk.has_lookups \
        else None
    args = [None if a is None else gl.from_u64(a, "cpu") for a in
            (vals, np.array(cc.public_values(vals), np.uint64), mcol)]
    plain.permute(torch.zeros((1, 12), dtype=torch.int64))  # constants
    want, layout = fused._flat_graph(pk, *args)
    with _no_host_io() as lifted:
        with pytest.raises(HostRead):
            int(want[0])
        real = kp.grind

        def grind(*a):
            with lifted():
                return real(*a)

        monkeypatch.setattr(kp, "grind", grind)
        got, got_layout = fused._flat_graph(pk, *args)
    assert torch.equal(got, want)
    assert got_layout == layout
