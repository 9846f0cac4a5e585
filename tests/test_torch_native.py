"""The native witness cores of both packages: the JAX package's built once,
before any test runs, and the port's held to it on the ``ALL_SMALL``
programs.

``tpu_acir_prover.native._build_lib`` compiles ``witnesscore.c`` to one
temporary name shared by every process, and a process whose rename loses
the race to another caches "no native core" for its life; its witness
tests then skip.  So this module builds the library while it is imported,
under an exclusive lock on a file in the library's cache directory.
pytest-xdist's workers all collect (import) every test module before any
of them runs a test, so the first worker builds the library and the others
find it there and compile nothing.  A failed build raises nothing here:
``test_both_native_cores_load`` reports it.
"""

import fcntl
import os
import tempfile

import numpy as np
import pytest

import factories
from tpu_acir_prover import native as jnative
from tpu_acir_prover.acir.translator import translate_program as jtranslate
from tpu_acir_prover.circuit.compile import compile_circuit as jcompile
from tpu_acir_prover_torch import native as tnative
from tpu_acir_prover_torch.acir.translator import translate_program
from tpu_acir_prover_torch.circuit.compile import compile_circuit
from tpu_acir_prover_torch.utils import circuits


def _prebuild():
    """Build the JAX package's native library under the lock: (path, None)
    or (None, the error)."""
    cache = os.path.join(tempfile.gettempdir(),
                         f"tpu_acir_native_{os.getuid()}")
    try:
        os.makedirs(cache, exist_ok=True)
        with open(os.path.join(cache, "build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            return jnative._build_lib(), None
    except Exception as e:  # reported by test_both_native_cores_load
        return None, e


_BUILT, _BUILD_ERROR = _prebuild()


def test_both_native_cores_load():
    assert _BUILD_ERROR is None, f"native build failed: {_BUILD_ERROR!r}"
    assert os.path.exists(_BUILT)
    assert jnative.get_lib() is not None
    assert tnative.get_lib() is not None


def _schedule_arrays(builder):
    """compile.py's inputs of ``schedule_levels`` for a builder."""
    ops = builder.gen_ops
    op = np.array([o.op for o in ops], dtype=np.int32)
    out = np.array([o.out for o in ops], dtype=np.int64)
    a = np.array([o.a for o in ops], dtype=np.int64)
    b = np.array([o.b for o in ops], dtype=np.int64)
    off = np.zeros(len(builder.hints) + 1, dtype=np.int64)
    for i, h in enumerate(builder.hints):
        off[i + 1] = off[i] + len(h.inputs)
    ins = np.array([v for h in builder.hints for v in h.inputs],
                   dtype=np.int64)
    return op, out, a, b, off, ins, builder.num_vars


@pytest.mark.parametrize("name", sorted(factories.ALL_SMALL))
def test_port_native_core_matches_reference(name):
    """The port's core levels the reference's generator ops as the
    reference's core does, and the port's compiled program, run by the
    port's core, gives the reference's witness."""
    prog, wm = factories.ALL_SMALL[name]()
    tr = jtranslate(prog)
    cc = jcompile(tr.builder)
    args = _schedule_arrays(tr.builder)
    want = jnative.schedule_levels(*args)
    assert want is not None
    assert np.array_equal(tnative.schedule_levels(*args), want)

    tprog, twm = circuits.ALL_SMALL[name]()
    ttr = translate_program(tprog)
    tcc = compile_circuit(ttr.builder)
    for field in ("op", "out", "a", "b", "const", "order", "segments"):
        got, ref = getattr(tcc.gen_program, field), \
            getattr(cc.gen_program, field)
        assert np.array_equal(np.asarray(got), np.asarray(ref)), field
    assert np.array_equal(
        tcc._generate_witness_native(ttr.external_values(twm)),
        cc._generate_witness_native(tr.external_values(wm)))
