"""Use-case layer: prove / write_vk / verify on files.

Counterpart of ``tpu_acir_prover/api.py``.  The translated and compiled
circuit and the device-resident proving key are cached by bytecode hash,
config and device, and shared between prove and write_vk.  ``prove_file``
runs the fused prover (``prover/fused.py``: one CUDA graph replay a proof
on the card, the same body eagerly on the CPU) for traces up to 2^18 rows
and the per-phase ``prove()`` above; ``TPU_ACIR_FUSED=0/1`` forces either.
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import Dict, Tuple

from .acir import codec
from .acir.translator import AcirTranslator, translate_program
from .circuit.compile import compile_circuit
from .prover.compress import compress_proof, decompress_proof
from .prover.config import ProofConfig, STANDARD_CONFIG
from .prover.fused import prove_fused
from .prover.prove import ProvingKey, prove, resolve_device
from .prover.serialization import (
    COMPRESSED_PROOF_MAGIC, deserialize_compressed_proof, deserialize_proof,
    deserialize_vk, serialize_compressed_proof, serialize_proof, serialize_vk)
from .prover.verify import verify
from .utils import timing

_CACHE: Dict[Tuple[bytes, ProofConfig, str],
             Tuple[AcirTranslator, ProvingKey]] = {}


def load_and_compile(bytecode_path: str, config: ProofConfig = STANDARD_CONFIG,
                     device="cuda"):
    """ACIR artifact -> (translator, proving key), cached by file content."""
    dev = resolve_device(device)
    with open(bytecode_path, "rb") as f:
        content = f.read()
    key = (hashlib.sha256(content).digest(), config, str(dev))
    if key not in _CACHE:
        tr = translate_program(codec.load_program_artifact(bytecode_path))
        _CACHE[key] = (tr, ProvingKey(compile_circuit(tr.builder), config,
                                      device=dev))
    return _CACHE[key]


def _prove_dispatch(pk: ProvingKey, ext, timer=None, **kw):
    """The fused prover up to 2^18 rows, the per-phase one above (its
    temporaries are freed between phases); TPU_ACIR_FUSED=0/1 forces.
    ``kw`` goes to the prover (``with_indices``)."""
    fused_default = "1" if pk.n <= (1 << 18) else "0"
    if os.environ.get("TPU_ACIR_FUSED", fused_default) != "0":
        return prove_fused(pk, ext, timer=timer, **kw)
    return prove(pk, ext, timer=timer, **kw)


def prove_file(bytecode_path: str, witness_path: str, out_path: str,
               config: ProofConfig = STANDARD_CONFIG, device="cuda",
               compress: bool = True, timer=None) -> bytes:
    """Prove the witness file's first stack item and write the proof file.

    An enabled ``timer`` (``utils/timing.PhaseTimer``) gets one span for
    each step of the call, the provers' own phases among them, and the
    call's counters; the call's record goes to ``timing.finished()``.  The
    compressor takes the query indices the prover drew, so the transcript
    is not replayed (``compress_replays`` 0)."""
    timer = timer or timing.PhaseTimer(enabled=False)
    with timing.proof(timer):
        with timer.phase("key_lookup"):
            tr, pk = load_and_compile(bytecode_path, config, device)
        with timer.phase("witness_read"):
            ws = codec.load_witness_stack(witness_path)
            witness_map = ws.peek().witness if ws.stack else {}
            ext = tr.external_values(witness_map)
        proof, indices = _prove_dispatch(pk, ext, timer=timer,
                                         with_indices=True)
        if compress:
            proof = compress_proof(pk.vk, proof, timer=timer,
                                   indices=indices)
        with timer.phase("serialize"):
            data = (serialize_compressed_proof if compress
                    else serialize_proof)(proof)
        with timer.phase("write"):
            with open(out_path, "wb") as f:
                f.write(data)
    return data


def write_vk_file(bytecode_path: str, out_path: str,
                  config: ProofConfig = STANDARD_CONFIG,
                  device="cuda") -> bytes:
    _, pk = load_and_compile(bytecode_path, config, device)
    data = serialize_vk(pk.vk)
    with open(out_path, "wb") as f:
        f.write(data)
    return data


def verify_file(vk_path: str, proof_path: str) -> None:
    """Raises on failure; returns None on success."""
    with open(vk_path, "rb") as f:
        vk = deserialize_vk(f.read())
    with open(proof_path, "rb") as f:
        data = f.read()
    if len(data) >= 4 and \
            struct.unpack("<I", data[:4])[0] == COMPRESSED_PROOF_MAGIC:
        proof = decompress_proof(vk, deserialize_compressed_proof(data))
    else:
        proof = deserialize_proof(data)
    verify(vk, proof)
