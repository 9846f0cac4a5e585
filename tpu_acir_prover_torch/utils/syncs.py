"""Synchronising CUDA calls and warm wall time of the per-phase prover on the
2^17-row ECDSA circuit (``STANDARD_CONFIG``), on one card.

    python -m tpu_acir_prover_torch.utils.syncs [--proofs N]

prints one JSON line: the package it measured, the synchronising calls one
warm proof makes (as ``torch.cuda.set_sync_debug_mode("warn")`` reports
them: a prototype that may miss some), the wall time of N more warm proofs,
and the card's name and power limit.  Run it by path with another checkout
of the package first on ``PYTHONPATH`` to measure that checkout:

    PYTHONPATH=<checkout> python tpu_acir_prover_torch/utils/syncs.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings

import torch


def count_syncs(fn):
    """(fn(), the number of synchronising CUDA calls it made)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in seen)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--proofs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("syncs: torch.cuda.is_available() is false")
    import tpu_acir_prover_torch as pkg
    from tpu_acir_prover_torch.acir.translator import translate_program
    from tpu_acir_prover_torch.circuit.compile import compile_circuit
    from tpu_acir_prover_torch.prover.config import STANDARD_CONFIG
    from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
    from tpu_acir_prover_torch.utils import circuits

    prog, wm = circuits.ecdsa_secp256k1()
    tr = translate_program(prog)
    pk = ProvingKey(compile_circuit(tr.builder), STANDARD_CONFIG,
                    device="cuda")
    ext = tr.external_values(wm)
    prove(pk, ext)
    _, syncs = count_syncs(lambda: prove(pk, ext))
    warm = []
    for _ in range(args.proofs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove(pk, ext)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"package": pkg.__path__[0], "per_phase_syncs": syncs,
                      "warm_s": warm, "card": smi}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
