"""End-to-end example driver of the PyTorch port: for each example program,
write a nargo-style artifact and witness, then prove -> write_vk -> verify
through ``python -m tpu_acir_prover_torch.cli``, which must accept.

The counterpart of ``examples/run_examples.py``.  The programs are the
port's copies of the example builders
(``tpu_acir_prover_torch/utils/circuits.py``), written with the port's
codec; the CLI runs on ``--device`` (default ``cuda``) with the test
config.  With no names it runs the 14 small programs of ``ALL_SMALL``;
the heavy ones of ``ALL_HEAVY`` and ``sha256_compression`` (the
2^16-row one-compression circuit) run when named.  Each CLI step's time
is printed as it ends.

Usage: python examples/run_examples_torch.py [--device D] [names...]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpu_acir_prover_torch.acir import codec, ir  # noqa: E402
from tpu_acir_prover_torch.utils.circuits import (  # noqa: E402
    ALL_HEAVY, ALL_SMALL, sha256_compression)

PROGRAMS = {**ALL_SMALL, **ALL_HEAVY,
            "sha256_compression": sha256_compression}


def write_example(name: str, workdir: str):
    """The program's artifact and witness files in ``workdir``: their
    paths."""
    prog, wm = PROGRAMS[name]()
    bc = os.path.join(workdir, f"{name}.json")
    wit = os.path.join(workdir, f"{name}.witness.gz")
    codec.save_program_artifact(bc, prog, name=name)
    codec.save_witness_stack(wit, ir.WitnessStack([ir.StackItem(0, wm)]))
    return bc, wit


def run_example(name: str, device: str, workdir: str) -> float:
    """prove, write_vk and verify of one program through the CLI, each in
    a process of its own, each printed with its time; returns the seconds
    they took."""
    bc, wit = write_example(name, workdir)
    proof = os.path.join(workdir, f"{name}.proof")
    vk = os.path.join(workdir, f"{name}.vk")
    env = dict(os.environ, PYTHONPATH=ROOT)

    def cli(*args):
        t0 = time.time()
        r = subprocess.run([sys.executable, "-m", "tpu_acir_prover_torch.cli",
                            *args], env=env, capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"{name}: {' '.join(args)} failed:\n{r.stderr}")
        print(f"    {name} {args[0]}: {time.time() - t0:.1f}s", flush=True)

    t0 = time.time()
    cli("prove", "-b", bc, "-w", wit, "-o", proof, "--test-config",
        "--device", device)
    cli("write_vk", "-b", bc, "-o", vk, "--test-config", "--device", device)
    cli("verify", "-k", vk, "-p", proof)
    return time.time() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the CLI proves on (default: cuda)")
    ap.add_argument("names", nargs="*", default=[])
    args = ap.parse_args()
    names = args.names or sorted(ALL_SMALL)
    with tempfile.TemporaryDirectory() as wd:
        for name in names:
            dt = run_example(name, args.device, wd)
            print(f"  {name:<24s} ok  ({dt:.1f}s)")
    print(f"all {len(names)} examples verified on {args.device}")


if __name__ == "__main__":
    main()
