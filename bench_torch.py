#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port: the counterpart of ``bench.py``.

    python3 bench_torch.py [--device D]

Prints one JSON line per benchmark on stdout, under ``bench.py``'s metric
names, each with a ``device`` key: the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, or ``cpu``.  The last line is the headline.  Progress, phase times
and memory go to stderr.

BENCH_MODE=all (default) runs, in this order:

- ntt: ``prover/ntt.py::ntt`` on 2^BENCH_LOG_N x BENCH_COLS random
  elements (default 2^20 x 6), the minimum over BENCH_REPS (default 4)
  calls, timed with CUDA events on the card, in butterflies/s;
- ecdsa: the 2^17-row ECDSA secp256k1 circuit at ``STANDARD_CONFIG`` on
  the fused prover (the CLI's path), verified before and after; the value
  is the mean over max(1, BENCH_REPS // 2) warm proofs, with their
  minimum and maximum beside it;
- scaling: ``python -m tpu_acir_prover_torch.parallel.scaling`` in a
  process of its own, its JSON line passed on;
- prove (the headline): ``mul_chain_circuit(BENCH_LOG_N)`` at
  ``STANDARD_CONFIG`` through ``prove_fused``, or the per-phase ``prove``
  with BENCH_FUSED=0; the mean over max(1, BENCH_REPS // 2) warm proofs.

BENCH_MODE=ntt|ecdsa|scaling|prove runs one of them.  A failed ecdsa or
scaling benchmark does not stop the headline: its error goes to stderr
and the script exits non-zero at the end.  ``--device`` defaults to
``cuda``; with no card that fails.  The script blocks the imports of JAX
and of the JAX package: the port needs neither.
"""

import sys

# the port and this script must run without JAX and without the JAX package
sys.modules["jax"] = None
sys.modules["tpu_acir_prover"] = None

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

LOG_N = int(os.environ.get("BENCH_LOG_N", "20"))
COLS = int(os.environ.get("BENCH_COLS", "6"))
REPS = int(os.environ.get("BENCH_REPS", "4"))
# all | prove | ntt | ecdsa | scaling
MODE = os.environ.get("BENCH_MODE", "all")
RUST_SINGLE_CORE_BUTTERFLIES_PER_S = 175e6
# single-core Rust plonky2 end-to-end prove estimate at 2^20 rows: ~20 s
RUST_SINGLE_CORE_PROVE_S = 20.0
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class Bench:
    """The benchmarks on one torch device; every line names the device."""

    def __init__(self, device):
        from tpu_acir_prover_torch.prover.prove import resolve_device
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.label = "cpu"
        if self.cuda:
            self.label = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]

    def emit(self, metric, value, unit, vs, **extra):
        print(json.dumps({"metric": metric, "value": value, "unit": unit,
                          "vs_baseline": vs, **extra,
                          "device": self.label}), flush=True)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def peak_reset(self):
        if self.cuda:
            self.sync()
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> str:
        """Peak allocated device memory since ``peak_reset``."""
        if not self.cuda:
            return "not measured on the cpu"
        gib = torch.cuda.max_memory_allocated(self.device) / 2**30
        return f"{gib:.3f} GiB"

    def ntt(self):
        """Goldilocks NTT throughput of the port's plain-torch NTT."""
        from tpu_acir_prover_torch.field import gl
        from tpu_acir_prover_torch.field.gl import P
        from tpu_acir_prover_torch.prover.ntt import ntt
        n = 1 << LOG_N
        vals = np.random.default_rng(0).integers(0, P, size=(n, COLS),
                                                 dtype=np.uint64)
        x = gl.from_u64(vals, self.device)
        ntt(x)   # warm-up
        ts = []
        for _ in range(REPS):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                ntt(x)
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                ntt(x)
                ts.append(time.perf_counter() - t0)
        rate = COLS * (n // 2) * LOG_N / min(ts)
        self.emit(f"goldilocks_ntt_butterflies_per_s_chip (2^{LOG_N} x "
                  f"{COLS})", round(rate, 1), "butterflies/s",
                  round(rate / RUST_SINGLE_CORE_BUTTERFLIES_PER_S, 3),
                  min_s=min(ts))

    def ecdsa(self):
        """The flagship circuit on the fused prover, the CLI's path."""
        from tpu_acir_prover_torch.acir.translator import translate_program
        from tpu_acir_prover_torch.circuit.compile import compile_circuit
        from tpu_acir_prover_torch.prover.config import STANDARD_CONFIG
        from tpu_acir_prover_torch.prover.fused import prove_fused
        from tpu_acir_prover_torch.prover.prove import ProvingKey
        from tpu_acir_prover_torch.prover.verify import verify
        from tpu_acir_prover_torch.utils import circuits

        prog, wm = circuits.ecdsa_secp256k1()
        t0 = time.perf_counter()
        tr = translate_program(prog)
        cc = compile_circuit(tr.builder)
        log(f"  ecdsa translate+compile: {time.perf_counter() - t0:.2f}s "
            f"({cc.n} rows)")
        t0 = time.perf_counter()
        pk = ProvingKey(cc, STANDARD_CONFIG, device=self.device)
        self.sync()
        log(f"  ecdsa pk_build: {time.perf_counter() - t0:.2f}s")
        ext = tr.external_values(wm)
        t0 = time.perf_counter()
        proof = prove_fused(pk, ext)
        log(f"  ecdsa warmup_prove (eager run, capture, instantiate, "
            f"replay): {time.perf_counter() - t0:.2f}s")
        verify(pk.vk, proof)
        ts = []
        for _ in range(max(1, REPS // 2)):
            t0 = time.perf_counter()
            proof = prove_fused(pk, ext)
            ts.append(time.perf_counter() - t0)
        verify(pk.vk, proof)
        # vs_baseline: the Rust yardstick is a 2^20-row proof, not 2^17
        self.emit(f"ecdsa_prover_wall_time_2pow{cc.log_n}_rows",
                  round(sum(ts) / len(ts), 3), "s", None, min_s=min(ts),
                  max_s=max(ts))

    def scaling(self):
        """The weak-scaling sweep, in a process of its own."""
        out = subprocess.run(
            [sys.executable, "-m", "tpu_acir_prover_torch.parallel.scaling",
             "--device", str(self.device)], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
            text=True, timeout=1800)
        sys.stderr.write(out.stderr[-2000:])
        lines = [json.loads(line) for line in out.stdout.splitlines()
                 if line.startswith("{")]
        if out.returncode != 0 or not lines:
            raise RuntimeError(f"scaling sweep failed rc={out.returncode}")
        for rec in lines:
            self.emit(rec["metric"], rec["value"], rec["unit"],
                      rec["vs_baseline"])

    def prove(self):
        """The headline: the prover's wall time at 2^LOG_N rows."""
        from tpu_acir_prover_torch.prover.config import STANDARD_CONFIG
        from tpu_acir_prover_torch.prover.fused import prove_fused
        from tpu_acir_prover_torch.prover.prove import ProvingKey, prove
        from tpu_acir_prover_torch.utils.bench_circuits import \
            mul_chain_circuit
        from tpu_acir_prover_torch.utils.timing import PhaseTimer

        fused = os.environ.get("BENCH_FUSED", "1") != "0"
        do_prove = prove_fused if fused else prove
        cc = mul_chain_circuit(LOG_N)
        self.peak_reset()
        t0 = time.perf_counter()
        pk = ProvingKey(cc, STANDARD_CONFIG, device=self.device)
        self.sync()
        log(f"  pk_build: {time.perf_counter() - t0:.2f}s, peak allocated "
            f"{self.peak()}")
        ext = np.array([], dtype=np.uint64)
        self.peak_reset()
        t0 = time.perf_counter()
        do_prove(pk, ext)
        log(f"  warmup_prove ({'fused: eager run, capture, instantiate, '
            'replay' if fused else 'per-phase'}): "
            f"{time.perf_counter() - t0:.2f}s, peak allocated "
            f"{self.peak()}")
        cap = pk._captured
        if cap is not None:
            log(f"  graph: capture {cap.capture_s:.3f}s, instantiate "
                f"{cap.instantiate_s:.3f}s, pool "
                f"{cap.pool_bytes / 2**30:.3f} GiB, kernel launches a "
                f"replay {cap.launches}")
        reps = max(1, REPS // 2)
        self.peak_reset()
        t0 = time.perf_counter()
        for _ in range(reps):
            timer = PhaseTimer(enabled=True)
            do_prove(pk, ext, timer=timer)
        dt = (time.perf_counter() - t0) / reps
        timer.report()  # phase breakdown of the last rep
        log(f"  warm proofs: peak allocated {self.peak()}")
        # the Rust yardstick is a 2^20-row proof
        self.emit(f"prover_wall_time_2pow{LOG_N}_rows", round(dt, 3), "s",
                  round(RUST_SINGLE_CORE_PROVE_S / dt, 2) if LOG_N == 20
                  else None, prover="fused" if fused else "per-phase")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_torch.py")
    ap.add_argument("--device", default="cuda",
                    help="torch device to benchmark (default: cuda)")
    args = ap.parse_args(argv)
    if MODE not in ("all", "ntt", "ecdsa", "scaling", "prove"):
        raise SystemExit(f"bench_torch: unknown BENCH_MODE {MODE!r}")
    bench = Bench(args.device)
    if MODE != "all":
        getattr(bench, MODE)()
        return 0
    bench.ntt()
    failed = []
    for name in ("ecdsa", "scaling"):
        try:
            getattr(bench, name)()
        except Exception:  # the headline still runs; the exit code tells
            log(f"  {name} bench failed:\n{traceback.format_exc()}")
            failed.append(name)
    bench.prove()
    if failed:
        log(f"  failed: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
