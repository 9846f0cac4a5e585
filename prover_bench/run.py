"""Runs one cell of the benchmark once and prints its result line.

    python3 prover_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--control]

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and ``tpu_acir_prover_torch``.  Needs as many CUDA devices as the cell asks
for, and exits 1 without a result where there are fewer.  ``--trace 1``
reports the cell's per-layer metrics from a profiled window, ``--trace 0``
its end-to-end metrics.  ``--control`` proves with one bit of proof of
work fewer than the configuration states, the control that ``correct``
has to reject; no run of the benchmark passes it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches():
    """Every kernel cache at a fixed path inside the checkout (the port's
    own nvcc builds go to ``tpu_acir_prover_torch/_build``)."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="prover_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    from prover_bench import harness
    line = harness.run(ROOT, args.workload, args.seed, args.seconds,
                       bool(args.trace), control=args.control,
                       t_start=T_START)
    harness.report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
