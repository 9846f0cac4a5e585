"""CLI: ``python -m tpu_acir_prover_torch.cli {prove,write_vk,verify}``.

The flags of ``tpu_acir_prover.cli``, with ``--device`` (default ``cuda``)
in place of ``--backend``:

  prove    -b <bytecode.json> -w <witness.gz> -o <proof_out> [--device D]
  write_vk -b <bytecode.json> -o <vk_out> [--device D]
  verify   -k <vk> -p <proof>

verify prints nothing and exits 0 on success; any failure, a missing CUDA
device included, exits 1 with the reason on stderr.  With
``TPU_ACIR_TIMING=1``, prove prints the proof's spans and counters on
stderr (``utils/timing.py``).
"""

from __future__ import annotations

import argparse
import sys

from . import api
from .prover.config import STANDARD_CONFIG, TEST_CONFIG
from .utils.timing import env_timer


def _config(args):
    return TEST_CONFIG if args.test_config else STANDARD_CONFIG


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_acir_prover_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("prove", help="generate a proof for an ACIR program")
    pp.add_argument("-b", "--bytecode_path", required=True)
    pp.add_argument("-w", "--witness_path", required=True)
    pp.add_argument("-o", "--proof_path", required=True)

    pv = sub.add_parser("write_vk", help="write the verifying key")
    pv.add_argument("-b", "--bytecode_path", required=True)
    pv.add_argument("-o", "--vk_path", required=True)

    for sp in (pp, pv):
        sp.add_argument("--device", default="cuda",
                        help="torch device to prove on (default: cuda)")
        sp.add_argument("--test-config", action="store_true",
                        help="small FRI parameters (testing only, not sound)")

    pk = sub.add_parser("verify", help="verify a proof against a vk")
    pk.add_argument("-k", "--vk_path", required=True)
    pk.add_argument("-p", "--proof_path", required=True)

    args = p.parse_args(argv)
    try:
        if args.cmd == "prove":
            timer = env_timer()
            api.prove_file(args.bytecode_path, args.witness_path,
                           args.proof_path, _config(args), args.device,
                           timer=timer)
            if timer.enabled:
                timer.report()
                timer.report_counters()
        elif args.cmd == "write_vk":
            api.write_vk_file(args.bytecode_path, args.vk_path,
                              _config(args), args.device)
        else:
            api.verify_file(args.vk_path, args.proof_path)
    except Exception as e:  # any failure -> nonzero exit, reason on stderr
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
