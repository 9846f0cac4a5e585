"""``api``'s compression of a proof: the ``PhaseTimer`` phases
``compress_transcript`` (under ``prove_file`` the query indices that the
prover drew handed to the compressor and held to the proof's shape; a
replay of the Fiat-Shamir transcript only for a caller without them) and
``compress_prune`` (the Merkle paths pruned), summed; median, ms."""

import statistics


def read(run):
    vals = [p.phases["compress_transcript"] + p.phases["compress_prune"]
            for p in run.proofs
            if "compress_transcript" in p.phases and
            "compress_prune" in p.phases]
    return statistics.median(vals) * 1e3 if vals else None
