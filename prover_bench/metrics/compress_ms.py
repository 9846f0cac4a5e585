"""``api``'s compression of a proof: the ``PhaseTimer`` phases
``compress_transcript`` (the Fiat-Shamir transcript replayed on the host
for the query indices) and ``compress_prune`` (the Merkle paths pruned),
summed; median, ms."""

import statistics


def read(run):
    vals = [p.phases["compress_transcript"] + p.phases["compress_prune"]
            for p in run.proofs
            if "compress_transcript" in p.phases and
            "compress_prune" in p.phases]
    return statistics.median(vals) * 1e3 if vals else None
