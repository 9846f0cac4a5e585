"""The host time of a proof that no ``PhaseTimer`` span holds: the host
clock around ``prove_file`` less the total of its spans (which cover the
witness file's read, the fill, the prover, the compression, the
serialization and the write), so the spans' own entry and exit and any
work that slips out of every span; median, ms."""

import statistics


def read(run):
    vals = [p.latency_s - sum(p.phases.values()) for p in run.proofs]
    return statistics.median(vals) * 1e3 if vals else None
