"""The ``api`` layer's own time a proof (witness file read, dispatch,
compression, serialization, the file written): the host clock around
``prove_file`` less the total of its ``PhaseTimer``; median, ms."""

import statistics


def read(run):
    vals = [p.latency_s - sum(p.phases.values()) for p in run.proofs]
    return statistics.median(vals) * 1e3 if vals else None
