"""The 90th percentile of the window's proof latencies, each from
``prove_file`` called to the proof file written (host clock; nearest
rank)."""

import math


def read(run):
    lat = sorted(p.latency_s for p in run.proofs)
    return lat[math.ceil(0.9 * len(lat)) - 1] if lat else None
