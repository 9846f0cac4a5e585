"""The fused graph's replay on the card: the program's
``replay_device_s`` counter, two CUDA events around
``CapturedProof.run``'s replay; median, ms.  Fused cells only."""

from ..records import median_ms, window_records


def read(run):
    return median_ms(r["counters"].get("replay_device_s")
                     for r in window_records(run))
