"""The per-phase prover's quotient on the card: the program's
``phase_device_s["quotient"]`` counter, two CUDA events at the ends of the
phase (the card's time between them, its waits for the host's launches
included); median, ms.  Per-phase cells only."""

from ..records import median_ms, window_records


def read(run):
    return median_ms(r["counters"].get("phase_device_s", {}).get("quotient")
                     for r in window_records(run))
