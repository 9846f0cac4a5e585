"""One reader a metric, found by the metric's name in ``BENCHMARK.json``:
``read(run) -> float | None`` takes the number from a finished run
(``harness.Run``: the window's proofs with their phases, the set-up time,
the memory peak, and in a traced run the trace's ``Summary``).  A reader
that finds nothing to read returns None, and the harness leaves the metric
out of the result.
"""

import importlib
import statistics


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def median_phase_ms(run, phase: str):
    """Median over the window's proofs of a ``PhaseTimer`` phase, in ms;
    None where no proof has the phase."""
    vals = [p.phases[phase] for p in run.proofs if phase in p.phases]
    return statistics.median(vals) * 1e3 if vals else None
