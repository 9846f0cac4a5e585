"""The program's own records of its proofs, for the counter readers.

``tpu_acir_prover_torch.utils.timing.finished()`` holds one record a
``prove_file`` call made with an enabled timer: the call's start and end on
``time.perf_counter()`` (the clock of ``harness.Proof.start``/``end``), its
spans and its counters.  A checkout of the program without that log gives
no records, and its readers then return None.
"""

from __future__ import annotations

import bisect
import statistics
from typing import List


def window_records(run) -> List[dict]:
    """The records whose [start, end] lies inside a window proof's."""
    try:
        from tpu_acir_prover_torch.utils import timing
    except ImportError:
        return []
    finished = getattr(timing, "finished", None)
    if finished is None:
        return []
    spans = sorted((p.start, p.end) for p in run.proofs)
    starts = [s for s, _ in spans]
    out = []
    for rec in list(finished()):
        i = bisect.bisect_right(starts, rec["start"]) - 1
        if i >= 0 and rec["end"] <= spans[i][1]:
            out.append(rec)
    return out


def median_ms(values):
    """Median of seconds, in ms; None where there are none."""
    values = [v for v in values if v is not None]
    return statistics.median(values) * 1e3 if values else None
