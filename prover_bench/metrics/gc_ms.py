"""The collector's pauses a proof: the program's ``gc_pause_s`` counter
(``gc.callbacks``, stop less start of each collection while ``prove_file``
runs) summed over the window's proofs, over their count, ms.  A mean, not
a median: the rare full passes are what it is for."""

from ..records import window_records


def read(run):
    recs = window_records(run)
    if not recs:
        return None
    return sum(r["counters"]["gc_pause_s"] for r in recs) / len(recs) * 1e3
