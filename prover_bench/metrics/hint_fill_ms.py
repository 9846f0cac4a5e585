"""The witness fill's python hint segments a proof: the program's
``fill_hint_s`` counter (``circuit/compile.py`` ``generate_witness``, the
hints run between the native core's segments, their ``int()`` conversions
and the scatter of their outputs included); median, ms."""

from ..records import median_ms, window_records


def read(run):
    return median_ms(r["counters"].get("fill_hint_s")
                     for r in window_records(run))
