"""The witness fill's native segments a proof: the program's
``fill_native_s`` counter (``circuit/compile.py`` ``generate_witness``, the
C core's ``run_ops`` between the hint segments); median, ms."""

from ..records import median_ms, window_records


def read(run):
    return median_ms(r["counters"].get("fill_native_s")
                     for r in window_records(run))
