"""The host's witness generation a proof: ``PhaseTimer`` phase
``witness_fill`` (``circuit/compile.py`` ``generate_witness``, the native
core); median, ms."""

from . import median_phase_ms


def read(run):
    return median_phase_ms(run, "witness_fill")
