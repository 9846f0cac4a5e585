"""The per-phase prover's quotient a proof: ``PhaseTimer`` phase
``quotient``, which ends in a cap copy and so holds its device work;
median, ms.  Per-phase cells only."""

from . import median_phase_ms


def read(run):
    return median_phase_ms(run, "quotient")
