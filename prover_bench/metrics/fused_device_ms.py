"""The fused graph a proof: ``PhaseTimer`` phase ``fused_device`` (inputs
in, the replay, outputs out, the host's wait); median, ms.  Fused cells
only."""

from . import median_phase_ms


def read(run):
    return median_phase_ms(run, "fused_device")
