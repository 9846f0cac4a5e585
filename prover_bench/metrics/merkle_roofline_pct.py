"""The least time the card needs for a proof's Poseidon2 hashing
(``roofline.merkle_work``: every leaf and tree level a proof commits to,
from the verifying key's widths and the proof parameters) over the device
time of the ``merkle`` family's kernels a proof, in %."""

from .. import roofline


def read(run):
    fam = run.trace.families.get("merkle") if run.trace else None
    if not fam or not fam["seconds"]:
        return None
    least = roofline.least_s(roofline.merkle_work(run.vk)) * run.trace.proofs
    return 100.0 * least / fam["seconds"]
