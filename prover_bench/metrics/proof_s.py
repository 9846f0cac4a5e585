"""Seconds of the window over the proofs completed in it (host clock): what
a user of a warm prover waits per proof."""


def read(run):
    return run.window_s / len(run.proofs) if run.proofs else None
