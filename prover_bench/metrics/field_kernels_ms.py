"""Device time a proof of the ``field`` family's kernels (profiler), ms."""


def read(run):
    fam = run.trace.families.get("field") if run.trace else None
    if not fam or not fam["launches"]:
        return None
    return fam["seconds"] / run.trace.proofs * 1e3
