"""Seconds from the start of the process to the start of the window, less
the harness's own witness files: import, the kernel libraries, the
artifact, and the cold ``prove_file`` (translate, compile, key, first proof
and, on the fused path, the graph's capture) with the warm-up proofs and
``write_vk_file``.  The witness files (the warm-up's and the window's pool)
are the benchmark's inputs, which a user gets from ``nargo execute``
outside the prover; their seconds are printed on standard error beside
the window's summary and counted nowhere."""


def read(run):
    return run.setup_s
