"""Seconds from the start of the process to the start of the window:
import, the kernel libraries, the inputs, and the cold ``prove_file``
(translate, compile, key, first proof and, on the fused path, the graph's
capture) with the warm-up proofs."""


def read(run):
    return run.setup_s
