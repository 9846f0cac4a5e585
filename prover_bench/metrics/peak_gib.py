"""``torch.cuda.max_memory_reserved()`` over set-up and window, in GiB: the
card memory the circuit's key, the graph's pool and the proofs hold."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
