"""The share of the traced window in which no kernel, copy or fill ran on
the card (profiler), in %."""


def read(run):
    if not run.trace or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
