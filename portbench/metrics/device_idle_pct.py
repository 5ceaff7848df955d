"""Share of the traced cycles' wall time in which no kernel, copy or set
ran on the card (the profiler's device timeline), percent."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
