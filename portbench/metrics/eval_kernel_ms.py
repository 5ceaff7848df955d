"""Device milliseconds of kernel 2 (``csrc/window_eval_pool.cu``) a step,
from the profiler's trace of the traced cycles."""

KERNEL = "window_eval_pool_kernel"


def kernel_time(trace):
    """(seconds, launches) of kernel 2 in ``trace``."""
    secs = sum(s for n, s in trace.op_seconds.items() if KERNEL in n)
    launches = sum(c for n, c in trace.op_counts.items() if KERNEL in n)
    return secs, launches


def read(run):
    if run.trace is None:
        return None
    secs, launches = kernel_time(run.trace)
    if not launches:
        return None
    return 1e3 * secs / launches
