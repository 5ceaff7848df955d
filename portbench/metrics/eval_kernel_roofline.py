"""Kernel 2's share of its roofline, percent: the least time the card
could take for the traced steps' work (``portbench/kernel2.py``: 18 FP32
operations a live pair over 67 TFLOP/s, or the bytes over 3.35 TB/s,
whichever is longer, step by step on the lists each step evaluated) over
the kernel's device time in the trace.  Nothing to read where the trace
holds another number of launches than the steps counted."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_metric_eval_kernel_ms",
    Path(__file__).with_name("eval_kernel_ms.py"))
_ms = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ms)


def read(run):
    if run.trace is None or not run.eval_bound_s:
        return None
    secs, launches = _ms.kernel_time(run.trace)
    if launches != run.eval_steps or secs <= 0:
        return None
    return 100.0 * run.eval_bound_s / secs
