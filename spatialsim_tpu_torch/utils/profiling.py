"""Profiling and step instrumentation (port of
``spatialsim_tpu/utils/profiling.py``).

Cheap host counters (a moving-average step timer with ETA, the FPS HUD's
kind of number), plus device traces through ``torch.profiler``, exported
as a Chrome trace that Perfetto or ``chrome://tracing`` opens.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import deque
from typing import Optional


class StepTimer:
    """Moving-average step timer with ETA (reference's 10-frame ring)."""

    def __init__(self, window: int = 10):
        self.times = deque(maxlen=window)
        self.total_steps = 0
        self.started = time.time()
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.times.append(time.time() - self._t0)
        self.total_steps += 1

    @property
    def avg(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.avg if self.avg else 0.0

    def eta(self, remaining_steps: int) -> float:
        return self.avg * remaining_steps

    def elapsed(self) -> float:
        return time.time() - self.started


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a trace: ``with trace() as path: sim.update(dt)``.

    ``torch.profiler`` records the host's operators and, when a card is
    present, its kernels; on exit the trace is written to
    ``log_dir/trace.json`` (``log_dir`` defaults to ``spatialsim_trace``
    under the temporary directory), the path the context yields.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "spatialsim_trace")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def profile_step(fn, *args, iters: int = 3, log_dir: Optional[str] = None):
    """Time a step: the best of ``iters`` calls after a warm-up, each ended
    by a synchronise with the device of the output's first tensor (wrappers
    and PyTorch return before a card finishes; nothing to wait for on the
    CPU).  With ``log_dir`` the timed calls are also traced
    (:func:`trace`).  Returns ``(seconds, output)``."""
    import torch

    def sync(value):
        leaf = _first_tensor(value)
        if leaf is not None and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)

    out = fn(*args)
    sync(out)
    times = []
    ctx = trace(log_dir) if log_dir else contextlib.nullcontext()
    with ctx:
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(*args)
            sync(out)
            times.append(time.perf_counter() - t0)
    return min(times), out


def _first_tensor(value):
    """The first tensor of a tensor, a (named) tuple or list of them, or a
    dict's values; None when there is none."""
    import torch
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        for v in value:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None
