"""The port's ``utils/``: the step timer, ``profile_step`` (no device to
wait for on the CPU) and ``trace`` (a Chrome trace from
``torch.profiler``)."""

import json

import torch

from spatialsim_tpu_torch.utils import StepTimer, profile_step, trace


def test_step_timer_and_profile_step(tmp_path):
    timer = StepTimer(window=4)
    for _ in range(6):
        with timer:
            torch.ones(8).sum()
    assert timer.total_steps == 6 and len(timer.times) == 4
    assert timer.avg >= 0 and timer.eta(10) == timer.avg * 10
    calls = []

    def fn(x):
        calls.append(1)
        return {"out": (x * 2, None)}
    best, out = profile_step(fn, torch.ones(4), iters=3,
                             log_dir=str(tmp_path))
    assert len(calls) == 4 and best >= 0
    assert torch.equal(out["out"][0], torch.full((4,), 2.0))
    assert (tmp_path / "trace.json").exists()


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as path:
        torch.arange(1000.0).cumsum(0)
    events = json.loads(open(path).read())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
