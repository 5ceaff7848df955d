"""The end-to-end and per-layer arithmetic on synthetic runs."""

import pytest

from portbench.catalog import Catalog
from portbench.kernel2 import OPS_PER_PAIR, step_work, window_pairs
from portbench.peaks import PEAK_FP32_FLOPS, bound_s
from portbench.run import Run, decide
from portbench.trace import TraceSummary

CAT = Catalog()


def read(name, run):
    return CAT.reader(name)(run)


def stalled_run():
    # 99 frames of 10 ms and one of 500 ms: a host stall that idled the
    # card lands in the frame that waited.
    ms = [10.0] * 99 + [500.0]
    return Run(frame_ms=ms, window_s=sum(ms) / 1e3,
               rebuilt=[i % 10 == 9 for i in range(100)],
               capture_ms=[2.0] * 100)


def test_rate_counts_every_frame_and_the_stall():
    run = stalled_run()
    assert read("frames_per_s", run) == pytest.approx(100 / 1.49)


def test_p95_over_all_frames():
    run = stalled_run()
    assert read("frame_ms_p95", run) == pytest.approx(10.0)
    run.frame_ms[-5:] = [500.0] * 5
    # rank 94.05 of 0..99 lies between the 94th (10) and 95th (500).
    assert read("frame_ms_p95", run) == pytest.approx(10 + 490 * 0.05)


def test_rebuild_and_capture_means():
    run = stalled_run()
    assert read("rebuild_frame_ms", run) == pytest.approx(
        (9 * 10.0 + 500.0) / 10)
    assert read("capture_ms", run) == pytest.approx(2.0)
    assert read("rebuild_frame_ms", Run()) is None


def test_kernel2_bound_matches_the_1m_figure():
    # PERF.md, kernel 2: 2.4204e9 live pairs bound at 0.6502 ms by its
    # operations, 18 a pair.
    assert bound_s(OPS_PER_PAIR * 2.4204e9, 0) * 1e3 == pytest.approx(
        0.6502, abs=1e-4)
    assert OPS_PER_PAIR * 2.4204e9 / PEAK_FP32_FLOPS == pytest.approx(
        6.5024e-4, rel=1e-4)
    ng, gsz, wg = 3907, 256, 2
    win = window_pairs(ng, gsz, wg)
    assert win == (ng * (2 * wg + 1) - wg * (wg + 1)) * gsz * gsz
    pairs, nbytes = step_work(ng, gsz, wg, live=1000)
    assert pairs == win + 1000 * gsz
    assert nbytes == 4 * (7 * ng * gsz + 10 * 1000 + 2 * ng)


def test_trace_metrics():
    trace = TraceSummary(
        busy_s=0.75, window_s=1.0, device_ops=[], idle_gaps=[],
        op_seconds={"void window_eval_pool_kernel<2>(...)": 0.004,
                    "elementwise": 0.1},
        op_counts={"void window_eval_pool_kernel<2>(...)": 4,
                   "elementwise": 50})
    run = Run(trace=trace, eval_bound_s=0.002, eval_steps=4)
    assert read("device_idle_pct", run) == pytest.approx(25.0)
    assert read("eval_kernel_ms", run) == pytest.approx(1.0)
    assert read("eval_kernel_roofline", run) == pytest.approx(50.0)
    run.eval_steps = 6        # launches and steps disagree: nothing read
    assert read("eval_kernel_roofline", run) is None
    assert read("device_idle_pct", Run()) is None


def test_decide():
    ok, checks = decide({"a": 1.0, "b": 2.0}, {"a": 1.0, "b": 3.0})
    assert ok and list(checks) == ["a", "b"]
    assert checks["b"] == {"value": 2.0, "limit": 3.0}
    assert not decide({"a": float("nan")}, {"a": 1.0})[0]
    assert not decide({"a": None}, {"a": 1.0})[0]
    assert not decide({"a": 1.5}, {"a": 1.0})[0]
