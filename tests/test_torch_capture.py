"""The frame capture's dispatch (``ops/capture.py``, ``ops/colors.py``) on
the CPU: the plain versions run and are counted, ``device_frame`` and the
getters give the values they gave before the capture kernels, and the
kernels' wrappers refuse a bad input before any launch.  The kernels
themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py -k capture``).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spatialsim_tpu_torch.config.nbody import NBodyConfig
from spatialsim_tpu_torch.models.nbody import NBodySimulation
from spatialsim_tpu_torch.ops import capture, colors
from spatialsim_tpu_torch.tools import capture_bench
from spatialsim_tpu_torch.utils import profiling

WINDOW = NBodyConfig(num_bodies=3000, engine="window", group_size=64,
                     max_depth=6, list_capacity=512, rebuild_interval=2)


@pytest.fixture(autouse=True)
def _clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def _launches():
    return (capture.capture_original.launches,
            capture.capture_colors.launches)


def _counted(fn):
    """``fn()`` under the profiler, and the counters it left."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.counter_totals()


@pytest.fixture(scope="module")
def window_sim():
    """A window simulation after a rebuild (its state re-sorted)."""
    sim = NBodySimulation(config=WINDOW, seed=4, device="cpu")
    for _ in range(3):
        sim.step_raw(0.02)
    assert sim.rebuilds == 1
    return sim


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_and_float64_take_the_plain_versions(dtype):
    rng = np.random.default_rng(0)
    vel = torch.as_tensor(rng.standard_normal((3, 500)) * 8, dtype=dtype)
    inv = torch.as_tensor(rng.permutation(500).astype(np.int32))
    before = _launches()
    (col, rows), counts = _counted(lambda: (
        colors.colors_by_velocity(vel, 15.0),
        capture.original_order(inv, vel, vel * 2)))
    assert counts == {"capture.plain_calls": 2}
    assert _launches() == before
    assert torch.equal(col, colors.colors_by_velocity_reference(vel, 15.0))
    assert col.dtype == torch.float32 and col.is_contiguous()
    want = (vel[:, inv.long()], (vel * 2)[:, inv.long()])
    assert len(rows) == 2
    for got, w in zip(rows, want):
        assert torch.equal(got, w) and got.is_contiguous()


def test_counters_record_only_under_the_profiler():
    vel = torch.ones(3, 10)
    colors.colors_by_velocity(vel, 15.0)
    capture.original_order(torch.arange(10, dtype=torch.int32), vel, vel)
    assert profiling.counter_totals() == {}


def test_window_frame_and_getters_keep_their_values(window_sim):
    """``device_frame`` and the getters are the state gathered by
    ``inv_order``, the colours the plain gradient on those velocities:
    what they gave before, bit for bit; each capture call counts once."""
    sim = window_sim
    inv = sim.state.lists.inv_order.long()
    want_p, want_v = sim.state.pos[:, inv], sim.state.vel[:, inv]
    (pos_o, vel_o), counts = _counted(sim.device_frame)
    assert counts == {"capture.plain_calls": 1}
    assert torch.equal(pos_o, want_p) and torch.equal(vel_o, want_v)
    sim._color_cache = None
    (p, v, c), counts = _counted(lambda: (
        sim.get_positions(), sim.get_velocities(), sim.get_colors()))
    assert counts == {"capture.plain_calls": 4}
    np.testing.assert_array_equal(p, want_p.numpy().T)
    np.testing.assert_array_equal(v, want_v.numpy().T)
    np.testing.assert_array_equal(
        c, colors.colors_by_velocity_reference(
            want_v, sim.config.max_speed_color).numpy().T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_inputs_off_the_cpu_never_take_the_plain_versions(dtype):
    """Off the CPU the dispatch hands every input to the kernels' wrappers,
    which refuse what they cannot run (here a tensor on the ``meta``
    device, or float64) before any launch: nothing falls back to the plain
    versions there."""
    vel = torch.zeros(3, 16, dtype=dtype, device="meta")
    inv = torch.zeros(16, dtype=torch.int32, device="meta")
    before = _launches()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            colors.colors_by_velocity(vel, 15.0)
        with pytest.raises(ValueError):
            capture.original_order(inv, vel, vel)
    assert profiling.counter_totals() == {"capture.kernel_calls": 2}
    assert _launches() == before


def test_allpairs_frame_is_the_state_itself():
    sim = NBodySimulation(config=NBodyConfig(num_bodies=512), seed=1,
                          device="cpu")
    assert sim.engine == "allpairs"
    (pos_o, vel_o), counts = _counted(sim.device_frame)
    assert pos_o is sim.state.pos and vel_o is sim.state.vel
    assert counts == {"capture.plain_calls": 1}


def test_host_read_of_a_rows_view_keeps_its_values():
    """The getters' ``.cpu().numpy().T`` on a ``(3, n)`` view of ``(n, 3)``
    rows (the capture kernels' result) gives the rows themselves."""
    rows = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (1000, 3)).astype(np.float32))
    host = rows.T.cpu().numpy().T
    np.testing.assert_array_equal(host, rows.numpy())
    assert host.flags["C_CONTIGUOUS"]


_F32 = dict(dtype=torch.float32)


@pytest.mark.parametrize("call, match", [
    (lambda: capture.capture_colors(torch.zeros(3, 8, dtype=torch.float64),
                                    15.0), "float32"),
    (lambda: capture.capture_colors(torch.zeros(4, 8, **_F32), 15.0),
     r"\(3, n\)"),
    (lambda: capture.capture_colors(torch.zeros(24, **_F32), 15.0),
     r"\(3, n\)"),
    (lambda: capture.capture_colors(torch.zeros(3, 8, **_F32), 15.0),
     "devices"),
    (lambda: capture.capture_original(torch.zeros(8, dtype=torch.int32),
                                      torch.zeros(3, 8, dtype=torch.float64),
                                      torch.zeros(3, 8, dtype=torch.float64)),
     "float32"),
    (lambda: capture.capture_original(torch.zeros(8, dtype=torch.int32),
                                      torch.zeros(3, 8, **_F32),
                                      torch.zeros(3, 8, dtype=torch.float64)),
     "float32"),
    (lambda: capture.capture_original(torch.zeros(8, dtype=torch.int32),
                                      torch.zeros(3, 8, **_F32),
                                      torch.zeros(3, 9, **_F32)),
     r"\(3, 8\)"),
    (lambda: capture.capture_original(torch.zeros(8, dtype=torch.int32),
                                      torch.zeros(8, 3, **_F32).T,
                                      torch.zeros(3, 8, **_F32)),
     "contiguous"),
    (lambda: capture.capture_original(torch.zeros(8, dtype=torch.int64),
                                      torch.zeros(3, 8, **_F32),
                                      torch.zeros(3, 8, **_F32)),
     "int32"),
    (lambda: capture.capture_original(torch.zeros(9, dtype=torch.int32),
                                      torch.zeros(3, 8, **_F32),
                                      torch.zeros(3, 8, **_F32)),
     "int32"),
    (lambda: capture.capture_original(torch.zeros(8, dtype=torch.int32),
                                      torch.zeros(3, 8, **_F32),
                                      torch.zeros(3, 8, **_F32)),
     "devices"),
])
def test_wrappers_refuse_bad_input_before_any_launch(call, match):
    before = _launches()
    with pytest.raises(ValueError, match=match):
        call()
    assert _launches() == before


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 1000, 12_345])
def test_bench_row_sectors_count_every_row(n):
    """``capture_bench``'s bound counts the 32 B sectors each 12 B row
    covers, row by row."""
    i = np.arange(n)
    assert capture_bench.row_sectors(n) == int(
        ((12 * i + 11) // 32 - 12 * i // 32 + 1).sum())
    assert capture_bench.original_bytes(n) == 4 * n + 2 * (
        12 * n + 32 * capture_bench.row_sectors(n))


def test_bench_runs_its_plain_lines_on_the_cpu():
    lines = []
    res = capture_bench.run(2000, reps=3, device="cpu", out=lines.append)
    assert set(res) == {"plain", "capture plain"}
    assert all(q[0] <= q[1] <= q[2] for q in res.values())
    assert lines[-1].endswith("not measured (no card)")
