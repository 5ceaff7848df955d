"""The window engine's spans and counters (``utils/profiling.py`` ``span`` /
``count``, opened in ``ops/bh_window.py``) and the benchmark's readers of
them (``portbench/metrics/rebuild.*.py``), on the CPU at 4,096 bodies.

They record only while ``torch.profiler`` records; there each span is a
CPU event on the profiler's timeline, nested in its parent's interval, and
tracing changes no bit of the state.  The card's side (no span on the
device's timeline, ``bh.sync`` against ``torch.cuda.set_sync_debug_mode``)
is in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from spatialsim_tpu_torch.config.nbody import NBodyConfig
from spatialsim_tpu_torch.models.nbody import NBodySimulation
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.extreme_run import folded_groups
from spatialsim_tpu_torch.utils import profiling

N = 4096
STEPS = 5                 # rebuilds at steps 3 and 5
SPANS = ("bh.rebuild", "bh.rebuild.sort", "bh.rebuild.octree",
         "bh.rebuild.traverse", "bh.rebuild.finish", "bh.rebuild.resort",
         "bh.eval", "bh.sync")
CFG = NBodyConfig(num_bodies=N, engine="window", group_size=128,
                  max_depth=7, list_capacity=512, window_groups=2,
                  rebuild_interval=2, pool_tile=128)
READERS = ("rebuild.host_ms", "rebuild.traverse_ms", "rebuild.sync_wait_ms",
           "rebuild.host_syncs", "rebuild.folded_entries",
           "rebuild.groups_folded")


@pytest.fixture(autouse=True)
def _clean_registry():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    # Several test workers share the machine's cores.
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _sim():
    return NBodySimulation(config=CFG, seed=3, device="cpu")


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


@pytest.fixture(scope="module")
def plain():
    """STEPS steps outside a profiler, and what the registry held then."""
    profiling.reset()
    sim = _sim()
    for _ in range(STEPS):
        sim.step_raw(0.02)
    profiling.count("bh.folded_entries", 5)
    return sim, profiling.span_totals(), profiling.counter_totals()


@pytest.fixture(scope="module")
def traced():
    """The same steps under ``torch.profiler``: (simulation, events, span
    totals, counter totals)."""
    profiling.reset()
    sim = _sim()
    events = _traced(lambda: [sim.step_raw(0.02) for _ in range(STEPS)])
    return sim, events, profiling.span_totals(), profiling.counter_totals()


def test_nothing_recorded_outside_a_profiler(plain):
    sim, spans, counters = plain
    assert profiling.span("bh.eval") is profiling.span("bh.rebuild")
    assert sim.rebuilds == 2
    assert spans == {} and counters == {}


def test_spans_are_nested_cpu_ranges_and_count_the_steps(traced):
    sim, events, totals, _ = traced
    assert sim.rebuilds == 2
    ranges = {}
    for e in events:
        if e.name.startswith("bh."):
            assert e.device_type == DeviceType.CPU, e.name
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    assert set(ranges) == set(SPANS)
    for name in SPANS[1:6]:
        for a, b in ranges[name]:
            assert any(a0 <= a and b <= b0
                       for a0, b0 in ranges["bh.rebuild"]), name
    assert totals["bh.rebuild"][0] == sim.rebuilds
    assert totals["bh.eval"][0] == STEPS
    for name in SPANS:
        entries, seconds = totals[name]
        assert entries == len(ranges[name]) and seconds > 0, name
    assert totals["bh.rebuild"][1] > totals["bh.rebuild.traverse"][1]


def test_tracing_changes_no_bit_of_the_state(plain, traced):
    a, b = plain[0], traced[0]
    for name in ("pos", "vel", "mass", "acc"):
        assert torch.equal(getattr(a.state, name),
                           getattr(b.state, name)), name
    assert torch.equal(a.state.lists.pool, b.state.lists.pool)


def _galaxy_build(plain, **kw):
    sim = plain[0]
    pos, vel, mass = bw.state_original_order(sim.state)
    args = dict(bw._build_kw(sim.config), **kw)
    lists = []
    _traced(lambda: lists.append(bw.build_lists(pos, vel, mass, **args)))
    return lists[0], profiling.counter_totals()


@pytest.mark.parametrize("cap,folds", [(16, True), (4096, False)])
def test_list_cap_folds_are_counted(plain, cap, folds):
    _, counts = _galaxy_build(plain, list_cap=cap, pool_cap=0)
    assert (counts.get("bh.folded_entries", 0) > 0) == folds
    assert counts["bh.groups_folded"] == 0


def test_pool_capacity_folds_count_the_folded_groups(plain):
    """A pool of 16 tiles of 512 over 8 groups (decide13's cap in the
    sweep tools' test) folds whole groups; the counter equals the groups
    left with far_n <= 1."""
    lists, counts = _galaxy_build(plain, group_size=512, pool_tile=512,
                                  list_cap=2048, pool_cap=16)
    folded = folded_groups(lists.far_n.numpy())
    assert counts["bh.groups_folded"] == folded > 0


# ---------------------------------------------------------------------------
# The benchmark's readers, on a registry filled by hand
# ---------------------------------------------------------------------------

def _read(name, spans, counters, monkeypatch):
    from portbench.catalog import Catalog
    monkeypatch.setattr(profiling, "span_totals", lambda: dict(spans))
    monkeypatch.setattr(profiling, "counter_totals", lambda: dict(counters))
    return Catalog().reader(name)(None)


def test_readers_divide_by_the_rebuilds(monkeypatch):
    spans = {"bh.rebuild": (4, 0.2), "bh.rebuild.traverse": (4, 0.12),
             "bh.sync": (60, 0.008), "bh.eval": (96, 0.01)}
    counters = {"bh.folded_entries": 10, "bh.groups_folded": 2}
    want = {"rebuild.host_ms": 50.0, "rebuild.traverse_ms": 30.0,
            "rebuild.sync_wait_ms": 2.0, "rebuild.host_syncs": 15.0,
            "rebuild.folded_entries": 2.5, "rebuild.groups_folded": 0.5}
    for name in READERS:
        assert _read(name, spans, counters, monkeypatch) == pytest.approx(
            want[name]), name
    # Counters never bumped read 0 where rebuilds were recorded.
    assert _read("rebuild.groups_folded", spans, {}, monkeypatch) == 0


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_a_rebuild(name, monkeypatch):
    assert _read(name, {"bh.eval": (8, 0.01)}, {"bh.groups_folded": 1},
                 monkeypatch) is None
    # A program without the registry (the benchmark laid over an older
    # checkout): nothing to read, nothing raised.
    monkeypatch.delattr(profiling, "span_totals")
    from portbench.catalog import Catalog
    assert Catalog().reader(name)(None) is None


def test_readers_on_a_traced_simulation(traced, monkeypatch):
    _, _, totals, counters = traced
    got = {name: _read(name, totals, counters, monkeypatch)
           for name in READERS}
    assert got["rebuild.host_ms"] == pytest.approx(
        1e3 * totals["bh.rebuild"][1] / 2)
    assert got["rebuild.host_syncs"] == totals["bh.sync"][0] / 2 > 0
    assert 0 < got["rebuild.traverse_ms"] < got["rebuild.host_ms"]
    assert got["rebuild.groups_folded"] == 0
    assert np.isfinite(list(got.values())).all()
