"""A whole run of the harness at a small size, with the timed path sound,
broken underneath, or replaced by the control: ``correct`` must come out
true only for the sound one.  On the CPU the program takes its plain
versions; the cell's own limits decide."""

import pytest
import torch

from portbench.catalog import Catalog
from portbench.reference import control_frame, judge
from portbench.run import decide, numbers, run_cell

CELL = "million_stars.record"
# The cell's preset at 4,096 bodies; the window engine forced below its
# body-count threshold, small groups and a short list cycle.
SMALL = {"num_bodies": 4096,
         "engine": {"engine": "window", "rebuild_interval": 4,
                    "group_size": 64, "max_depth": 6}}


def small_run(device="cpu"):
    cat = Catalog()
    cfg = dict(cat.config(cat.workload(CELL)["config"]), **SMALL)
    return cat, run_cell(cat, CELL, 2_147_483_659, 0.2, False,
                         torch.device(device), cfg=cfg, out=lambda *a: None)


@pytest.fixture(scope="module")
def sound():
    return small_run()


def test_sound_run_is_correct(sound):
    _, res = sound
    assert res["correct"], res["checks"]
    assert list(res)[-2:] == ["checks", "_run"]


def test_bfloat16_control_is_not_correct(sound):
    cat, res = sound
    run = res["_run"]
    cfg = cat.config(cat.workload(CELL)["config"])
    readings = {
        name: judge(control_frame(fr, run.masses, cfg["G"], cfg["softening"],
                                  15.0, run.sample, "cpu"),
                    run.masses, cfg["G"], cfg["softening"], 15.0,
                    {"check": run.sample}, "cpu")
        for name, fr in run.frames.items()}
    ok, checks = decide(numbers(readings), cat.limits(CELL)["limits"])
    assert not ok
    assert checks["closure_ulp"]["value"] > checks["closure_ulp"]["limit"]
    assert checks["colour_gap"]["value"] > checks["colour_gap"]["limit"]


def _unchanged(monkeypatch):
    from spatialsim_tpu_torch.ops import bh_window
    monkeypatch.setattr(bh_window, "integrate",
                        lambda pos, vel, acc, dt, damping=1.0: (pos, vel))


def _half_batch(monkeypatch):
    from spatialsim_tpu_torch.ops import bh_window
    real = bh_window.eval_accel_sorted

    def half(*a, **k):
        acc = real(*a, **k).clone()
        acc[:, 1::2] = 0.0          # half the bodies left out ...
        acc[:, 0::2] *= 2.0         # ... the rest carry the total
        return acc
    monkeypatch.setattr(bh_window, "eval_accel_sorted", half)


def _colour_altered(monkeypatch):
    from spatialsim_tpu_torch.ops import colors
    real = colors.colors_by_velocity

    def altered(vel, max_speed):
        out = real(vel, max_speed).clone()
        out[1, 1234] += 0.05
        return out
    monkeypatch.setattr(colors, "colors_by_velocity", altered)


def _position_altered(monkeypatch):
    from spatialsim_tpu_torch.models.nbody import NBodySimulation
    real = NBodySimulation.device_frame

    def altered(self):
        pos, vel = real(self)
        pos = pos.clone()
        pos[2, 777] += 0.5
        return pos, vel
    monkeypatch.setattr(NBodySimulation, "device_frame", altered)


@pytest.mark.parametrize("fault, catches", [
    (_unchanged, "closure_ulp"),
    (_half_batch, "force_start_med_pct"),
    (_colour_altered, "colour_gap"),
    (_position_altered, "closure_ulp"),
])
def test_fault_is_not_correct(monkeypatch, fault, catches):
    fault(monkeypatch)
    _, res = small_run()
    assert not res["correct"]
    c = res["checks"][catches]
    assert c["value"] > c["limit"], res["checks"]


@pytest.mark.cuda
def test_small_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, res = small_run("cuda")
    assert res["correct"], res["checks"]
