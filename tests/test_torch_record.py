"""The port's recorder on the CPU: frame i is written while frame i+1
computes (``tools/record.py`` ``FrameOverlap``, the JAX recorder's
``flush_pending``), the frames are the simulation's own, and a
``KeyboardInterrupt`` at any frame leaves a session that resumes to the
same frames.
"""

import numpy as np
import pytest

from spatialsim_tpu_torch.io import codec, session
from spatialsim_tpu_torch.models.nbody import NBodySimulation
from spatialsim_tpu_torch.ops.colors import colors_by_velocity
from spatialsim_tpu_torch.presets import get_preset_config
from spatialsim_tpu_torch.tools import record

N, FRAMES = 1500, 6
# The codec's int16 deltas quantise to 1/1000 (half of it a frame, and a
# frame's error does not carry into the next: deltas are taken from the
# decoded previous frame).
ATOL = 6e-4


def _config(name):
    cfg = get_preset_config("tiny_galaxy")
    cfg.update(num_bodies=N, total_frames=FRAMES, session_name=name)
    return cfg


def _own_frames(cfg):
    """The simulation's frames, stepped and read without the recorder."""
    sim = NBodySimulation(config=record.config_from_preset(cfg),
                          substeps=int(cfg["substeps"]), seed=0, device="cpu")
    dt = float(cfg["dt_per_frame"]) / int(cfg["substeps"])
    out = []
    for _ in range(FRAMES):
        sim.step_raw(dt)
        pos, vel = sim.device_frame()
        out.append((pos.T.numpy().copy(), colors_by_velocity(
            vel, record.RECORD_MAX_SPEED_COLOR).T.numpy().copy()))
    return out


def _decoded(rec_dir, n):
    prev, out = (None, None), []
    for k in range(n):
        prev = codec.load_frame(rec_dir, k, *prev)
        out.append(prev)
    return out


def test_recorded_frames_are_the_simulations_own(tmp_path, monkeypatch):
    monkeypatch.setenv("SPATIALSIM_RECORDINGS", str(tmp_path))
    cfg = _config("own")
    written = []
    save = record.save_frame

    def spy(rec_dir, frame, pos, col):
        written.append((frame, record_state["stepped"]))
        save(rec_dir, frame, pos, col)

    # Frame i is written after frame i+1's step was queued.
    record_state = {"stepped": -1}
    step = NBodySimulation.step_raw

    def counted(self, dt):
        step(self, dt)
        record_state["stepped"] += 1

    monkeypatch.setattr(record, "save_frame", spy)
    monkeypatch.setattr(NBodySimulation, "step_raw", counted)
    record.record(dict(cfg), device="cpu")
    rec_dir = tmp_path / "own"
    assert session.get_completed_frames(rec_dir) == FRAMES
    assert written == [(k, k + 1) for k in range(FRAMES - 1)] + [
        (FRAMES - 1, FRAMES - 1)]
    monkeypatch.undo()
    for k, ((p, c), (wp, wc)) in enumerate(zip(_decoded(rec_dir, FRAMES),
                                               _own_frames(cfg))):
        assert p.shape == (N, 3) and c.shape == (N, 3)
        np.testing.assert_allclose(p, wp, rtol=0, atol=ATOL, err_msg=str(k))
        np.testing.assert_allclose(c, wc, rtol=0, atol=ATOL, err_msg=str(k))


@pytest.mark.parametrize("where,k,completed", [
    ("step", 3, 3),      # during frame 3's step: frames 0-2 written
    ("step", 0, 0),      # before any frame
    ("write", 3, 4),     # writing frame 2 after frame 3's step ran
])
def test_interrupt_then_resume(tmp_path, monkeypatch, where, k, completed):
    """A ``KeyboardInterrupt`` injected at frame k: the completed frames
    are written, decode, and equal the simulation's own; the checkpoint
    holds the state after the last of them, so a resume continues from the
    next frame to the frames of an uninterrupted run."""
    monkeypatch.setenv("SPATIALSIM_RECORDINGS", str(tmp_path))
    cfg = _config("paused")
    calls = {"step": 0, "write": 0}
    step, save = NBodySimulation.step_raw, record.save_frame

    def step_raw(self, dt):
        if where == "step" and calls["step"] == k:
            calls["step"] += 1
            raise KeyboardInterrupt
        calls["step"] += 1
        step(self, dt)

    def save_frame(rec_dir, frame, pos, col):
        if where == "write" and frame == k - 1 and not calls["write"]:
            calls["write"] += 1
            raise KeyboardInterrupt
        save(rec_dir, frame, pos, col)

    monkeypatch.setattr(NBodySimulation, "step_raw", step_raw)
    monkeypatch.setattr(record, "save_frame", save_frame)
    record.record(dict(cfg), device="cpu")
    monkeypatch.undo()
    monkeypatch.setenv("SPATIALSIM_RECORDINGS", str(tmp_path))
    rec_dir = tmp_path / "paused"
    assert session.get_completed_frames(rec_dir) == completed
    state_file, frame = session.find_latest_state(rec_dir, completed)
    assert frame == completed - 1
    assert (state_file is None) == (completed == 0)
    own = _own_frames(cfg)
    for j, (p, c) in enumerate(_decoded(rec_dir, completed)):
        np.testing.assert_allclose(p, own[j][0], rtol=0, atol=ATOL)

    assert record.main(["--resume", "paused", "--device", "cpu"]) == 0
    assert session.get_completed_frames(rec_dir) == FRAMES
    for j, (p, c) in enumerate(_decoded(rec_dir, FRAMES)):
        np.testing.assert_allclose(p, own[j][0], rtol=0, atol=ATOL,
                                   err_msg=str(j))
        np.testing.assert_allclose(c, own[j][1], rtol=0, atol=ATOL,
                                   err_msg=str(j))
