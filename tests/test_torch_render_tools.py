"""The port's copies of ``render/``, ``tools/playback.py`` and
``tools/export.py`` (cameras, software renderer, playback source, export
pipeline): ``tests/test_render_tools.py``'s cases against the copies, then
a session recorded by the port's recorder played back headless by the
port's playback, in process and as ``python -m``.
"""

import numpy as np
import pytest

from spatialsim_tpu_torch.io import codec, session
from spatialsim_tpu_torch.render import (ExportCamera, OrbitalCamera,
                                         PlaybackCamera, render_points)
from spatialsim_tpu_torch.render.points import project_points


def test_orbital_camera_position_and_clamp():
    cam = OrbitalCamera(radius=100.0, theta=0.0, phi=0.0)
    np.testing.assert_allclose(cam.get_position(), [100, 0, 0], atol=1e-9)
    cam.rotate(90.0, 0.0)
    np.testing.assert_allclose(cam.get_position(), [0, 0, 100], atol=1e-6)
    cam.rotate(0.0, 200.0)          # phi clamps at 89
    assert cam.phi == 89.0
    cam.zoom(1e9)
    for _ in range(100):
        cam.update(0.1)
    assert abs(cam.radius - cam.max_radius) < 1.0


def test_playback_camera_up_flip():
    cam = PlaybackCamera(phi=0.0)
    assert cam.get_up() == (0.0, 1.0, 0.0)
    cam.rotate(0.0, 180.0)          # upside down
    assert cam.get_up() == (0.0, -1.0, 0.0)
    cam.rotate(0.0, 180.0)          # wraps to 360 == 0
    assert cam.get_up() == (0.0, 1.0, 0.0)


@pytest.mark.parametrize("mode", ExportCamera.MODES)
def test_export_camera_modes_finite(mode):
    cam = ExportCamera(radius=500.0, mode=mode)
    for k in range(0, 100, 10):
        cam.update(k, 100)
        assert np.isfinite(cam.get_position()).all()
    if mode == "topdown":
        assert cam.phi == 80.0


def test_projection_center_and_culling():
    eye = np.array([0.0, 0.0, -100.0])
    pts = np.array([[0.0, 0.0, 0.0],      # straight ahead -> center
                    [0.0, 0.0, -200.0],   # behind the camera
                    [0.0, 0.0, 9000.0]])  # beyond far clip
    px, py, depth, vis = project_points(pts, eye, width=640, height=480)
    assert vis[0] and not vis[1] and not vis[2]
    assert abs(px[0] - 320) < 1e-3 and abs(py[0] - 240) < 1e-3
    assert abs(depth[0] - 100) < 1e-3


def test_render_points_splats_brightness():
    pos = np.zeros((10, 3), np.float32)
    col = np.ones((10, 3), np.float32)
    img = render_points(pos, col, eye=[0, 0, -50], width=64, height=64,
                        background=(0, 0, 0))
    assert img.shape == (64, 64, 3)
    assert img[32, 32].min() == 255            # 10 white points saturate
    assert img[0, 0].max() == 0                # background empty


def _make_session(tmp_path, monkeypatch, name="sess", frames=8, n=100):
    monkeypatch.setenv("SPATIALSIM_RECORDINGS", str(tmp_path))
    rng = np.random.default_rng(0)
    d = session.get_recording_dir(name)
    session.save_metadata(d, {"session_name": name, "num_bodies": n,
                              "total_frames": frames, "spawn_radius": 100.0,
                              "distribution": "galaxy"})
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 50
    for k in range(frames):
        pos = pos + 0.1
        col = rng.random((n, 3)).astype(np.float32)
        codec.save_frame(d, k, pos, col)
    return d


def test_frame_source_preload_all(tmp_path, monkeypatch):
    from spatialsim_tpu_torch.tools.playback import FrameSource
    d = _make_session(tmp_path, monkeypatch)
    src = FrameSource(d)
    src.start()
    p, c = src.get(5)
    assert p.shape == (100, 3)
    src.stop()


def test_headless_playback_cli(tmp_path, monkeypatch, capsys):
    from spatialsim_tpu_torch.tools import playback
    _make_session(tmp_path, monkeypatch)
    assert playback.main(["sess", "--headless"]) == 0
    out = capsys.readouterr().out
    assert "decoded 8 frames" in out


def test_export_to_video(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    from spatialsim_tpu_torch.tools import export
    _make_session(tmp_path, monkeypatch)
    rc = export.main(["sess", "--resolution", "720p", "--fps", "10",
                      "--camera", "orbit"])
    assert rc == 0
    out = tmp_path / "sess" / "sess.mp4"
    assert out.exists() and out.stat().st_size > 1000
    cap = cv2.VideoCapture(str(out))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 8
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == 1280
    cap.release()


def test_export_wizard(tmp_path, monkeypatch):
    """No-session export runs the interactive wizard (reference
    tools/export.py:793-1042): pick session by number, accept defaults."""
    pytest.importorskip("cv2")
    from spatialsim_tpu_torch.tools import export
    _make_session(tmp_path, monkeypatch)
    answers = iter(["1", "720p", "", "", "", "10", "", ""])
    monkeypatch.setattr("builtins.input", lambda *a: next(answers))
    assert export.main([]) == 0
    assert (tmp_path / "sess" / "sess.mp4").exists()


def test_playback_wizard(tmp_path, monkeypatch, capsys):
    """No-session playback runs the wizard then plays (headless here)."""
    from spatialsim_tpu_torch.tools import playback
    _make_session(tmp_path, monkeypatch)
    answers = iter(["sess", "30", ""])
    monkeypatch.setattr("builtins.input", lambda *a: next(answers))
    assert playback.main(["--headless"]) == 0
    assert "decoded 8 frames" in capsys.readouterr().out


def test_wizard_prompt_validation(monkeypatch, capsys):
    from spatialsim_tpu_torch.tools.export import prompt
    answers = iter(["nope", "5"])
    monkeypatch.setattr("builtins.input", lambda *a: next(answers))
    assert prompt("FPS", 30, int) == 5          # re-asks on bad cast
    answers = iter([""])
    monkeypatch.setattr("builtins.input", lambda *a: next(answers))
    assert prompt("FPS", 30, int) == 30         # ENTER keeps default
    monkeypatch.setattr("builtins.input",
                        lambda *a: (_ for _ in ()).throw(EOFError()))
    assert prompt("FPS", 30, int) == 30         # EOF keeps default


def test_export_unique_naming(tmp_path):
    from spatialsim_tpu_torch.tools.export import unique_output_path
    base = tmp_path / "x.mp4"
    assert unique_output_path(base) == base
    base.write_bytes(b"")
    assert unique_output_path(base).name == "x (1).mp4"


def test_boid_cone_geometry():
    from spatialsim_tpu_torch.render.boid_geometry import build_boid_vertices
    pos = np.array([[0.0, 0.0, 0.0], [10.0, 0.0, 0.0]])
    vel = np.array([[1.0, 0.0, 0.0], [0.0, 5.0, 0.0]])  # 2nd flies straight up
    col = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    verts, cols = build_boid_vertices(pos, vel, col, cone_length=2.0,
                                      cone_radius=0.5)
    assert verts.shape == (12, 3) and cols.shape == (12, 3)
    # Boid 0: tip 2 units along +x; both triangles share the tip.
    np.testing.assert_allclose(verts[0], [2.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(verts[3], verts[0], atol=1e-6)
    # Base points at radius 0.5 from the position, perpendicular to v.
    for k in (1, 2, 4, 5):
        np.testing.assert_allclose(np.linalg.norm(verts[k]), 0.5, atol=1e-6)
        assert abs(verts[k] @ np.array([1.0, 0, 0])) < 1e-6
    # Boid 1 (vertical flyer): world-right fallback keeps the frame finite.
    np.testing.assert_allclose(verts[6], [10.0, 2.0, 0.0], atol=1e-6)
    assert np.isfinite(verts[6:]).all()
    # Colors replicate per vertex.
    np.testing.assert_allclose(cols[:6], [[1, 0, 0]] * 6)


def test_boid_visible_filter():
    from spatialsim_tpu_torch.render.boid_geometry import build_boid_vertices
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(10, 3))
    vel = rng.normal(size=(10, 3))
    col = rng.random((10, 3))
    vis = np.array([1, 3, 4])
    verts, cols = build_boid_vertices(pos, vel, col, visible=vis)
    assert verts.shape == (18, 3)


def test_port_recording_plays_back_headless(tmp_path, monkeypatch, capsys):
    """The port's recorder (on the CPU) writes a session; the port's
    playback decodes every frame of it, and so does its module entry."""
    import subprocess
    import sys
    from pathlib import Path
    from spatialsim_tpu_torch.presets import get_preset_config
    from spatialsim_tpu_torch.tools import playback, record
    monkeypatch.setenv("SPATIALSIM_RECORDINGS", str(tmp_path))
    cfg = get_preset_config("tiny_galaxy")
    cfg.update(num_bodies=600, total_frames=5, session_name="port")
    record.record(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "python -m spatialsim_tpu_torch.tools.playback port" in out
    assert playback.main(["port", "--headless"]) == 0
    assert "decoded 5 frames" in capsys.readouterr().out
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "spatialsim_tpu_torch.tools.playback", "port",
         "--headless"], cwd=root, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "decoded 5 frames" in proc.stdout
