"""The port's live viewers and interactive playback draw real frames
through Mesa's offscreen SDL driver, with the simulation on the CPU
(``device="cpu"``); ``tests/test_viewer_gl.py``'s cases against the port.

Each GL case drives a viewer in a subprocess with SDL_VIDEODRIVER=offscreen
and PYOPENGL_PLATFORM=egl (both must be set before the libraries load),
steps a few frames through the whole event/update/cull/draw loop, and
asserts a clean exit; they skip where no offscreen GL context opens (the
check runs in a fixture).  Without a card the viewer's module entry
refuses to start unless ``--device cpu`` is given.
"""

import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, extra_env=None) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env.update({"SDL_VIDEODRIVER": "offscreen", "PYOPENGL_PLATFORM": "egl",
                "PYTHONPATH": _REPO + os.pathsep + env.get("PYTHONPATH", "")})
    env.update(extra_env or {})
    return subprocess.run([sys.executable] + args, env=env, cwd=_REPO,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def offscreen_gl():
    code = (
        "import pygame; from pygame.locals import DOUBLEBUF, OPENGL;"
        "pygame.init(); pygame.display.set_mode((32, 32), DOUBLEBUF|OPENGL);"
        "from OpenGL.GL import glClear, GL_COLOR_BUFFER_BIT;"
        "glClear(GL_COLOR_BUFFER_BIT)")
    if _run(["-c", code]).returncode != 0:
        pytest.skip("no offscreen GL available")


def test_nbody_viewer_draws_frames(offscreen_gl):
    proc = _run(["-c",
                 "from spatialsim_tpu_torch.apps.viewer import NBodyViewer\n"
                 "import numpy as np\n"
                 "v = NBodyViewer(num_bodies=2000, device='cpu', width=320,\n"
                 "                height=240)\n"
                 "v.run(max_frames=3)\n"
                 "assert np.isfinite(v.sim.get_positions()).all()\n"
                 "print('NBODY_GL_OK')\n"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NBODY_GL_OK" in proc.stdout


def test_boids_viewer_draws_frames(offscreen_gl):
    proc = _run(["-c",
                 "from spatialsim_tpu_torch.apps.viewer import BoidsViewer\n"
                 "import numpy as np\n"
                 "v = BoidsViewer(num_boids=2000, device='cpu', width=320,\n"
                 "                height=240)\n"
                 "v.run(max_frames=3)\n"
                 "assert np.isfinite(v.flock.get_positions()).all()\n"
                 "print('BOIDS_GL_OK')\n"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BOIDS_GL_OK" in proc.stdout


def test_viewer_module_entry_draws_frames(offscreen_gl):
    proc = _run(["-m", "spatialsim_tpu_torch.apps.viewer", "nbody",
                 "--count", "2k", "--device", "cpu", "--frames", "3"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "unavailable" not in proc.stdout


def test_interactive_playback_draws_frames(offscreen_gl, tmp_path,
                                           monkeypatch):
    # Record a tiny session with the port's recorder on the CPU (no GL
    # needed), then play it back through the GL viewer offscreen.
    from spatialsim_tpu_torch.tools import record
    monkeypatch.setenv("SPATIALSIM_RECORDINGS", str(tmp_path))
    cfg = {
        "session_name": "glsmoke", "name": "GL", "description": "",
        "category": "TINY", "num_bodies": 500, "theta": 0.9, "G": 0.2,
        "softening": 5.0, "damping": 1.0, "spawn_radius": 200.0,
        "distribution": "galaxy", "total_frames": 4,
        "dt_per_frame": 0.1, "substeps": 1, "target_fps": 30,
        "estimated_time": "~0s", "seed": 1,
    }
    record.record(cfg, device="cpu")
    proc = _run(["-c",
                 "from spatialsim_tpu_torch.tools.playback import "
                 "interactive_playback\n"
                 "stats = {}\n"
                 "rc = interactive_playback('glsmoke', fps=120.0, "
                 "max_frames=5,\n"
                 "                          stats=stats)\n"
                 "assert rc == 0\n"
                 "assert stats['hud_draws'] == stats['rendered'] > 0, stats\n"
                 "print('PLAYBACK_GL_OK')\n"],
                extra_env={"SPATIALSIM_RECORDINGS": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PLAYBACK_GL_OK" in proc.stdout


def test_viewer_without_a_card_needs_device_cpu():
    """No card here: the default device is the card, so the viewer does
    not start, says why and exits non-zero (it never steps on the CPU
    unasked).  Decided in the subprocess, which imports torch."""
    proc = _run(["-c",
                 "import sys, torch\n"
                 "torch.cuda.is_available = lambda: False\n"
                 "from spatialsim_tpu_torch.apps import viewer\n"
                 "sys.exit(viewer.main(['boids', '--count', '500']))\n"])
    assert proc.returncode == 1, proc.stderr[-3000:]
    assert "is_available() is False" in proc.stdout
    assert "--device cpu" in proc.stdout
