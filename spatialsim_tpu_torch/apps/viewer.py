"""Live interactive viewers for the boids flock and the N-body simulation
(port of ``spatialsim_tpu/apps/viewer.py``).

The physics runs on the card through the port's models
(:mod:`spatialsim_tpu_torch.models`, ``device="cuda"`` by default, or
``"cpu"`` when asked); only positions/colours cross to the host per
rendered frame.  Controls: WASD/QE/wheel/drag camera, ESC quit; N-body
extras SPACE pause, R re-init, H help.

    python -m spatialsim_tpu_torch.apps.viewer {nbody,boids} [--count N]
        [--device cuda|cpu]

Without a card the viewer does not start unless ``--device cpu`` is given:
it never steps on the CPU silently.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from spatialsim_tpu_torch.render.camera import OrbitalCamera
from spatialsim_tpu_torch.apps.input_handler import InputHandler
from spatialsim_tpu_torch.apps.world import Grid, TextRenderer


class BaseViewer:
    """pygame + OpenGL window, event/update/render loop."""

    title = "spatialsim"
    max_frame_dt = 0.05   # app-layer dt cap (reference core/application.py:76)

    def __init__(self, width=1280, height=720, grid_size=500.0,
                 camera_kw=None):
        import pygame
        from pygame.locals import DOUBLEBUF, OPENGL
        from OpenGL.GL import (glEnable, glBlendFunc, glClearColor,
                               glMatrixMode, glLoadMatrixf, glFogi, glFogf,
                               glFogfv, GL_BLEND, GL_SRC_ALPHA, GL_ONE,
                               GL_PROJECTION, GL_MODELVIEW, GL_FOG,
                               GL_FOG_MODE, GL_LINEAR, GL_FOG_START,
                               GL_FOG_END, GL_FOG_COLOR)
        from spatialsim_tpu_torch.render.camera import perspective_matrix

        pygame.init()
        self.width, self.height = width, height
        pygame.display.set_mode((width, height), DOUBLEBUF | OPENGL)
        pygame.display.set_caption(self.title)
        glMatrixMode(GL_PROJECTION)
        glLoadMatrixf(perspective_matrix(75.0, width / height, 0.1, 5000.0))
        glMatrixMode(GL_MODELVIEW)
        glEnable(GL_BLEND)
        glBlendFunc(GL_SRC_ALPHA, GL_ONE)
        glClearColor(0.0, 0.0, 0.02, 1.0)
        glEnable(GL_FOG)
        glFogi(GL_FOG_MODE, GL_LINEAR)
        glFogf(GL_FOG_START, 1500.0)
        glFogf(GL_FOG_END, 4000.0)
        glFogfv(GL_FOG_COLOR, (0.0, 0.0, 0.02, 1.0))

        self.camera = OrbitalCamera(**(camera_kw or {}))
        self.input = InputHandler(self.camera)
        self.grid = Grid(grid_size)
        self.text = TextRenderer()
        self.clock = pygame.time.Clock()
        self.running = True
        self.paused = False

    # Subclass hooks -------------------------------------------------------
    def update_sim(self, dt: float) -> None:
        raise NotImplementedError

    def draw_scene(self) -> None:
        raise NotImplementedError

    def hud_lines(self):
        return []

    def on_key(self, key) -> None:
        pass

    def _cull(self, positions, *arrays):
        """Frustum-cull host arrays before the GL upload (the reference
        culls every frame before building VBOs, nbody/simulation.py:403-434
        and boids/flock.py:311-348) — at the default 150K-500K counts the
        GL vertex load would otherwise be uncapped."""
        from spatialsim_tpu_torch.render.points import cull_visible
        keep = cull_visible(positions, self.camera.get_position(),
                            up=self.camera.get_up(),
                            width=self.width, height=self.height)
        return (positions[keep],) + tuple(a[keep] for a in arrays)

    # Main loop ------------------------------------------------------------
    def run(self, max_frames: int = 0) -> None:
        """Event/update/render loop; ``max_frames`` > 0 exits after that
        many frames (headless smoke tests)."""
        import pygame
        from OpenGL.GL import (glClear, glLoadMatrixf,
                               GL_COLOR_BUFFER_BIT, GL_DEPTH_BUFFER_BIT)
        from spatialsim_tpu_torch.render.camera import lookat_matrix
        frames = 0
        while self.running:
            if max_frames and frames >= max_frames:
                break
            frames += 1
            dt = min(self.clock.tick() / 1000.0, self.max_frame_dt)
            for ev in pygame.event.get():
                if ev.type == pygame.QUIT:
                    self.running = False
                elif ev.type == pygame.KEYDOWN:
                    if ev.key == pygame.K_ESCAPE:
                        self.running = False
                    else:
                        self.on_key(ev.key)
                else:
                    self.input.handle_event(ev)
            self.input.update(dt)
            if not self.paused:
                self.update_sim(dt)

            glClear(GL_COLOR_BUFFER_BIT | GL_DEPTH_BUFFER_BIT)
            glLoadMatrixf(lookat_matrix(self.camera.get_position(),
                                        up=self.camera.get_up()))
            self.grid.draw()
            self.draw_scene()
            for i, line in enumerate(self.hud_lines()):
                self.text.draw_text(line, 10, 10 + 22 * i,
                                    (self.width, self.height))
            pygame.display.flip()
        pygame.quit()

    def _draw_arrays(self, positions, colors, mode, point_size=1.5) -> None:
        from OpenGL.GL import (
            glPointSize, glEnableClientState, glDisableClientState,
            glVertexPointer, glColorPointer, glDrawArrays, GL_FLOAT,
            GL_POINTS, GL_VERTEX_ARRAY, GL_COLOR_ARRAY)
        if mode == GL_POINTS:
            glPointSize(point_size)
        glEnableClientState(GL_VERTEX_ARRAY)
        glEnableClientState(GL_COLOR_ARRAY)
        glVertexPointer(3, GL_FLOAT, 0, np.ascontiguousarray(positions))
        glColorPointer(3, GL_FLOAT, 0, np.ascontiguousarray(colors))
        glDrawArrays(mode, 0, len(positions))
        glDisableClientState(GL_COLOR_ARRAY)
        glDisableClientState(GL_VERTEX_ARRAY)

    def _draw_points(self, positions, colors, point_size=1.5) -> None:
        from OpenGL.GL import GL_POINTS
        self._draw_arrays(positions, colors, GL_POINTS, point_size)


class NBodyViewer(BaseViewer):
    title = "N-Body Gravitational Simulation"

    def __init__(self, num_bodies=None, device="cuda", **kw):
        from spatialsim_tpu_torch.models.nbody import NBodySimulation
        from spatialsim_tpu_torch.config.nbody import CAMERA, GRID
        self._make_sim = lambda seed: NBodySimulation(num_bodies, seed=seed,
                                                      device=device)
        self._seed = 0
        # The simulation first: a missing card raises before a window opens.
        self.sim = self._make_sim(0)
        super().__init__(grid_size=GRID["base_size"],
                         camera_kw=dict(radius=CAMERA["initial_radius"],
                                        theta=CAMERA["initial_theta"],
                                        phi=CAMERA["initial_phi"]), **kw)
        self._show_help = False

    def update_sim(self, dt: float) -> None:
        self.sim.update(dt)

    def draw_scene(self) -> None:
        pos, col = self._cull(self.sim.get_positions(),
                              self.sim.get_colors())
        self._draw_points(pos, col, self.sim.config.point_size)

    def on_key(self, key) -> None:
        import pygame
        if key == pygame.K_SPACE:
            self.paused = not self.paused
        elif key == pygame.K_r:
            self._seed += 1
            self.sim = self._make_sim(self._seed)
        elif key == pygame.K_h:
            self._show_help = not self._show_help

    def hud_lines(self):
        lines = [f"bodies: {self.sim.num_bodies:,}   "
                 f"theta: {self.sim.config.theta}   "
                 f"fps: {self.clock.get_fps():.1f}"]
        if self.paused:
            lines.append("PAUSED (SPACE to resume)")
        if self._show_help:
            lines += ["WASD rotate, Q/E zoom, drag rotate, wheel zoom",
                      "SPACE pause, R new seed, H help, ESC quit"]
        return lines


class BoidsViewer(BaseViewer):
    title = "3D Boids Flocking"

    def __init__(self, num_boids=None, device="cuda", **kw):
        from spatialsim_tpu_torch.models.boids import Flock
        from spatialsim_tpu_torch.config.boids import BOIDS
        self.flock = Flock(num_boids, device=device)
        super().__init__(grid_size=BOIDS.bounds, **kw)

    def update_sim(self, dt: float) -> None:
        self.flock.update(dt)

    def draw_scene(self) -> None:
        # Velocity-oriented cone billboards, as in the reference's Flock
        # renderer (boids/flock.py:730-782).
        from OpenGL.GL import GL_TRIANGLES
        from spatialsim_tpu_torch.render.boid_geometry import (
            build_boid_vertices)
        pos, vel, col = self._cull(self.flock.get_positions(),
                                   self.flock.get_velocities(),
                                   self.flock.get_colors())
        verts, cols = build_boid_vertices(
            pos, vel, col,
            cone_length=self.flock.config.size * 2.0,
            cone_radius=self.flock.config.size * 0.7)
        self._draw_arrays(verts, cols, GL_TRIANGLES)

    def hud_lines(self):
        return [f"boids: {self.flock.num_boids:,}   "
                f"fps: {self.clock.get_fps():.1f}"]


def run_viewer(kind: str, count=None, device="cuda", max_frames=0) -> int:
    """Entry with headless fallback message; 1 when no viewer starts (no
    window, or no card for ``device="cuda"``)."""
    try:
        viewer = (NBodyViewer(count, device=device) if kind == "nbody"
                  else BoidsViewer(count, device=device))
    except Exception as exc:
        print(f"[App] Interactive viewer unavailable ({exc}).")
        print("[App] Headless pipeline: python -m spatialsim_tpu_torch.tools."
              "record / playback --headless / export")
        return 1
    viewer.run(max_frames=max_frames)
    return 0


def main(argv=None) -> int:
    from spatialsim_tpu_torch.presets import parse_number
    ap = argparse.ArgumentParser(description="Live N-body or boids viewer "
                                             "on the PyTorch port.")
    ap.add_argument("kind", choices=("nbody", "boids"))
    ap.add_argument("--count", type=parse_number, default=None,
                    help="bodies or boids (e.g. 20000 or 20k); the "
                         "model's default otherwise")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the simulation steps (default: the card)")
    ap.add_argument("--frames", type=int, default=0,
                    help="exit after this many frames (0: run until closed)")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("[App] No CUDA device (torch.cuda.is_available() is False); "
              "pass --device cpu to step the simulation on the CPU.")
        return 1
    return run_viewer(args.kind, args.count, args.device, args.frames)


if __name__ == "__main__":
    sys.exit(main())
