"""Recording playback.

Re-design of the reference player (``tools/playback.py:119-538``) for
headless TPU VMs:

* The same frame source: preload-all for ≤200 frames, else an LRU cache
  with a background sequential-decode thread reading ahead (delta chains
  force sequential decode; reference ``:146-366``).
* Two front-ends over that source:
  - ``--headless``: decode/validate, print stats, optionally write PNG
    snapshots via the software renderer (no display needed).
  - interactive pygame/OpenGL viewer when a display exists (same controls:
    SPACE pause, ←/→ step, +/- speed, L loop, F fullscreen).
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from spatialsim_tpu_torch.io import codec, session
from spatialsim_tpu_torch.render import ExportCamera, PlaybackCamera, render_points

PRELOAD_ALL_LIMIT = 200
CACHE_SIZE = 50
READAHEAD = 30


class FrameSource:
    """Random-access frames over sequential delta chains, with caching."""

    def __init__(self, rec_dir: Path, total_frames: Optional[int] = None):
        self.rec_dir = Path(rec_dir)
        self.total = (session.get_completed_frames(rec_dir)
                      if total_frames is None else total_frames)
        if self.total == 0:
            raise FileNotFoundError(f"no frames in {rec_dir}")
        self._cache: "OrderedDict[int, Tuple[np.ndarray, np.ndarray]]" \
            = OrderedDict()
        self._lock = threading.Lock()
        self._preload_all = self.total <= PRELOAD_ALL_LIMIT
        self._stop = False
        self._want = 0
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._preload_all:
            prev = (None, None)
            for k in range(self.total):
                prev = codec.load_frame(self.rec_dir, k, *prev)
                self._cache[k] = prev
        else:
            self._thread = threading.Thread(
                target=self._preloader, daemon=True, name="frame-preload")
            self._thread.start()

    def stop(self) -> None:
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _put(self, k, frame) -> None:
        with self._lock:
            self._cache[k] = frame
            self._cache.move_to_end(k)
            while len(self._cache) > CACHE_SIZE:
                self._cache.popitem(last=False)

    def _get_cached(self, k):
        with self._lock:
            f = self._cache.get(k)
            if f is not None:
                self._cache.move_to_end(k)
            return f

    def _preloader(self) -> None:
        """Decode sequentially ahead of the playhead (reference :292-366)."""
        prev = (None, None)
        pos = 0
        while not self._stop:
            want = self._want
            # Loop wrap or seek-back resets the chain.
            if pos >= self.total or pos < want - CACHE_SIZE:
                pos = want
                prev = (None, None)
            if pos < want + READAHEAD and pos < self.total:
                if self._get_cached(pos) is None or prev[0] is None:
                    try:
                        prev = codec.load_frame(self.rec_dir, pos, *prev)
                    except FileNotFoundError:
                        time.sleep(0.05)
                        continue
                    self._put(pos, prev)
                else:
                    prev = self._get_cached(pos)
                pos += 1
            else:
                time.sleep(0.005)

    def get(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        self._want = k
        f = self._get_cached(k)
        if f is None:
            f = codec.load_frame(self.rec_dir, k)
            self._put(k, f)
        return f


def headless_playback(name: str, snapshot_every: int = 0,
                      out_dir: Optional[str] = None,
                      width=1280, height=720) -> int:
    rec_dir = session.get_recording_dir(name, create=False)
    meta = session.load_metadata(rec_dir)
    src = FrameSource(rec_dir)
    src.start()
    print(f"[Playback] {name}: {src.total} frames, "
          f"{meta.get('num_bodies', '?'):,} bodies, "
          f"distribution={meta.get('distribution', '?')}")
    cam = ExportCamera(radius=meta.get("spawn_radius", 500.0) * 1.6,
                       mode="orbit", rotation_speed=0.5)
    t0 = time.time()
    motion = 0.0
    prev_pos = None
    for k in range(src.total):
        pos, col = src.get(k)
        if prev_pos is not None:
            motion += float(np.abs(pos - prev_pos).mean())
        prev_pos = pos
        if snapshot_every and k % snapshot_every == 0:
            from PIL import Image
            cam.update(k, src.total)
            img = render_points(pos, col, cam.get_position(),
                                up=cam.get_up(), width=width, height=height,
                                point_size=2)
            out = Path(out_dir or rec_dir) / f"snapshot_{k:04d}.png"
            Image.fromarray(img).save(out)
            print(f"[Playback] wrote {out}")
    dt = time.time() - t0
    src.stop()
    print(f"[Playback] decoded {src.total} frames in {dt:.1f}s "
          f"({src.total / max(dt, 1e-9):.0f} fps), "
          f"mean per-frame motion {motion / max(1, src.total - 1):.3f}")
    return 0


def interactive_playback(name: str, fps: float = 60.0, speed: float = 1.0,
                         loop: bool = True, max_frames: int = 0,
                         stats: Optional[dict] = None) -> int:
    """pygame/OpenGL viewer; requires a display (or an offscreen SDL
    driver).  ``max_frames`` > 0 exits after that many rendered frames
    (the headless GL smoke-test hook); ``stats`` (if given) receives
    counters, e.g. ``hud_draws``."""
    rec_dir = session.get_recording_dir(name, create=False)
    meta = session.load_metadata(rec_dir)
    src = FrameSource(rec_dir)
    src.start()

    import pygame
    from pygame.locals import (DOUBLEBUF, OPENGL, K_SPACE, K_LEFT, K_RIGHT,
                               K_EQUALS, K_MINUS, K_l, K_f, K_ESCAPE, QUIT,
                               KEYDOWN)
    from OpenGL.GL import (
        glClear, glClearColor, glEnable, glBlendFunc, glMatrixMode,
        glLoadMatrixf, glEnableClientState, glDisableClientState,
        glVertexPointer, glColorPointer, glDrawArrays, glPointSize,
        GL_COLOR_BUFFER_BIT, GL_DEPTH_BUFFER_BIT, GL_BLEND, GL_SRC_ALPHA,
        GL_ONE, GL_PROJECTION, GL_MODELVIEW, GL_VERTEX_ARRAY,
        GL_COLOR_ARRAY, GL_FLOAT, GL_POINTS)
    from spatialsim_tpu_torch.render.camera import (lookat_matrix,
                                              perspective_matrix)

    pygame.init()
    w, h = 1280, 720
    pygame.display.set_mode((w, h), DOUBLEBUF | OPENGL)
    pygame.display.set_caption(f"Playback: {name}")
    glMatrixMode(GL_PROJECTION)
    glLoadMatrixf(perspective_matrix(75.0, w / h, 0.1, 5000.0))
    glMatrixMode(GL_MODELVIEW)
    glEnable(GL_BLEND)
    glBlendFunc(GL_SRC_ALPHA, GL_ONE)
    glClearColor(0.0, 0.0, 0.02, 1.0)
    glPointSize(float(meta.get("point_size", 1.5)))

    cam = PlaybackCamera(radius=meta.get("spawn_radius", 500.0) * 1.6)
    clock = pygame.time.Clock()
    from spatialsim_tpu_torch.apps.world import TextRenderer
    hud = TextRenderer(size=16)
    playhead = 0.0
    paused = False
    running = True
    rendered = 0
    hud_draws = 0
    while running:
        if max_frames and rendered >= max_frames:
            break
        rendered += 1
        dt = clock.tick(int(fps)) / 1000.0
        for ev in pygame.event.get():
            if ev.type == QUIT:
                running = False
            elif ev.type == KEYDOWN:
                if ev.key == K_ESCAPE:
                    running = False
                elif ev.key == K_SPACE:
                    paused = not paused
                elif ev.key == K_LEFT:
                    playhead = max(0.0, playhead - 1)
                elif ev.key == K_RIGHT:
                    playhead = min(src.total - 1.0, playhead + 1)
                elif ev.key == K_EQUALS:
                    speed *= 1.5
                elif ev.key == K_MINUS:
                    speed /= 1.5
                elif ev.key == K_l:
                    loop = not loop
                elif ev.key == K_f:
                    pygame.display.toggle_fullscreen()
        keys = pygame.key.get_pressed()
        cam.rotate((keys[pygame.K_d] - keys[pygame.K_a]) * 60 * dt,
                   (keys[pygame.K_w] - keys[pygame.K_s]) * 60 * dt)
        cam.zoom((keys[pygame.K_e] - keys[pygame.K_q]) * 100 * dt)
        cam.update(dt)

        if not paused:
            playhead += fps * speed * dt
            if playhead >= src.total:
                playhead = 0.0 if loop else src.total - 1.0
        pos, col = src.get(int(playhead))
        # Frustum cull before the VBO upload (reference culls every frame,
        # nbody/simulation.py:403-434).
        from spatialsim_tpu_torch.render.points import cull_visible
        keep = cull_visible(pos, cam.get_position(), up=cam.get_up(),
                            width=w, height=h)
        pos, col = pos[keep], col[keep]

        glClear(GL_COLOR_BUFFER_BIT | GL_DEPTH_BUFFER_BIT)
        glLoadMatrixf(lookat_matrix(cam.get_position(), up=cam.get_up()))
        glEnableClientState(GL_VERTEX_ARRAY)
        glEnableClientState(GL_COLOR_ARRAY)
        glVertexPointer(3, GL_FLOAT, 0, np.ascontiguousarray(pos))
        glColorPointer(3, GL_FLOAT, 0, np.ascontiguousarray(col))
        glDrawArrays(GL_POINTS, 0, len(pos))
        glDisableClientState(GL_COLOR_ARRAY)
        glDisableClientState(GL_VERTEX_ARRAY)
        # HUD overlay: frame counter / speed / FPS / loop status every
        # frame (reference tools/playback.py:442-466).
        status = "||" if paused else ">"
        line = (f"{status} Frame {int(playhead) + 1}/{src.total} | "
                f"Speed: {speed:.1f}x | FPS: {clock.get_fps():.0f}"
                + (" | loop" if loop else ""))
        hud.draw_text(line, 10, 10, window_size=(w, h))
        hud_draws += 1
        pygame.display.flip()
    src.stop()
    if stats is not None:
        stats["hud_draws"] = hud_draws
        stats["rendered"] = rendered
    pygame.quit()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Play back a recording")
    p.add_argument("session", nargs="?", help="session name")
    p.add_argument("--fps", type=float, default=60.0)
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--no-loop", action="store_true")
    p.add_argument("--headless", action="store_true",
                   help="decode + stats without a display")
    p.add_argument("--snapshots", type=int, default=0, metavar="N",
                   help="headless: write a PNG every N frames")
    p.add_argument("--list", dest="list_", action="store_true")
    args = p.parse_args(argv)

    if args.list_:
        rows = session.list_recordings()
        if not rows:
            print("No recordings found")
            return 0
        for name, meta, done, total in rows:
            print(f"  {name:<28} {done}/{total} frames  "
                  f"{meta.get('num_bodies', 0):,} bodies")
        return 0

    name = args.session
    fps, speed = args.fps, args.speed
    if not name:
        # Interactive wizard (reference tools/playback.py:639-733).
        from spatialsim_tpu_torch.tools.export import pick_session, prompt
        name = pick_session()
        if name is None:
            return 1
        fps = prompt("Target FPS", fps, float)
        speed = prompt("Speed multiplier", speed, float)

    if args.headless:
        return headless_playback(name, args.snapshots)
    try:
        return interactive_playback(name, fps, speed, not args.no_loop)
    except Exception as exc:
        print(f"[Playback] interactive viewer unavailable ({exc}); "
              "use --headless")
        return 1


if __name__ == "__main__":
    sys.exit(main())
