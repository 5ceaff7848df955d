"""Orbital cameras.

Semantics follow the reference's three camera flavours:

* :class:`OrbitalCamera` — the live-app camera (``core/camera.py:10-105``):
  spherical (radius, theta, phi) about the origin, phi clamped to ±89°,
  smooth exponential zoom (rate 8/s), negative radius allowed for
  fly-through.
* :class:`PlaybackCamera` — full 360° phi with up-vector flip
  (``tools/playback.py:52-116``).
* :class:`ExportCamera` — 9 scripted animation modes parameterized over
  export progress t (``tools/export.py:166-256``).
"""

from __future__ import annotations

import math

import numpy as np


def perspective_matrix(fov_deg, aspect, near, far):
    """Column-major GL projection matrix (replaces gluPerspective — GLU is
    absent on headless images)."""
    f = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2.0 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m.T.copy()  # GL expects column-major


def lookat_matrix(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """Column-major GL modelview matrix (replaces gluLookAt)."""
    right, true_up, fwd = camera_basis(eye, target, up)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = right
    m[1, :3] = true_up
    m[2, :3] = -fwd
    eye = np.asarray(eye, np.float64)
    m[0, 3] = -right @ eye
    m[1, 3] = -true_up @ eye
    m[2, 3] = fwd @ eye
    return m.T.copy()


def camera_basis(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """Right/up/forward unit vectors of a look-at camera."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / (np.linalg.norm(right) + 1e-12)
    true_up = np.cross(right, fwd)
    return right, true_up, fwd


class OrbitalCamera:
    """Spherical orbit about the origin with smooth zoom."""

    def __init__(self, radius=800.0, theta=45.0, phi=35.0,
                 min_radius=-3000.0, max_radius=3000.0,
                 min_phi=-89.0, max_phi=89.0, zoom_rate=8.0):
        self.radius = radius
        self.target_radius = radius
        self.theta = theta
        self.phi = phi
        self.min_radius = min_radius
        self.max_radius = max_radius
        self.min_phi = min_phi
        self.max_phi = max_phi
        self.zoom_rate = zoom_rate

    def rotate(self, d_theta: float, d_phi: float) -> None:
        self.theta = (self.theta + d_theta) % 360.0
        self.phi = float(np.clip(self.phi + d_phi, self.min_phi, self.max_phi))

    def zoom(self, delta: float) -> None:
        self.target_radius = float(
            np.clip(self.target_radius + delta, self.min_radius,
                    self.max_radius))

    def update(self, dt: float) -> None:
        # Exponential approach toward the target radius (x8 per second),
        # the reference's smooth-zoom lerp (core/camera.py:82-88).
        blend = min(1.0, self.zoom_rate * dt)
        self.radius += (self.target_radius - self.radius) * blend

    def get_position(self) -> np.ndarray:
        th = math.radians(self.theta)
        ph = math.radians(self.phi)
        return np.array([
            self.radius * math.cos(ph) * math.cos(th),
            self.radius * math.sin(ph),
            self.radius * math.cos(ph) * math.sin(th),
        ])

    def get_up(self):
        return (0.0, 1.0, 0.0)

    def get_camera_axes(self):
        return camera_basis(self.get_position(), up=self.get_up())


class PlaybackCamera(OrbitalCamera):
    """Full-circle vertical orbit: phi wraps 360°, up flips past the pole."""

    def __init__(self, radius=800.0, theta=45.0, phi=35.0, **kw):
        super().__init__(radius, theta, phi, min_phi=-1e9, max_phi=1e9, **kw)

    def rotate(self, d_theta: float, d_phi: float) -> None:
        self.theta = (self.theta + d_theta) % 360.0
        self.phi = (self.phi + d_phi) % 360.0

    def get_up(self):
        # Upside-down when cos(phi) < 0 (reference playback.py:96-104).
        return (0.0, 1.0, 0.0) if math.cos(math.radians(self.phi)) >= 0 \
            else (0.0, -1.0, 0.0)


class ExportCamera:
    """Scripted camera paths for video export (9 modes)."""

    MODES = ("fixed", "orbit", "spiral", "zoom", "zoomout", "zoomin",
             "cinematic", "flyby", "topdown")

    def __init__(self, radius=800.0, theta=45.0, phi=25.0,
                 mode="orbit", rotation_speed=0.3):
        self.base_radius = radius
        self.base_theta = theta
        self.base_phi = phi
        self.radius = radius
        self.theta = theta
        self.phi = phi
        self.mode = mode
        self.speed = rotation_speed

    def update(self, frame_idx: int, total_frames: int) -> None:
        t = frame_idx / max(1, total_frames - 1)
        m, s = self.mode, self.speed
        th0, ph0, r0 = self.base_theta, self.base_phi, self.base_radius
        if m == "fixed":
            pass
        elif m == "orbit":
            self.theta = th0 + frame_idx * s
        elif m == "spiral":
            self.theta = th0 + frame_idx * s
            self.phi = ph0 + 10 * math.sin(t * 2 * math.pi)
        elif m == "zoom":
            self.theta = th0 + frame_idx * s * 0.5
            self.radius = r0 * (1.0 + 0.3 * math.sin(t * 2 * math.pi))
        elif m == "zoomout":
            self.theta = th0 + frame_idx * s * 0.2
            self.radius = r0 * (0.5 + 2.0 * t)
        elif m == "zoomin":
            self.theta = th0 + frame_idx * s * 0.4
            self.radius = r0 * (2.0 - 2.0 * t)
        elif m == "cinematic":
            self.theta = th0 + frame_idx * s * 0.3
            self.phi = ph0 + 15 * math.sin(t * math.pi)
            self.radius = r0 * (1.0 - 0.2 * t)
        elif m == "flyby":
            self.theta = th0 + 90 * t
            self.phi = ph0 - 20 + 40 * t
            self.radius = r0 * (1.5 - 0.8 * math.sin(t * math.pi))
        elif m == "topdown":
            self.theta = th0 + frame_idx * s * 0.5
            self.phi = 80.0
            self.radius = r0 * 1.2
        else:
            raise ValueError(f"unknown camera mode {m!r}")

    def get_position(self) -> np.ndarray:
        th = math.radians(self.theta)
        ph = math.radians(self.phi)
        return np.array([
            self.radius * math.cos(ph) * math.cos(th),
            self.radius * math.sin(ph),
            self.radius * math.cos(ph) * math.sin(th),
        ])

    def get_up(self):
        return (0.0, 1.0, 0.0) if math.cos(math.radians(self.phi)) >= 0 \
            else (0.0, -1.0, 0.0)
