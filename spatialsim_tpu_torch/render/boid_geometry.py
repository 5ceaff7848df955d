"""Boid cone-billboard geometry.

Vectorized numpy re-implementation of the reference's per-boid vertex
builder (``boids/flock.py:351-447``): each boid renders as two crossed
triangles — tip at ``pos + forward·cone_length``, bases offset ±radius
along the right and up vectors of a velocity-aligned frame (world-up
cross products, world-right fallback near the poles).
"""

from __future__ import annotations

import numpy as np

WORLD_UP = np.array([0.0, 1.0, 0.0])
WORLD_RIGHT = np.array([1.0, 0.0, 0.0])


def boid_frames(velocities: np.ndarray):
    """(forward, right, up) unit frames per boid from velocities (N, 3)."""
    v = np.asarray(velocities, np.float64)
    speed = np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-4)
    fwd = v / speed
    right = np.cross(fwd, WORLD_UP)
    r_len = np.linalg.norm(right, axis=1, keepdims=True)
    # Near-vertical flyers use world-right for the cross product.
    polar = (r_len < 0.1)[:, 0]
    right[polar] = np.cross(fwd[polar], WORLD_RIGHT)
    r_len = np.linalg.norm(right, axis=1, keepdims=True)
    right = right / np.maximum(r_len, 1e-4)
    up = np.cross(right, fwd)
    return fwd, right, up


def build_boid_vertices(positions, velocities, colors,
                        cone_length: float = 2.4, cone_radius: float = 0.8,
                        visible=None):
    """Crossed-triangle cones: returns (vertices (6V, 3), colors (6V, 3))."""
    pos = np.asarray(positions, np.float64)
    col = np.asarray(colors, np.float32)
    vel = np.asarray(velocities, np.float64)
    if visible is not None:
        pos, vel, col = pos[visible], vel[visible], col[visible]
    n = len(pos)
    fwd, right, up = boid_frames(vel)

    tip = pos + fwd * cone_length
    base_r = pos + right * cone_radius
    base_l = pos - right * cone_radius
    base_u = pos + up * cone_radius
    base_d = pos - up * cone_radius

    verts = np.empty((n, 6, 3), np.float32)
    verts[:, 0] = tip
    verts[:, 1] = base_r
    verts[:, 2] = base_l
    verts[:, 3] = tip
    verts[:, 4] = base_u
    verts[:, 5] = base_d

    vcols = np.repeat(col[:, None, :], 6, axis=1).astype(np.float32)
    return verts.reshape(-1, 3), vcols.reshape(-1, 3)
