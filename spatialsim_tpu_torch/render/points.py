"""Headless software point renderer.

Replaces the reference's OpenGL point-sprite path (additive-blended
GL_POINTS, ``nbody/simulation.py:940-957``, ``tools/export.py:358-389``)
with a numpy rasterizer: perspective-project, cull, and additively splat
points into an image with per-channel ``bincount`` — no GL context, no
display, works on any headless VM.  Additive blending saturates exactly
like ``glBlendFunc(GL_SRC_ALPHA, GL_ONE)`` does in the reference.
"""

from __future__ import annotations

import numpy as np

from spatialsim_tpu_torch.render.camera import camera_basis


def project_points(positions, eye, target=(0, 0, 0), up=(0, 1, 0),
                   fov_deg=75.0, width=1280, height=720,
                   near=0.1, far=5000.0):
    """Perspective projection to pixel coordinates.

    Returns (px, py, depth, visible) float32/bool arrays of length N.
    """
    right, true_up, fwd = camera_basis(eye, target, up)
    rel = np.asarray(positions, np.float64) - np.asarray(eye, np.float64)
    cx = rel @ right
    cy = rel @ true_up
    cz = rel @ fwd                       # +z into the screen
    visible = (cz > near) & (cz < far)
    f = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    aspect = width / height
    with np.errstate(divide="ignore", invalid="ignore"):
        ndc_x = (cx * f / aspect) / cz
        ndc_y = (cy * f) / cz
    px = (ndc_x * 0.5 + 0.5) * width
    py = (0.5 - ndc_y * 0.5) * height
    visible &= (px >= 0) & (px < width) & (py >= 0) & (py < height)
    return (px.astype(np.float32), py.astype(np.float32),
            cz.astype(np.float32), visible)


def cull_visible(positions, eye, target=(0, 0, 0), up=(0, 1, 0),
                 fov_deg=75.0, width=1280, height=720, margin=0.1):
    """Indices of points inside the (slightly dilated) view frustum.

    The per-point culling the reference runs before uploading VBOs
    (``nbody/simulation.py:403-434``, ``boids/flock.py:311-348``); the
    margin keeps points that are just off-screen so nothing pops at the
    edges during camera motion.
    """
    w = int(width * (1 + margin))
    h = int(height * (1 + margin))
    px, py, _, vis = project_points(
        positions, eye, target, up, fov_deg, w, h)
    return np.flatnonzero(vis)


def render_points(positions, colors, eye, target=(0, 0, 0), up=(0, 1, 0),
                  fov_deg=75.0, width=1280, height=720,
                  point_size=1.0, brightness=1.0,
                  background=(0.0, 0.0, 0.02)):
    """Render points to a (height, width, 3) uint8 image.

    ``point_size`` > 1 splats each point onto a small square of pixels
    (mirrors GL point size); intensity is divided over the square so
    total luminance is size-independent.
    """
    px, py, _, vis = project_points(positions, eye, target, up, fov_deg,
                                    width, height)
    colors = np.asarray(colors, np.float32)
    img = np.zeros((height * width, 3), np.float32)

    ix = px[vis].astype(np.int32)
    iy = py[vis].astype(np.int32)
    col = colors[vis] * brightness

    size = max(1, int(round(point_size)))
    offsets = [(0, 0)] if size == 1 else [
        (dx, dy) for dx in range(-(size // 2), size - size // 2)
        for dy in range(-(size // 2), size - size // 2)]
    w = 1.0 / len(offsets)
    for dx, dy in offsets:
        x = np.clip(ix + dx, 0, width - 1)
        y = np.clip(iy + dy, 0, height - 1)
        flat = y.astype(np.int64) * width + x
        for c in range(3):
            img[:, c] += np.bincount(flat, weights=col[:, c] * w,
                                     minlength=height * width)

    img = img.reshape(height, width, 3)
    img += np.asarray(background, np.float32)
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
