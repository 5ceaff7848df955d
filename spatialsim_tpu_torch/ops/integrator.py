"""Semi-implicit Euler with damping (port of
``spatialsim_tpu/ops/integrator.py``): kick -> damp -> drift.

    v = (v + a * dt) * damping
    x = x + v * dt
"""

from __future__ import annotations

import torch


def integrate(pos: torch.Tensor, vel: torch.Tensor, accel: torch.Tensor,
              dt: float, damping: float = 1.0):
    """One kick-damp-drift substep on ``(3, N)`` float32 tensors.

    Returns new ``(pos, vel)`` tensors; the inputs are not modified, so a
    tensor that aliases the old positions (``BHLists.ref_pos``) stays valid.
    """
    vel = (vel + accel * dt) * damping
    pos = pos + vel * dt
    return pos, vel
