"""Velocity heat-map colouring (port of ``spatialsim_tpu/ops/colors.py``).

The 7-segment blue -> white -> red gradient on
``t = clamp(speed / max_speed, 0, 1)``; band boundaries are listed in the
JAX module's docstring.
"""

from __future__ import annotations

import torch


def _select(conds, values, default):
    """``jnp.select``: the first true condition picks its value."""
    out = default
    for c, v in zip(reversed(conds), reversed(values)):
        out = torch.where(c, v, out)
    return out


def colors_by_velocity(vel: torch.Tensor, max_speed: float) -> torch.Tensor:
    """Map ``(3, N)`` velocities to ``(3, N)`` float32 RGB in [0, 1]."""
    # sqrt in float64: some CPU builds of torch round the float32 sqrt
    # off by an ulp; the float64 root rounds to the exact float32 one.
    speed = torch.sqrt(torch.sum(vel * vel, dim=0).double()).float()
    t = torch.clamp(speed / max_speed, max=1.0)

    s0 = t / 0.15
    s1 = (t - 0.15) / 0.15
    sa = (t - 0.30) / 0.25
    s2 = sa / 0.6
    s3 = (sa - 0.6) / 0.4
    s4 = (t - 0.90) / 0.05
    s5 = (t - 0.95) / 0.04
    s6 = (t - 0.99) / 0.01

    conds = [t < 0.15, t < 0.30, t < 0.45, t < 0.55, t < 0.90, t < 0.95,
             t < 0.99]
    one = torch.ones_like(t)
    zero = torch.zeros_like(t)
    r = _select(conds, [0.4 - 0.2 * s0, 0.2 + 0.1 * s1, 0.3 - 0.1 * s2,
                        0.2 + 0.8 * s3, one, one, one], one)
    g = _select(conds, [0.2 + 0.2 * s0, 0.4 + 0.1 * s1, 0.5 + 0.3 * s2,
                        0.8 + 0.2 * s3, one, 1.0 - 0.05 * s4,
                        0.95 - 0.45 * s5], 0.5 - 0.5 * s6)
    b = _select(conds, [0.8 + 0.1 * s0, 0.9 + 0.05 * s1, 0.95 + 0.05 * s2,
                        one, one, 1.0 - s4, zero], zero)
    return torch.stack([r, g, b]).to(torch.float32)
