"""Dynamic simulation bounds (port of ``spatialsim_tpu/ops/bounds.py``).

The octree root extent is ``max(|coord|) * 1.1 + 10``, recomputed at every
build because bodies are unbounded.
"""

from __future__ import annotations

import torch


def compute_bounds(pos: torch.Tensor) -> torch.Tensor:
    """Half-extent of the root cube centred at the origin.

    Args:
      pos: ``(3, N)`` positions.
    Returns:
      0-d float32 tensor on ``pos.device``.
    """
    return pos.abs().amax() * 1.1 + 10.0
