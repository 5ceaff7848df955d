"""Morton (Z-order) encoding of 3D positions (port of
``spatialsim_tpu/ops/morton.py``).

Positions are quantized onto a ``2^depth`` dyadic grid over the root cube
``[-half, half]^3`` and the three axis indices are bit-interleaved into one
int32 code (x -> bit 0, y -> bit 1, z -> bit 2), so every octree cell at
every level is one contiguous run of the Morton-sorted bodies.
"""

from __future__ import annotations

import torch


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``x`` so bit i lands at position 3*i."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_encode(pos: torch.Tensor, half, depth: int) -> torch.Tensor:
    """Morton codes for positions in the cube ``[-half, half]^3``.

    Args:
      pos: ``(3, N)`` float32 positions.
      half: 0-d tensor (or float), half-extent of the root cell.
      depth: bits per axis, 1..10 (30-bit codes fit int32).

    Returns:
      ``(N,)`` int32 codes; out-of-cube positions clamp to boundary cells.
    """
    if not (1 <= depth <= 10):
        raise ValueError("depth must be in [1, 10] for int32 codes")
    scale = (2 ** depth) / (2.0 * half)
    q = torch.floor((pos + half) * scale).to(torch.int32)
    q = q.clamp(0, 2 ** depth - 1)
    return _spread3(q[0]) | (_spread3(q[1]) << 1) | (_spread3(q[2]) << 2)
