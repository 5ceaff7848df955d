"""Tiled all-pairs gravitational forces (port of
``spatialsim_tpu/ops/allpairs.py``).

Per pair, as in the JAX package (and the reference's accept branch)::

    d        = p_j - p_i
    dist_sq  = |d|^2 + softening^2
    a_i     += G * m_j * d / dist_sq^(3/2)      if dist_sq > softening^2

* :func:`allpairs_accel_reference` -- plain PyTorch, chunked over targets;
  the oracle for tests and ``chip_smoke.py``, and the CPU path.
* :func:`allpairs_accel` -- the wrapper of the hand-written CUDA kernel
  ``csrc/allpairs.cu``.  A CUDA tensor launches the kernel (or raises); a
  CPU tensor takes the plain version.
"""

from __future__ import annotations

import torch

from spatialsim_tpu_torch import _kernels

# Pairwise temporaries per chunk stay near 2^24 elements (64 MB each).
_PAIRS_PER_CHUNK = 1 << 24


def allpairs_accel_reference(pos: torch.Tensor, mass: torch.Tensor, G: float,
                             softening: float) -> torch.Tensor:
    """O(N^2) accelerations, ``(3, N)`` float32, in plain tensor ops."""
    soft_sq = float(softening) * float(softening)
    n = pos.shape[1]
    out = torch.empty_like(pos)
    rows = max(1, _PAIRS_PER_CHUNK // max(n, 1))
    for i0 in range(0, n, rows):
        tgt = pos[:, i0:i0 + rows]
        d = pos[:, None, :] - tgt[:, :, None]              # (3, c, N)
        dist_sq = (d * d).sum(dim=0) + soft_sq
        inv_d3 = torch.rsqrt(dist_sq) / dist_sq
        w = torch.where(dist_sq > soft_sq, G * mass[None, :] * inv_d3,
                        torch.zeros_like(dist_sq))
        out[:, i0:i0 + rows] = (w[None] * d).sum(dim=2)
    return out


def _check(name, t, shape, dtype):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def allpairs_accel(pos: torch.Tensor, mass: torch.Tensor, G: float,
                   softening: float) -> torch.Tensor:
    """All-pairs accelerations through the CUDA kernel.

    Args:
      pos: ``(3, N)`` float32, contiguous.
      mass: ``(N,)`` float32, contiguous, on the same device.
    Returns:
      ``(3, N)`` float32 accelerations on ``pos.device``.

    CPU tensors take :func:`allpairs_accel_reference`.  CUDA tensors launch
    ``csrc/allpairs.cu`` on the current stream without synchronising, and
    add one to ``allpairs_accel.launches``.
    """
    if pos.device.type == "cpu":
        return allpairs_accel_reference(pos, mass, G, softening)
    if pos.device.type != "cuda" or mass.device != pos.device:
        raise ValueError(f"allpairs_accel: unsupported devices "
                         f"{pos.device}/{mass.device}")
    n = pos.shape[1]
    _check("pos", pos, (3, n), torch.float32)
    _check("mass", mass, (n,), torch.float32)
    if n == 0:
        raise ValueError("allpairs_accel: no bodies")
    out = torch.empty_like(pos)
    lib = _kernels.library()
    err = lib.spatialsim_allpairs(
        pos.data_ptr(), mass.data_ptr(), out.data_ptr(), n, float(G),
        float(softening) ** 2, _kernels.stream_ptr(pos.device))
    _kernels.check(err, "allpairs")
    allpairs_accel.launches += 1
    return out


allpairs_accel.launches = 0
