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
* :func:`allpairs_plan` -- the kernel's instance for N bodies: threads a
  block, T targets a thread and S blocks over the source axis, whose
  partial sums a cluster adds in a fixed order.
  :func:`allpairs_sources` and :func:`allpairs_split_reference` model the
  kernel's split and summation order in plain float32 for the tests.
* :func:`allpairs_accel_at` -- the targets-and-sources mode: the same sum
  at ``k`` targets from ``N`` other sources (the direct-sum oracle of
  ``tools/oracle.py`` and a ring hop of ``parallel/sharded.py``), through
  the same source; :func:`allpairs_at_reference` is its plain version and
  :func:`allpairs_at_plan` its instance.
"""

from __future__ import annotations

import torch

from spatialsim_tpu_torch import _kernels

# Pairwise temporaries per chunk stay near 2^24 elements (64 MB each).
_PAIRS_PER_CHUNK = 1 << 24
# The kernel's instances: sources staged a tile, targets a thread, threads
# a block, and at most 8 source slices (a portable cluster).
ALLPAIRS_TILE = 256
ALLPAIRS_TARGETS = (2, 4, 8)
ALLPAIRS_THREADS = (64, 128)
MAX_SLICES = 8
# SMs of an H100 SXM: the plan's yardstick for filling the card.
_SMS = 132
# The targets-and-sources mode's grid: about 8 waves of 12 resident
# blocks an SM (128 threads, T=2), so the last wave's tail stays small.
_AT_BLOCKS = 8 * 12 * _SMS
_FAR = 1e18            # position of a padding source (zero mass)


def allpairs_accel_reference(pos: torch.Tensor, mass: torch.Tensor, G: float,
                             softening: float) -> torch.Tensor:
    """O(N^2) accelerations, ``(3, N)`` float32, in plain tensor ops: the
    targets-and-sources sum with the bodies as both."""
    return allpairs_at_reference(pos, pos, mass, G, softening)


def _check(name, t, shape, dtype):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def allpairs_plan(n: int) -> tuple:
    """``(threads, T, S)`` of the kernel for ``n`` bodies: 128 threads of
    2 targets (the fastest instance at 10,000-32,768 bodies on an H100),
    the source axis split into the fewest slices S, a power of two, that
    give the grid 8 blocks an SM, with S at most 8 and at most the number
    of source tiles."""
    tiles = -(-n // ALLPAIRS_TILE)
    threads, T = 128, 2
    blocks = -(-n // (threads * T))
    S = 1
    while S < MAX_SLICES and 2 * S <= tiles and blocks * S < 8 * _SMS:
        S *= 2
    return threads, T, S


def allpairs_sources(n: int, slices: int) -> torch.Tensor:
    """The sources the kernel's slices sum: ``(S, tiles_per_slice *
    TILE)`` int64 body ids, -1 for a padding source (zero mass).  Slice s
    takes tiles ``[s * per, (s + 1) * per)`` of the ``ceil(n / TILE)``
    tiles, ``per = ceil(tiles / S)``; a slice past the last tile is all
    padding."""
    tiles = -(-n // ALLPAIRS_TILE)
    per = -(-tiles // slices)
    ids = torch.arange(slices * per * ALLPAIRS_TILE, dtype=torch.int64)
    return torch.where(ids < n, ids, -1).reshape(slices, per * ALLPAIRS_TILE)


def allpairs_staged(pos: torch.Tensor, mass: torch.Tensor, G: float,
                    slices: int) -> torch.Tensor:
    """The sources as the kernel stages them: ``(4, S, P)`` float32 rows
    ``[x y z G*m]`` in slice order (:func:`allpairs_sources`), a padding
    source at 1e18 with zero mass."""
    ids = allpairs_sources(pos.shape[1], slices).to(pos.device)
    pad = ids < 0
    at = ids.clamp(min=0)
    return torch.cat([pos[:, at].masked_fill(pad, _FAR),
                      (G * mass)[at].masked_fill(pad, 0.0)[None]])


def allpairs_split_reference(pos: torch.Tensor, mass: torch.Tensor,
                             G: float, softening: float,
                             slices: int) -> torch.Tensor:
    """The kernel's summation order in plain float32: each tile of
    ``TILE`` staged sources (:func:`allpairs_staged`) summed into its own
    partial, the partials into the slice's total, tile by tile, then the
    slices' totals in slice order.  A model of the order for the CPU
    tests, not a path of the port."""
    soft_sq = float(softening) * float(softening)
    src = allpairs_staged(pos, mass, G, slices)
    total = None
    for s in range(slices):
        acc = torch.zeros_like(pos)
        for t0 in range(0, src.shape[2], ALLPAIRS_TILE):
            tile = src[:, s, t0:t0 + ALLPAIRS_TILE]
            d = tile[:3, None, :] - pos[:, :, None]             # (3, N, TILE)
            r2 = (d * d).sum(0) + soft_sq
            inv = torch.rsqrt(r2)
            w = torch.where(r2 > soft_sq, tile[3][None] * (inv * inv * inv),
                            torch.zeros_like(r2))
            acc = acc + (w[None] * d).sum(2)
        total = acc if total is None else total + acc
    return total


def allpairs_accel(pos: torch.Tensor, mass: torch.Tensor, G: float,
                   softening: float) -> torch.Tensor:
    """All-pairs accelerations through the CUDA kernel.

    Args:
      pos: ``(3, N)`` float32, contiguous.
      mass: ``(N,)`` float32, contiguous, on the same device.
    Returns:
      ``(3, N)`` float32 accelerations on ``pos.device``.

    CPU tensors take :func:`allpairs_accel_reference`.  CUDA tensors launch
    ``csrc/allpairs.cu`` (the instance :func:`allpairs_plan` picks) on the
    current stream without synchronising, and add one to
    ``allpairs_accel.launches``.
    """
    if pos.device.type == "cpu":
        return allpairs_accel_reference(pos, mass, G, softening)
    threads, T, S = allpairs_plan(pos.shape[1])
    return allpairs_launch(pos, mass, G, softening, threads=threads,
                           targets=T, slices=S)


def allpairs_launch(pos, mass, G, softening, *, threads, targets, slices):
    """Launch ``csrc/allpairs.cu`` with ``threads`` threads a block of
    ``targets`` (T) targets each and the sources split over ``slices``
    (S) blocks, on checked CUDA inputs; adds one to
    ``allpairs_accel.launches``."""
    if pos.device.type != "cuda" or mass.device != pos.device:
        raise ValueError(f"allpairs_accel: unsupported devices "
                         f"{pos.device}/{mass.device}")
    n = pos.shape[1]
    _check("pos", pos, (3, n), torch.float32)
    _check("mass", mass, (n,), torch.float32)
    if n == 0:
        raise ValueError("allpairs_accel: no bodies")
    if (threads not in ALLPAIRS_THREADS or targets not in ALLPAIRS_TARGETS
            or not 1 <= slices <= MAX_SLICES):
        raise ValueError(f"allpairs_accel: no instance threads={threads} "
                         f"T={targets} S={slices}")
    out = torch.empty_like(pos)
    err = _kernels.entry.spatialsim_allpairs(
        pos.data_ptr(), mass.data_ptr(), out.data_ptr(), n, float(G),
        float(softening) ** 2, int(threads), int(targets), int(slices),
        _kernels.stream(pos))
    if err:
        _kernels.fail(err, "allpairs")
    allpairs_accel.launches += 1
    return out


allpairs_accel.launches = 0


def allpairs_occupancy(threads, targets, slices):
    """(resident blocks per SM, registers a thread, threads a block) of one
    instance, as the card's occupancy calculator gives them (for blocks
    alone; a cluster also needs its S blocks on neighbouring SMs)."""
    import ctypes
    out = (ctypes.c_int * 3)()
    err = _kernels.entry.spatialsim_allpairs_occupancy(
        int(threads), int(targets), int(slices), ctypes.addressof(out))
    _kernels.check(err, "allpairs occupancy")
    return tuple(out)


def allpairs_at_reference(targets: torch.Tensor, pos: torch.Tensor,
                          mass: torch.Tensor, G: float,
                          softening: float) -> torch.Tensor:
    """Direct-sum accelerations at ``targets`` ``(3, k)`` from the sources
    ``pos`` ``(3, N)``, ``mass`` ``(N,)``, in plain tensor ops and the
    inputs' dtype: ``G m d / r^3``, ``r^2 = |d|^2 + eps^2``, a pair dropped
    where ``r^2 <= eps^2`` (the JAX scripts' ``exact_accel_at`` and the
    ring's hop sum), in chunks of targets so that no ``(3, k, N)`` tensor
    is whole."""
    soft_sq = float(softening) * float(softening)
    k, n = targets.shape[1], pos.shape[1]
    out = torch.empty_like(targets)
    rows = max(1, _PAIRS_PER_CHUNK // max(n, 1))
    gm = (G * mass)[None, :]
    for i0 in range(0, k, rows):
        d = pos[:, None, :] - targets[:, i0:i0 + rows, None]  # (3, c, N)
        dist_sq = (d * d).sum(0) + soft_sq
        inv = torch.rsqrt(dist_sq)
        w = torch.where(dist_sq > soft_sq, gm * inv * inv * inv,
                        torch.zeros_like(dist_sq))
        out[:, i0:i0 + rows] = (w[None] * d).sum(2)
    return out


def allpairs_at_plan(k: int, n: int) -> tuple:
    """``(threads, T, tiles a slice)`` of the targets-and-sources mode for
    ``k`` targets and ``n`` sources: 128 threads of 2 targets, and the
    source tiles cut into slices of the fewest tiles that give the grid
    about ``_AT_BLOCKS`` blocks."""
    threads, T = 128, 2
    tblocks = -(-k // (threads * T))
    tiles = -(-n // ALLPAIRS_TILE)
    return threads, T, max(1, -(-tiles * tblocks // _AT_BLOCKS))


def allpairs_at_slices(n: int, tiles_per_slice: int) -> int:
    """Slices of the source axis (the partials the mode's first pass
    writes) for ``n`` sources cut into slices of ``tiles_per_slice``
    tiles."""
    return -(-(-(-n // ALLPAIRS_TILE)) // tiles_per_slice)


def allpairs_accel_at(targets: torch.Tensor, pos: torch.Tensor,
                      mass: torch.Tensor, G: float,
                      softening: float) -> torch.Tensor:
    """Accelerations at ``targets`` from the sources ``pos``, ``mass``.

    Args:
      targets: ``(3, k)`` float32, contiguous.
      pos: ``(3, N)`` float32, contiguous; mass: ``(N,)`` float32.
    Returns:
      ``(3, k)`` float32 on ``targets.device``.

    CPU tensors take :func:`allpairs_at_reference`.  CUDA tensors launch
    ``csrc/allpairs.cu``'s targets-and-sources mode (the instance
    :func:`allpairs_at_plan` picks; two launches, the second adding the
    slices' partials in a fixed order) on the current stream without
    synchronising, and add one to ``allpairs_accel_at.launches``.
    """
    if targets.device.type == "cpu":
        return allpairs_at_reference(targets, pos, mass, G, softening)
    threads, T, per = allpairs_at_plan(targets.shape[1], pos.shape[1])
    return allpairs_at_launch(targets, pos, mass, G, softening,
                              threads=threads, targets_per_thread=T,
                              tiles_per_slice=per)


def allpairs_at_launch(targets, pos, mass, G, softening, *, threads,
                       targets_per_thread, tiles_per_slice):
    """Launch the targets-and-sources mode with ``threads`` threads a
    block of ``targets_per_thread`` (T) targets each and the source tiles
    cut into slices of ``tiles_per_slice``, on checked CUDA inputs; adds
    one to ``allpairs_accel_at.launches``."""
    dev = targets.device
    if dev.type != "cuda" or pos.device != dev or mass.device != dev:
        raise ValueError(f"allpairs_accel_at: unsupported devices "
                         f"{dev}/{pos.device}/{mass.device}")
    k, n = targets.shape[1], pos.shape[1]
    _check("targets", targets, (3, k), torch.float32)
    _check("pos", pos, (3, n), torch.float32)
    _check("mass", mass, (n,), torch.float32)
    if k == 0 or n == 0:
        raise ValueError("allpairs_accel_at: no targets or no sources")
    if (threads not in ALLPAIRS_THREADS
            or targets_per_thread not in ALLPAIRS_TARGETS
            or tiles_per_slice < 1):
        raise ValueError(f"allpairs_accel_at: no instance threads={threads} "
                         f"T={targets_per_thread} tiles a slice "
                         f"{tiles_per_slice}")
    part = torch.empty((allpairs_at_slices(n, tiles_per_slice), 3, k),
                       dtype=torch.float32, device=dev)
    out = torch.empty_like(targets)
    err = _kernels.entry.spatialsim_allpairs_at(
        targets.data_ptr(), pos.data_ptr(), mass.data_ptr(), part.data_ptr(),
        out.data_ptr(), k, n, float(G), float(softening) ** 2, int(threads),
        int(targets_per_thread), int(tiles_per_slice), _kernels.stream(pos))
    if err:
        _kernels.fail(err, "allpairs_at")
    allpairs_accel_at.launches += 1
    return out


allpairs_accel_at.launches = 0


def allpairs_at_occupancy(threads, targets):
    """(resident blocks per SM, registers a thread, threads a block) of
    the targets-and-sources mode's first pass."""
    import ctypes
    out = (ctypes.c_int * 3)()
    err = _kernels.entry.spatialsim_allpairs_at_occupancy(
        int(threads), int(targets), ctypes.addressof(out))
    _kernels.check(err, "allpairs_at occupancy")
    return tuple(out)
