"""Linear octree built bottom-up from Morton-sorted bodies (port of
``spatialsim_tpu/ops/octree.py``).

Bodies are Morton-sorted, so every cell at every level is a contiguous run.
The deepest level's cells are the unique codes (run boundaries give a dense
rank per body and segment sums give mass / COM / count); each coarser level
pools its children with the same trick on ``code >> 3``.

Every level has a fixed slot count (``min(8^d, N)`` or a calibrated tight
cap); empty slots carry the sentinel code ``INT32_MAX`` and zero mass.
Overflow never drops mass: tail cells merge into the cap's last slot, and a
parent whose child run touches that merged slot reports zero children, so
the traversal emits it as a coarse monopole instead of opening it.

With ``with_quadrupole`` every cell also carries its central second mass
moments ``m2`` (about its own COM): the deepest level from body offsets to
their cell's COM, each coarser level by the parallel-axis merge of its
children, so every product is of cell-sized (small) quantities.

Segment sums are ``index_add_`` into a buffer with one spare slot (the JAX
code's out-of-range "drop" ids land there and are sliced off).  On CUDA
they use atomics, so float sums vary in the last bits from run to run.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

SENTINEL = 2 ** 31 - 1


class OctreeLevel(NamedTuple):
    """Compacted cells of one octree level, sorted by Morton code."""

    code: torch.Tensor         # (C,) int32 Morton prefix of the cell
    mass: torch.Tensor         # (C,) f32 total mass
    com: torch.Tensor          # (3, C) f32 center of mass
    vel: torch.Tensor          # (3, C) f32 mass-weighted mean velocity
    count: torch.Tensor        # (C,) int64 number of bodies
    body_start: torch.Tensor   # (C,) int64 first body (sorted order)
    child_start: torch.Tensor  # (C,) int64 first child slot, next level
    child_count: torch.Tensor  # (C,) int64 children (0 at max depth)
    n_cells: torch.Tensor      # () int64 occupied slots
    acc: Optional[torch.Tensor] = None   # (3, C) mean acceleration
    # (6, C) central second moments sum m*d*d^T about the cell COM, rows
    # (xx, yy, zz, xy, xz, yz); None unless built with_quadrupole.
    m2: Optional[torch.Tensor] = None


class Octree(NamedTuple):
    levels: List[OctreeLevel]   # index 0 = coarsest built level
    start_level: int
    max_depth: int
    half: torch.Tensor          # () f32 root half-extent


def level_capacity(level: int, n: int) -> int:
    """Static slot count for one level: can't exceed 8^level or N."""
    return int(min(8 ** level, n))


def _ranks(codes: torch.Tensor):
    """Dense segment ids from sorted codes (0,0,1,2,2,...) plus count."""
    flags = torch.ones_like(codes, dtype=torch.int64)
    flags[1:] = (codes[1:] != codes[:-1]).to(torch.int64)
    rank = torch.cumsum(flags, 0) - 1
    return rank, rank[-1] + 1


def _segment(data: torch.Tensor, seg: torch.Tensor, num: int):
    """Segment sum along the last axis; ids >= num are dropped."""
    shape = data.shape[:-1] + (num + 1,)
    out = torch.zeros(shape, dtype=data.dtype, device=data.device)
    out.index_add_(data.dim() - 1, seg, data)
    return out[..., :num]


def _scatter_min(init_val, size: int, seg: torch.Tensor,
                 values: torch.Tensor):
    out = torch.full((size + 1,), init_val, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(0, seg, values, reduce="amin", include_self=True)
    return out[:size]


def _outer6(d: torch.Tensor) -> torch.Tensor:
    """Second-moment rows (xx, yy, zz, xy, xz, yz) of ``d`` (3, K)."""
    return torch.stack([d[0] * d[0], d[1] * d[1], d[2] * d[2],
                        d[0] * d[1], d[0] * d[2], d[1] * d[2]])


def build_octree(sorted_codes, sorted_pos, sorted_mass, half, *, max_depth,
                 start_level=2, n=None, sorted_vel=None, sorted_acc=None,
                 with_quadrupole=False, level_caps=()) -> Octree:
    """Build all levels from Morton-sorted bodies.

    Args:
      sorted_codes: ``(N,)`` int32 Morton codes, ascending.
      sorted_pos: ``(3, N)`` f32 positions in the same order.
      sorted_mass: ``(N,)`` f32 masses (padding bodies carry mass 0).
      half: 0-d root half-extent.
      max_depth: octree depth (= Morton bits per axis).
      start_level: coarsest level materialized.
      sorted_vel / sorted_acc: optional ``(3, N)``; cells then carry their
        mass-weighted mean velocity / acceleration.
      with_quadrupole: cells also carry ``m2`` (see the module docstring).
      level_caps: optional per-level slot counts, index
        ``level - start_level`` (see the module docstring for overflow).

    Returns:
      :class:`Octree` with ``max_depth - start_level + 1`` levels.
    """
    if n is None:
        n = sorted_codes.shape[0]
    dev = sorted_pos.device
    if sorted_vel is None:
        sorted_vel = torch.zeros_like(sorted_pos)
    if level_caps:
        assert len(level_caps) == max_depth - start_level + 1

    def cap_of(level):
        full = level_capacity(level, n)
        if not level_caps:
            return full
        return min(int(level_caps[level - start_level]), full)

    # --- deepest level from bodies ---
    seg, n_cells = _ranks(sorted_codes)
    cap = cap_of(max_depth)
    raw_cells = n_cells
    seg = seg.clamp(max=cap - 1)
    n_cells = n_cells.clamp(max=cap)
    mass = _segment(sorted_mass, seg, cap)
    wpos = _segment(sorted_pos * sorted_mass[None, :], seg, cap)
    wvel = _segment(sorted_vel * sorted_mass[None, :], seg, cap)
    wacc = (None if sorted_acc is None else
            _segment(sorted_acc * sorted_mass[None, :], seg, cap))
    count = _segment(torch.ones_like(seg), seg, cap)
    code = _scatter_min(SENTINEL, cap, seg, sorted_codes)
    body_start = _scatter_min(n, cap, seg,
                              torch.arange(n, dtype=torch.int64, device=dev))
    inv_m = 1.0 / torch.clamp(mass, min=1e-30)[None, :]
    com = wpos * inv_m
    m2 = None
    if with_quadrupole:
        # Offsets from the body's own cell COM are cell-sized, so the
        # products keep full f32 precision.
        d = sorted_pos - com[:, seg]
        m2 = _segment(_outer6(d) * sorted_mass[None, :], seg, cap)
    zeros = torch.zeros((cap,), dtype=torch.int64, device=dev)
    deepest = OctreeLevel(
        code=code, mass=mass, com=com, vel=wvel * inv_m,
        count=count, body_start=body_start, child_start=zeros,
        child_count=zeros, n_cells=n_cells,
        acc=None if wacc is None else wacc * inv_m, m2=m2)

    # --- pool upward ---
    levels = [deepest]
    child = deepest
    for level in range(max_depth - 1, start_level - 1, -1):
        ccap = child.code.shape[0]
        child_overflow = raw_cells > ccap
        pcap = cap_of(level)
        invalid = child.code == SENTINEL
        parent_code = torch.where(invalid, child.code, child.code >> 3)
        pseg, pn = _ranks(parent_code)
        raw_cells = pn - invalid.any().to(torch.int64)
        pseg = pseg.clamp(max=pcap - 1)
        # Empty child slots all share the SENTINEL "segment"; kick them out
        # of range so the segment ops drop them.
        pseg = torch.where(invalid, torch.full_like(pseg, pcap), pseg)
        pn = raw_cells.clamp(max=pcap)

        pmass = _segment(child.mass, pseg, pcap)
        pwpos = _segment(child.com * child.mass[None, :], pseg, pcap)
        pwvel = _segment(child.vel * child.mass[None, :], pseg, pcap)
        pwacc = (None if child.acc is None else
                 _segment(child.acc * child.mass[None, :], pseg, pcap))
        pcount = _segment(child.count, pseg, pcap)
        pcode = _scatter_min(SENTINEL, pcap, pseg, parent_code)
        pbody = _scatter_min(n, pcap, pseg, child.body_start)
        cstart = _scatter_min(
            ccap, pcap, pseg,
            torch.arange(ccap, dtype=torch.int64, device=dev))
        ccount = _segment(torch.ones_like(pseg), pseg, pcap)
        # Child-level overflow: the cap's last slot holds MERGED tail
        # cells; a parent whose child run touches it must not be opened.
        ccount = torch.where(child_overflow & (cstart + ccount > ccap - 1),
                             torch.zeros_like(ccount), ccount)
        pinv_m = 1.0 / torch.clamp(pmass, min=1e-30)[None, :]
        pcom = pwpos * pinv_m
        pm2 = None
        if with_quadrupole:
            # Parallel-axis merge: M2_p = sum_c [M2_c + m_c (com_c -
            # com_p)(com_c - com_p)^T], every operand COM-relative.
            d = child.com - pcom[:, pseg.clamp(0, pcap - 1)]
            pm2 = _segment(child.m2 + _outer6(d) * child.mass[None, :],
                           pseg, pcap)
        parent = OctreeLevel(
            code=pcode, mass=pmass, com=pcom, vel=pwvel * pinv_m,
            count=pcount, body_start=pbody, child_start=cstart,
            child_count=ccount, n_cells=pn,
            acc=None if pwacc is None else pwacc * pinv_m, m2=pm2)
        levels.append(parent)
        child = parent

    levels.reverse()
    return Octree(levels=levels, start_level=start_level,
                  max_depth=max_depth,
                  half=torch.as_tensor(half, dtype=torch.float32, device=dev))
