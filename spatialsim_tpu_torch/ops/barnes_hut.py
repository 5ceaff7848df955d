"""Barnes-Hut accelerations by group-synchronous octree traversal: the
exact per-step engine (``engine="exact"``), port of
``spatialsim_tpu/ops/barnes_hut.py``.

Bodies are Morton-sorted and cut into groups of ``group_size``; one
level-synchronous walk per group replaces a walk per body.  A frontier of
at most ``frontier_cap`` cells descends one octree level per iteration,
and each cell is, in this order:

1. accepted (``side < theta * d_min``, ``d_min`` from the group's bounding
   box to the cell's centre of mass, softened): a monopole;
2. a leaf (``count <= leaf_size``): its bodies go on the group's near list
   of ``near_ranges`` body ranges, summed exactly at the end;
3. opened: its children join the next level's frontier.

A full near list or frontier degrades the cell to a forced monopole, never
a silent drop.  Force law as the all-pairs kernel: ``G m d / r^3`` with
``r^2 = |d|^2 + eps^2``, gated on ``m > 0`` and ``r^2 > eps^2``.

Plain PyTorch ops (the JAX module has no Pallas kernel): the groups of a
chunk of ``group_chunk`` walk together as one batch dimension, which
takes the place of JAX's ``vmap``, and JAX's out-of-range "drop"
scatters write to one spare slot past the end.
"""

from __future__ import annotations

import torch

from spatialsim_tpu_torch.ops.bounds import compute_bounds
from spatialsim_tpu_torch.ops.morton import morton_encode
from spatialsim_tpu_torch.ops.octree import build_octree


def _excl(x):
    """Exclusive cumulative sum along the last axis."""
    return torch.cumsum(x, -1) - x


def _pair_accel(gpos, src_pos, src_mass, active, G, soft_sq):
    """Masked sums of sources ``(C, 3, S)`` with masses and mask ``(C, S)``
    onto group bodies ``(C, 3, Gs)``; returns ``(C, 3, Gs)``."""
    d = [src_pos[:, r, None, :] - gpos[:, r, :, None] for r in range(3)]
    dist_sq = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2] + soft_sq
    inv = torch.rsqrt(dist_sq)
    w = torch.where(active[:, None, :] & (dist_sq > soft_sq),
                    (G * src_mass)[:, None, :] * inv * inv * inv,
                    torch.zeros_like(dist_sq))
    return torch.stack([(w * d[r]).sum(2) for r in range(3)], dim=1)


def _traverse_groups(gpos, bbox_min, bbox_max, tree, sorted_pos,
                     sorted_mass, *, theta, G, soft_sq, leaf_size,
                     frontier_cap, near_ranges, n):
    """Accelerations ``(C, 3, Gs)`` for a chunk of groups: ``gpos`` ``(C,
    3, Gs)``, ``bbox_min``/``bbox_max`` ``(C, 3)``."""
    levels = tree.levels
    C = gpos.shape[0]
    F, R = frontier_cap, near_ranges
    dev = gpos.device
    i64 = torch.int64

    acc = torch.zeros_like(gpos)
    c0 = levels[0].code.shape[0]
    init = torch.arange(F, dtype=i64, device=dev)
    n0 = torch.clamp(levels[0].n_cells, max=c0)
    frontier = torch.where(init < n0, init,
                           torch.full_like(init, -1)).expand(C, F)
    # Slot R (F) of each list takes the dropped writes.
    near_start = torch.zeros((C, R + 1), dtype=i64, device=dev)
    near_count = torch.zeros((C, R + 1), dtype=i64, device=dev)
    near_n = torch.zeros((C, 1), dtype=i64, device=dev)
    theta_sq = theta * theta

    for li, lv in enumerate(levels):
        level = tree.start_level + li
        side = 2.0 * tree.half / (2 ** level)
        last = li == len(levels) - 1

        valid = frontier >= 0
        idx = frontier.clamp(0, lv.code.shape[0] - 1)
        cmass = torch.where(valid, lv.mass[idx], torch.zeros((), device=dev))
        ccom = lv.com[:, idx].permute(1, 0, 2)                   # (C, 3, F)
        ccount = torch.where(valid, lv.count[idx], torch.zeros_like(idx))

        gap = torch.clamp(torch.maximum(bbox_min[:, :, None] - ccom,
                                        ccom - bbox_max[:, :, None]),
                          min=0.0)
        dmin_sq = ((gap[:, 0] * gap[:, 0] + gap[:, 1] * gap[:, 1])
                   + gap[:, 2] * gap[:, 2]) + soft_sq
        accept = valid & (side * side < theta_sq * dmin_sq)

        leafish = valid & ~accept & (ccount <= leaf_size)
        if last:
            # Nothing deeper: whatever is still open becomes a monopole.
            accept = accept | (valid & ~accept & (ccount > leaf_size))
            open_ = torch.zeros_like(valid)
        else:
            open_ = valid & ~accept & ~leafish

        # Near-list append; overflow degrades to a monopole.
        npos = near_n + _excl(leafish.to(i64))
        near_ovf = leafish & (npos >= R)
        accept = accept | near_ovf
        take = leafish & ~near_ovf
        slot = torch.where(take, npos, torch.full_like(npos, R))
        near_start.scatter_(1, slot, torch.where(
            valid, lv.body_start[idx], torch.zeros_like(idx)))
        near_count.scatter_(1, slot, ccount)
        near_n = near_n + take.sum(1, keepdim=True)

        if not last:
            # Children of the cells kept open; a cell whose children would
            # overflow the next frontier degrades to a monopole instead.
            cc = torch.where(open_, lv.child_count[idx], torch.zeros_like(idx))
            offs = _excl(cc)
            ovf = open_ & (offs + cc > F)
            accept = accept | ovf
            open_ = open_ & ~ovf
            cc = torch.where(open_, cc, torch.zeros_like(cc))
            offs = _excl(cc)
            cs = torch.where(open_, lv.child_start[idx], torch.zeros_like(idx))
            j = torch.arange(8, dtype=i64, device=dev)
            cand = (cs[:, :, None] + j).reshape(C, -1)
            tpos = (offs[:, :, None] + j).reshape(C, -1)
            cvalid = (j < cc[:, :, None]).reshape(C, -1)
            tpos = torch.where(cvalid, tpos, torch.full_like(tpos, F))
            nxt = torch.full((C, F + 1), -1, dtype=i64, device=dev)
            frontier = nxt.scatter_(1, tpos, cand)[:, :F]

        # Far field: this level's accepted cells as monopoles.
        acc = acc + _pair_accel(gpos, ccom, cmass, accept & (cmass > 0), G,
                                soft_sq)

    # Near field: the listed body ranges, summed exactly.
    k = torch.arange(leaf_size, dtype=i64, device=dev)
    bidx = near_start[:, :R, None] + k                         # (C, R, leaf)
    nvalid = (k < near_count[:, :R, None]).reshape(C, -1)
    bidx = bidx.reshape(C, -1).clamp(0, n - 1)
    bpos = sorted_pos[:, bidx].permute(1, 0, 2)                 # (C, 3, S)
    bmass = torch.where(nvalid, sorted_mass[bidx],
                        torch.zeros((), device=dev))
    return acc + _pair_accel(gpos, bpos, bmass, nvalid & (bmass > 0), G,
                             soft_sq)


def sorted_tree(pos, mass, *, max_depth, group_size, start_level=2,
                frontier_cap=512, npad=None):
    """Morton sort + octree of the exact engine: ``(order, sorted_pos,
    sorted_mass, tree)``.  The sorted stream is padded to ``npad`` slots
    (whole groups by default) with zero-mass clones of the last body,
    which join its cell and exert no force."""
    n = pos.shape[1]
    half = compute_bounds(pos)
    codes = morton_encode(pos, half, max_depth)
    order = torch.argsort(codes, stable=True)
    gsz = group_size
    npad = npad or ((n + gsz - 1) // gsz) * gsz
    pad = npad - n
    sorted_codes = torch.cat([codes[order], codes[order[-1:]].expand(pad)])
    sorted_pos = torch.cat([pos[:, order],
                            pos[:, order[-1:]].expand(3, pad)], dim=1)
    sorted_mass = torch.cat([mass[order], mass.new_zeros(pad)])
    if 8 ** start_level > frontier_cap:
        raise ValueError("start_level cells exceed frontier capacity")
    tree = build_octree(sorted_codes, sorted_pos, sorted_mass, half,
                        max_depth=max_depth, start_level=start_level, n=npad)
    return order, sorted_pos, sorted_mass, tree


def traverse_range(sorted_pos, sorted_mass, tree, g0, g1, *, theta, G,
                   softening, leaf_size, group_size, frontier_cap,
                   near_ranges, group_chunk=64):
    """Sorted-order accelerations ``(3, (g1 - g0) * group_size)`` of the
    groups ``g0 .. g1`` of the sorted stream, walked ``group_chunk``
    groups at a time."""
    gsz = group_size
    npad = sorted_pos.shape[1]
    gpos = sorted_pos[:, g0 * gsz:g1 * gsz].reshape(3, g1 - g0, gsz)
    gpos = gpos.permute(1, 0, 2)                              # (ng, 3, gsz)
    bbox_min = gpos.amin(dim=2)                                  # (ng, 3)
    bbox_max = gpos.amax(dim=2)
    acc = torch.empty_like(gpos)
    for c0 in range(0, g1 - g0, group_chunk):
        c1 = min(g1 - g0, c0 + group_chunk)
        acc[c0:c1] = _traverse_groups(
            gpos[c0:c1], bbox_min[c0:c1], bbox_max[c0:c1], tree, sorted_pos,
            sorted_mass, theta=float(theta), G=float(G),
            soft_sq=float(softening) * float(softening),
            leaf_size=leaf_size, frontier_cap=frontier_cap,
            near_ranges=near_ranges, n=npad)
    return acc.permute(1, 0, 2).reshape(3, (g1 - g0) * gsz)


def barnes_hut_accel_impl(pos, mass, *, theta, G, softening, max_depth=10,
                          leaf_size=8, group_size=256, frontier_cap=512,
                          near_ranges=256, start_level=2, group_chunk=64):
    """Barnes-Hut accelerations at ``(3, N)`` f32 positions and ``(N,)``
    masses; returns ``(3, N)`` f32 in the caller's body order."""
    n = pos.shape[1]
    order, sorted_pos, sorted_mass, tree = sorted_tree(
        pos, mass, max_depth=max_depth, group_size=group_size,
        start_level=start_level, frontier_cap=frontier_cap)
    acc_sorted = traverse_range(
        sorted_pos, sorted_mass, tree, 0, sorted_pos.shape[1] // group_size,
        theta=theta, G=G, softening=softening, leaf_size=leaf_size,
        group_size=group_size, frontier_cap=frontier_cap,
        near_ranges=near_ranges, group_chunk=group_chunk)

    # Back to the caller's body order.
    out = torch.empty((3, n), dtype=pos.dtype, device=pos.device)
    out[:, order] = acc_sorted[:, :n]
    return out


def barnes_hut_accel(pos, mass, config):
    """Config-driven wrapper used by the model layer."""
    from spatialsim_tpu_torch.config.nbody import resolve_config
    config = resolve_config(config, pos.shape[1])
    return barnes_hut_accel_impl(
        pos, mass, theta=config.theta, G=config.G,
        softening=config.softening, max_depth=config.max_depth,
        leaf_size=config.leaf_size, group_size=config.group_size,
        frontier_cap=config.frontier_capacity,
        near_ranges=config.near_capacity // config.leaf_size,
        start_level=2)
