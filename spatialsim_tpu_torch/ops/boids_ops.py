"""Boids flocking ops (port of ``spatialsim_tpu/ops/boids_ops.py``).

Two neighbour searches, as in the JAX package:

* **window mode** (above ``window_threshold`` boids, the production path):
  boids sorted by the Morton code of their grid cell; each group of
  ``group_size`` sorted boids pairs densely with the ``2*window_groups+1``
  groups around it, in two passes (the second over a diagonally shifted
  code, its pairs already seen by pass one left out).  The per-pass
  accumulation is the hand-written CUDA kernel ``csrc/boids_window.cu``
  (:func:`spatialsim_tpu_torch.ops.boids_window_kernel.
  boids_window_accumulate`); :func:`window_accumulate_reference` is its
  plain version, the XLA k-shift form of the JAX package in PyTorch.
* **grid mode** (:func:`flocking_forces`): the exact 27-cell hash, sorted
  cell ids located with ``torch.searchsorted`` and a fixed
  ``cell_capacity`` gather per cell.  Plain PyTorch: it holds no kernel,
  and it is the exact oracle for the window path.

Semantics, shared by both: neighbour predicate ``1e-4 < d^2 <
perception^2`` with ``d = target - source``; separation ``sum d / d^2``
inside the separation radius; steering ``normalize(acc) * max_speed -
vel`` clamped to ``max_force`` and weighted, once over the merged
accumulators; wall springs, speed clamp and colour blend in
:func:`boids_physics`.

One deliberate difference from the JAX package: cohesion accumulates
the neighbours' offsets ``sum (p_s - p_t) = -sum d`` instead of their
positions ``sum p_s`` (from which the JAX package subtracts ``count *
p_t`` at the end).  At the default box (|p| up to 500, one float32 ulp
3e-5) that subtraction cancels: the cohesion direction of a boid whose
neighbours sit ~2 units away carries ~1e-5 relative error, so two
float32 evaluations of the same pairs in another order (window and
grid) disagree by ~1e-3 in force.  The offset form is exact to a few
ulps of the offset itself, the same mathematics.

Every sort is stable (``jnp.argsort`` is): at 500K boids in 202^3 cells
many boids share a code, and an unstable sort would change the group
membership, and with it the window's pair set.
"""

from __future__ import annotations

import torch

from spatialsim_tpu_torch.ops.boids_window_kernel import (
    ACC_ROWS, boids_window_accumulate)
from spatialsim_tpu_torch.ops.morton import _spread3

# Pairwise temporaries per chunk stay near 2^24 elements (64 MB each).
_PAIRS_PER_CHUNK = 1 << 24


def cell_coords(pos, cell_size, grid_dim, offset):
    """Clamped integer cell coordinates, ``(3, N)`` int32."""
    c = torch.floor((pos + offset) / cell_size).to(torch.int32)
    return c.clamp(0, grid_dim - 1)


def cell_index(pos, cell_size, grid_dim, offset):
    c = cell_coords(pos, cell_size, grid_dim, offset)
    return c[0] + c[1] * grid_dim + c[2] * grid_dim * grid_dim


def boids_codes(pos, *, cell_size, grid_dim, offset, second=False):
    """Morton codes of the (clamped) grid cells; ``second`` applies the
    diagonal 3/7 shift of the dedup'd second window pass."""
    c = cell_coords(pos, cell_size, grid_dim, offset)
    if second:
        c = c + max(1, (grid_dim * 3) // 7)
    return _spread3(c[0]) | (_spread3(c[1]) << 1) | (_spread3(c[2]) << 2)


def _argsort(code):
    return torch.sort(code, stable=True).indices


def _inverse(perm):
    """Inverse of a permutation of ``arange(n)`` (int64)."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    return inv


def _npad(n, gsz):
    return ((n + gsz - 1) // gsz) * gsz


def build_boids_orders(pos, *, cell_size, grid_dim, offset, group_size):
    """Frozen order pair for the production stepper, RELATIVE to the input
    layout.

    Returns int64 ``(o1, p21_pad, s21)``: ``o1`` (n,) sorts the input by
    the pass-1 Morton code; ``p21_pad`` (npad,) maps each pass-2 slot to
    its pass-1 slot (tail padded with duplicates of the last, neutralized
    by the caller); ``s21`` (n,) is the inverse (pass-1 slot -> pass-2
    slot).
    """
    n = pos.shape[1]
    npad = _npad(n, group_size)
    kw = dict(cell_size=cell_size, grid_dim=grid_dim, offset=offset)
    o1 = _argsort(boids_codes(pos, **kw))
    o2 = _argsort(boids_codes(pos, second=True, **kw)[o1])
    p21_pad = torch.cat([o2, o2[-1:].expand(npad - n)])
    return o1, p21_pad, _inverse(o2)


def window_accumulate_reference(s_pos, s_vel, s_col, s_grpf=None, *, gsz,
                                wg, perception_sq, separation_sq,
                                prev_wg=None, halo9=None, halo_grpf=None):
    """Morton-window neighbour accumulators over SORTED padded inputs, in
    plain tensor ops (the plain version of ``csrc/boids_window.cu``).

    Args:
      s_pos, s_vel, s_col: ``(3, npad)`` f32 in this pass's sorted layout,
        ``npad`` a multiple of ``gsz``; padding slots sit at 1e9.
      s_grpf: ``(npad,)`` f32 previous pass's group id per slot (padding
        at -1e9), or None for a first pass.  Pairs with ``|grp_t - grp_s|
        <= prev_wg`` (default ``wg``) were already counted and are left
        out.
      halo9: optional ``(left, right)`` pair of ``(9, wg * gsz)`` rows
        ``[vel3, pos3, col3]``: the sorted slots just outside these (the
        sharded step's neighbour halos, or the far-away fill).  Without it
        the window is padded with far-away slots, the unsharded semantics.
      halo_grpf: the matching ``(wg * gsz,)`` pair for ``s_grpf`` (without
        it, far-away ids).
    Returns:
      ``(14, npad)`` f32 rows ``[sep3, align3, coh3, csum3, sep_count,
      nb_count]`` in the same sorted layout, ``coh3`` the summed offsets
      ``p_s - p_t``.

    The JAX package's XLA form: for each window offset k the target block
    pairs with the k-shifted block view of the flat array (window slots
    beyond either end sit at 2e9); the velocity and colour sums are
    batched matmuls, and separation decomposes exactly as ``sum_j w (p_i -
    p_j) = (p_i - c) * rowsum(w) - w @ (p_j - c)`` with ``c`` the group's
    first slot, which keeps the matmul operands at window-extent
    magnitude.  The cohesion offsets are summed from the pair differences
    themselves.  Chunks of groups bound the pairwise temporaries.
    """
    npad = s_pos.shape[1]
    ng = npad // gsz
    pw = wg * gsz
    dedup = s_grpf is not None
    wg_f = float(prev_wg if prev_wg is not None else wg)
    pad = torch.nn.functional.pad
    # Rows [vel3; pos3; col3], window-padded by wg groups each side.
    if halo9 is not None:
        for h in halo9:
            if tuple(h.shape) != (9, pw):
                raise ValueError(f"halo9: expected (9, {pw}) halves, got "
                                 f"{tuple(h.shape)}")
        S9 = torch.cat([halo9[0], torch.cat([s_vel, s_pos, s_col]),
                        halo9[1]], dim=1)
    else:
        S9 = torch.cat([pad(s_vel, (pw, pw)),
                        pad(s_pos, (pw, pw), value=2e9),
                        pad(s_col, (pw, pw))], dim=0)
    if dedup:
        G = (pad(s_grpf, (pw, pw), value=1e9) if halo_grpf is None else
             torch.cat([halo_grpf[0], s_grpf, halo_grpf[1]]))
    gpos = s_pos.reshape(3, ng, gsz)
    out = s_pos.new_empty((ACC_ROWS, ng, gsz))
    chunk = max(1, _PAIRS_PER_CHUNK // (gsz * gsz))
    for g0 in range(0, ng, chunk):
        g1 = min(ng, g0 + chunk)
        gc = g1 - g0
        tp = gpos[:, g0:g1]                             # (3, gc, gsz)
        centre = tp[:, :, :1]
        acc6 = s_pos.new_zeros((gc, gsz, 6))            # [align; csum]
        coh = s_pos.new_zeros((3, gc, gsz))             # sum (p_j - p_i)
        sepj = s_pos.new_zeros((gc, gsz, 3))            # sum_j w (p_j - c)
        sep_row = s_pos.new_zeros((gc, gsz))            # rowsum(w)
        sep_count = s_pos.new_zeros((gc, gsz))
        nb_count = s_pos.new_zeros((gc, gsz))
        if dedup:
            tg = s_grpf.reshape(ng, gsz)[g0:g1]
        for k in range(2 * wg + 1):
            lo = g0 * gsz + k * gsz
            w9 = S9[:, lo:lo + gc * gsz].reshape(9, gc, gsz)
            wp = w9[3:6]
            w6 = torch.cat([w9[0:3], w9[6:9]])
            d = tp[:, :, :, None] - wp[:, :, None, :]   # (3, gc, gsz, gsz)
            dist_sq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            is_nb = (dist_sq < perception_sq) & (dist_sq > 0.0001)
            if dedup:
                wgp = G[lo:lo + gc * gsz].reshape(gc, gsz)
                seen = (tg[:, :, None] - wgp[:, None, :]).abs() <= wg_f
                is_nb = is_nb & ~seen
            is_sep = is_nb & (dist_sq < separation_sq)
            inv_dist = torch.rsqrt(dist_sq.clamp_min(1e-12))
            wsep = torch.where(is_sep, inv_dist * inv_dist,
                               torch.zeros_like(dist_sq))
            nbf = is_nb.to(s_pos.dtype)
            acc6 += torch.bmm(nbf, w6.permute(1, 2, 0))
            coh -= (d * nbf).sum(dim=3)
            sepj += torch.bmm(wsep, (wp - centre).permute(1, 2, 0))
            sep_row += wsep.sum(dim=2)
            sep_count += is_sep.sum(dim=2)
            nb_count += is_nb.sum(dim=2)
        sep = (tp - centre) * sep_row[None] - sepj.permute(2, 0, 1)
        out[0:3, g0:g1] = sep
        out[3:6, g0:g1] = acc6[:, :, 0:3].permute(2, 0, 1)
        out[6:9, g0:g1] = coh
        out[9:12, g0:g1] = acc6[:, :, 3:6].permute(2, 0, 1)
        out[12, g0:g1] = sep_count
        out[13, g0:g1] = nb_count
    return out.reshape(ACC_ROWS, npad)


def _window_pass(pos, vel, col, grp_prev, code, *, n, gsz, wg,
                 perception_sq, separation_sq, prev_wg=None):
    """One Morton-window pass over ORIGINAL-order inputs (stateless API).

    Sorts by ``code``, accumulates, and unsorts the raw accumulators back
    to original boid order.  Returns ``((14, n) rows, grp)`` with ``grp``
    this pass's group id per boid (for the second pass's exact dedup).
    The production stepper keeps its state sorted with frozen orders
    instead (:func:`flocking_forces_window_frozen`); this remains the
    oracle the capture tests measure.
    """
    order = _argsort(code)
    npad = _npad(n, gsz)
    order_pad = torch.cat([order, order[-1:].expand(npad - n)])
    # One packed gather for all 9 state rows.
    S = torch.cat([pos, vel, col], dim=0)[:, order_pad]
    real = torch.arange(npad, device=pos.device) < n
    s_pos = torch.where(real, S[0:3], 1e9)
    grp = torch.empty_like(order)
    grp[order] = torch.arange(n, device=pos.device) // gsz
    s_grpf = None
    if grp_prev is not None:
        s_grpf = torch.where(real, grp_prev[order_pad].to(pos.dtype), -1e9)
    rows = boids_window_accumulate(
        s_pos, S[3:6], S[6:9], s_grpf, gsz=gsz, wg=wg,
        perception_sq=perception_sq, separation_sq=separation_sq,
        prev_wg=prev_wg)
    # Unsort all 14 accumulator rows in one packed gather.
    return rows[:, _inverse(order)], grp


def _steer(acc, vel, active, weight, max_speed, max_force):
    mag = torch.sqrt((acc * acc).sum(dim=0))
    unit = acc / mag.clamp_min(1e-12)
    s = unit * max_speed - vel
    smag = torch.sqrt((s * s).sum(dim=0))
    s = torch.where(smag > max_force,
                    s * (max_force / smag.clamp_min(1e-12)), s)
    return torch.where(active & (mag > 0), s * weight, torch.zeros_like(s))


def _merge_and_steer(acc, pos, vel, col, separation_weight, alignment_weight,
                     cohesion_weight, max_speed, max_force):
    """Merged ``(14, n)`` raw accumulators -> (force, avg_col).

    Each behaviour normalizes its accumulator, scales to max_speed,
    subtracts velocity, clamps to max_force and applies its weight, once
    over the merged accumulators, so multi-pass capture never
    double-steers.
    """
    sep, align, coh, csum = acc[0:3], acc[3:6], acc[6:9], acc[9:12]
    sep_count, nb_count = acc[12], acc[13]
    st = dict(max_speed=max_speed, max_force=max_force)
    f_sep = _steer(sep / sep_count.clamp_min(1.0), vel, sep_count > 0,
                   separation_weight, **st)
    ncnt = nb_count.clamp_min(1.0)
    f_align = _steer(align / ncnt, vel, nb_count > 0, alignment_weight, **st)
    f_coh = _steer(coh / ncnt, vel, nb_count > 0, cohesion_weight, **st)
    avg_col = torch.where(nb_count > 0, (csum + col) / (ncnt + 1.0), col)
    return f_sep + f_align + f_coh, avg_col


def _steer_kw(kw):
    return {k: kw[k] for k in ("separation_weight", "alignment_weight",
                               "cohesion_weight", "max_speed", "max_force")}


def flocking_forces_window(pos, vel, col, *, cell_size, grid_dim, offset,
                           perception_radius, separation_radius,
                           separation_weight, alignment_weight,
                           cohesion_weight, max_speed, max_force,
                           group_size=256, window_groups=2,
                           pass2_window_groups=0, second_pass=True,
                           return_counts=False):
    """Stateless two-pass Morton-window flocking forces (original order).

    Pass two runs over the diagonally shifted code (3/7 of the grid per
    axis), with pass one's pairs left out exactly by the group-distance
    test; the raw accumulators merge and steering applies once.  Returns
    ``(force, avg_col)`` (plus the ``(n,)`` neighbour count with
    ``return_counts``).
    """
    n = pos.shape[1]
    c = cell_coords(pos, cell_size, grid_dim, offset)
    code = _spread3(c[0]) | (_spread3(c[1]) << 1) | (_spread3(c[2]) << 2)
    kw = dict(n=n, gsz=group_size, wg=window_groups,
              perception_sq=perception_radius ** 2,
              separation_sq=separation_radius ** 2)
    acc, grp = _window_pass(pos, vel, col, None, code, **kw)
    if second_pass:
        # Extend rather than wrap: a wrap would put its seam where the old
        # major plane was.  Extended coords use one more Morton bit.
        c2 = c + max(1, (grid_dim * 3) // 7)
        code2 = (_spread3(c2[0]) | (_spread3(c2[1]) << 1)
                 | (_spread3(c2[2]) << 2))
        kw2 = dict(kw, wg=(pass2_window_groups or window_groups),
                   prev_wg=window_groups)
        acc = acc + _window_pass(pos, vel, col, grp, code2, **kw2)[0]
    force, avg_col = _merge_and_steer(
        acc, pos, vel, col, separation_weight, alignment_weight,
        cohesion_weight, max_speed, max_force)
    if return_counts:
        return force, avg_col, acc[13].to(torch.int32)
    return force, avg_col


def pass1_inputs(pos1, vel1, col1, npad):
    """Pass-1 kernel input from pass-1-sorted ``(3, n)`` state: the state
    padded to ``npad`` slots (positions at 1e9)."""
    n = pos1.shape[1]
    pad = torch.nn.functional.pad
    return (pad(pos1, (0, npad - n), value=1e9), pad(vel1, (0, npad - n)),
            pad(col1, (0, npad - n)))


def pass2_inputs(s_pos1, s_vel1, s_col1, p21_pad, n, gsz):
    """Pass-2 kernel input ``(s_pos2, s_vel2, s_col2, g1f)``: one packed
    ``(9, npad)[:, p21]`` gather of the pass-1 input, padding slots at
    1e9, and each slot's pass-1 group id (padding at -1e9) for the
    dedup."""
    real = torch.arange(p21_pad.shape[0], device=s_pos1.device) < n
    P2 = torch.cat([s_pos1, s_vel1, s_col1], dim=0)[:, p21_pad]
    return (torch.where(real, P2[0:3], 1e9), P2[3:6], P2[6:9],
            torch.where(real, (p21_pad // gsz).to(s_pos1.dtype), -1e9))


def flocking_forces_window_frozen(pos1, vel1, col1, p21_pad, s21, *,
                                  perception_radius, separation_radius,
                                  separation_weight, alignment_weight,
                                  cohesion_weight, max_speed, max_force,
                                  group_size=256, window_groups=2,
                                  pass2_window_groups=0, second_pass=True,
                                  return_counts=False):
    """Window forces on PASS-1-SORTED state with FROZEN orders.

    The production path: the state lives sorted by the pass-1 Morton code
    and both passes' permutations are rebuilt only every
    ``resort_interval`` steps (``models/boids.py``).  Between re-sorts a
    step runs no sort: one packed ``(9, npad)[:, p21]`` gather into the
    pass-2 layout and one ``(14, npad)[:, s21]`` gather back.

    Returns ``(force, avg_col)`` in pass-1 sorted layout.
    """
    n = pos1.shape[1]
    kw = dict(gsz=group_size, wg=window_groups,
              perception_sq=perception_radius ** 2,
              separation_sq=separation_radius ** 2)
    pass1 = pass1_inputs(pos1, vel1, col1, p21_pad.shape[0])
    acc = boids_window_accumulate(*pass1, None, **kw)[:, :n]
    if second_pass:
        kw2 = dict(kw, wg=(pass2_window_groups or window_groups),
                   prev_wg=window_groups)
        pass2 = pass2_inputs(*pass1, p21_pad, n, group_size)
        acc = acc + boids_window_accumulate(*pass2, **kw2)[:, s21]
    force, avg_col = _merge_and_steer(
        acc, pos1, vel1, col1, separation_weight, alignment_weight,
        cohesion_weight, max_speed, max_force)
    if return_counts:
        return force, avg_col, acc[13].to(torch.int32)
    return force, avg_col


def flocking_forces(pos, vel, col, *, cell_size, grid_dim, offset,
                    perception_radius, separation_radius, separation_weight,
                    alignment_weight, cohesion_weight, max_speed, max_force,
                    cell_range=1, cell_capacity=16, chunk=4096,
                    return_counts=False):
    """Exact grid-mode forces: ``(force (3, N), avg_col (3, N))``, plus the
    ``(N,)`` neighbour count with ``return_counts``.

    Boids sorted by cell id; each cell's occupants are one contiguous run
    found with two ``searchsorted`` calls, and each boid gathers a fixed
    ``cell_capacity`` window from each of its ``(2*cell_range+1)^3``
    neighbour cells.  Exact whenever no cell holds more than
    ``cell_capacity`` boids.  Targets run in chunks of ``chunk``.
    """
    n = pos.shape[1]
    dev = pos.device
    ids = cell_index(pos, cell_size, grid_dim, offset).contiguous()
    order = _argsort(ids)
    sorted_ids = ids[order].contiguous()
    coords = cell_coords(pos, cell_size, grid_dim, offset)

    r = cell_range
    d = torch.arange(-r, r + 1, dtype=torch.int32, device=dev)
    doff = torch.stack([a.reshape(-1) for a in
                        torch.meshgrid(d, d, d, indexing="ij")])  # (3, 27)
    n_cells = doff.shape[1]
    psq = perception_radius * perception_radius
    ssq = separation_radius * separation_radius
    cap = cell_capacity
    st = dict(max_speed=max_speed, max_force=max_force)

    sorted_pos = pos[:, order]
    sorted_vel = vel[:, order]
    sorted_col = col[:, order]
    k = torch.arange(cap, dtype=torch.int64, device=dev)
    force = torch.empty_like(pos)
    avg_col = torch.empty_like(col)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        p_i, v_i, c_self = pos[:, s:s + chunk], vel[:, s:s + chunk], \
            col[:, s:s + chunk]
        c = p_i.shape[1]
        nc = coords[:, s:s + chunk, None] + doff[:, None, :]  # (3, c, 27)
        in_range = ((nc >= 0) & (nc < grid_dim)).all(dim=0)
        ncell = (nc[0] + nc[1] * grid_dim
                 + nc[2] * grid_dim * grid_dim).reshape(-1).contiguous()
        starts = torch.searchsorted(sorted_ids, ncell).reshape(c, n_cells)
        ends = torch.searchsorted(sorted_ids, ncell,
                                  right=True).reshape(c, n_cells)
        gidx = starts[:, :, None] + k
        valid = ((k < (ends - starts)[:, :, None])
                 & in_range[:, :, None]).reshape(c, n_cells * cap)
        gidx = gidx.clamp(0, n - 1).reshape(c, n_cells * cap)

        p_j = sorted_pos[:, gidx]                       # (3, c, M)
        dd = p_i[:, :, None] - p_j                      # d = p_i - p_j
        dist_sq = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
        is_nb = valid & (dist_sq < psq) & (dist_sq > 0.0001)
        is_sep = is_nb & (dist_sq < ssq)
        inv_dist = torch.rsqrt(dist_sq.clamp_min(1e-12))
        wsep = torch.where(is_sep, inv_dist * inv_dist,
                           torch.zeros_like(dist_sq))
        sep = (wsep[None] * dd).sum(dim=2)
        sep_count = is_sep.sum(dim=1)
        nbf = is_nb.to(pos.dtype)[None]
        align = (nbf * sorted_vel[:, gidx]).sum(dim=2)
        coh = -(nbf * dd).sum(dim=2)                    # sum (p_j - p_i)
        csum = (nbf * sorted_col[:, gidx]).sum(dim=2)
        nb_count = is_nb.sum(dim=1)

        cnt = sep_count.clamp_min(1).to(pos.dtype)
        f_sep = _steer(sep / cnt, v_i, sep_count > 0, separation_weight, **st)
        ncnt = nb_count.clamp_min(1).to(pos.dtype)
        f_align = _steer(align / ncnt, v_i, nb_count > 0, alignment_weight,
                         **st)
        f_coh = _steer(coh / ncnt, v_i, nb_count > 0, cohesion_weight, **st)
        force[:, s:s + chunk] = f_sep + f_align + f_coh
        avg_col[:, s:s + chunk] = torch.where(
            nb_count > 0, (csum + c_self) / (ncnt + 1.0), c_self)
        counts[s:s + chunk] = nb_count
    if return_counts:
        return force, avg_col, counts
    return force, avg_col


def boids_physics(pos, vel, col, force, avg_col, *, bounds, margin,
                  wall_force, max_speed, color_blend, dt):
    """Wall springs, integrate, speed clamp, colour blend."""
    over = pos - (bounds - margin)
    under = (-bounds + margin) - pos
    wall = (-torch.clamp(over / margin * 2.0, max=1.0) * (over > 0)
            + torch.clamp(under / margin * 2.0, max=1.0) * (under > 0)
            ) * wall_force
    acc = force + wall
    vel = vel + acc * dt
    speed = torch.sqrt((vel * vel).sum(dim=0, keepdim=True))
    vel = torch.where(speed > max_speed,
                      vel * (max_speed / speed.clamp_min(1e-12)), vel)
    pos = pos + vel * dt
    col = col + (avg_col - col) * color_blend
    return pos, vel, col
