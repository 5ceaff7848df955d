"""Production Barnes-Hut engine: amortized lists + per-step window eval.

Port of ``spatialsim_tpu/ops/bh_window.py`` (the JAX module's docstring
has the full design notes).  In short:

* **Rebuild** (every ``rebuild_interval`` steps, or on drift in drift
  mode "max"): Morton sort, octree, then ONE global-worklist traversal per
  octree level that tests every (group, cell) pair against the group's
  skin-dilated bounding box (``s/d < theta``) and against the group's
  Morton window; accepted cells become far entries, straddling leaves
  become range slivers, overflow folds into a per-group mass-conserving
  residual.  Two far layouts:

  - **pooled** (the default, ``pool_tile > 0``): cell-id emission, then
    the cell-id finish writes every group's far list into a compacted
    tile pool of ``(16, tile)`` blocks;
  - **dense** (``pool_tile == 0``: above 20.5M bodies, and whenever
    ``use_quadrupole``): one ``(ng, R, L)`` tensor with ``R`` rows per
    :func:`far_layout`.  Quadrupole builds emit the moment values during
    the traversal ("values"); monopole builds may emit body ranges only
    ("ranges") and materialise the moments from compensated prefix sums
    in group chunks, so only the ``(ng, R, L)`` output is ever whole.

  The pooled layout also has a ranges finish (moments from prefix sums
  straight into the pool) and a values finish (dense lists, then
  :func:`build_pool`).  ``near_groups = K > 0`` adds each group's K
  spatially nearest groups (by contact volume) to its exact near field;
  the traversal drops cells inside the covered intervals, and the lists
  go dense.

* **Every step**: one fused evaluation per group -- the Morton window of
  ``2*window_groups+1`` groups exactly, plus the near groups, plus the
  group's far entries advanced to now as ``com + v*tau (+ a*coef2)`` -- by
  a CUDA kernel in :mod:`spatialsim_tpu_torch.ops.bh_eval_kernel` (pooled,
  or dense in its row, column or matrix form); then the integrator.
  Between rebuilds, ``refresh_interval > 0`` re-materialises every far
  entry's moments from prefix sums over the current state
  (:func:`refresh_lists`).

Compact emission is not ported (ROADMAP Queue 1, "Left from that work":
it measured slower than cell-id emission and was never the default) and
raises ``NotImplementedError``.  :func:`build_lists_sorted` builds from an
already sorted state, and with ``group_offset``/``n_groups`` traverses one
contiguous group range of it: the sharded window step
(``spatialsim_tpu_torch/parallel/sharded.py``) builds each rank's lists so.

Conventions kept from the JAX package, for parity: ``(3, N)``
component-major state; every static capacity (worklist caps, tree caps,
list cap, ``SLIVER_CAP``, pool cap) and its fold-to-residual rule; stable
sorts; compensated prefix sums for sliver moments; integer body ranges in
pool rows 10-13 as exact 16-bit halves.  JAX's out-of-range "drop" scatters
become writes to one spare slot past the end that is sliced off.
Integer bookkeeping runs in int64; the tensors the kernels read
(``pstart``, ``far_n``, ``near``), the permutations and the stored dense
``far_range`` are int32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from spatialsim_tpu_torch.ops.bh_eval_kernel import (
    advance_coefs, far_layout, window_eval, window_eval_pool)
from spatialsim_tpu_torch.ops.bounds import compute_bounds
from spatialsim_tpu_torch.ops.integrator import integrate
from spatialsim_tpu_torch.ops.morton import morton_encode
from spatialsim_tpu_torch.ops.octree import build_octree, level_capacity

_I64 = torch.int64
_I32 = torch.int32
_F32 = torch.float32

_ROADMAP = ("not ported: see ROADMAP.md, Queue 1, \"Left from that "
            "work\" (compact emission measured slower than cell-id and is "
            "left out)")
# Far-right sentinel of an empty covered-interval slot, in group units
# (times group_size it stays below 2^31, as in the JAX package).
_BIG_GROUP = 1_000_000

SLIVER_CAP = 64   # >= 4 emissions/level x levels; deterministic bound
POOL_ROWS = 16
# Straddle-emission compaction capacity, per group per level.
SL_COMPACT_PER_GROUP = 16
# Pool-assembly tiles per chunk (bounds the assembly transient).
_POOL_ASM_CHUNK = 8192
# Flat segment-sum gathers above this width run in chunks.
_COMP_SEG_CHUNK = 1 << 22


class BHLists(NamedTuple):
    """Amortized interaction structure, pooled or dense.

    Pooled lists carry ``pool``/``pstart`` and leave ``far``/``far_range``
    None; dense lists the other way round.  The step counters are Python
    ints: the rebuild policy is a host-side check and needs no device read
    per step.
    """

    order: torch.Tensor       # (npad,) int32 sorted slot -> original id
    inv_order: torch.Tensor   # (n,) int32 original id -> sorted slot
    far_n: torch.Tensor       # (ng,) int32 entries per group (+residual)
    ref_pos: torch.Tensor     # (3, n) sorted positions at build
    # Pooled: (cap_tiles, 16, tile) f32 rows [com3, vel3, mass, acc3,
    # fs_hi, fs_lo, fe_hi, fe_lo, 0, 0]; group g owns tiles
    # [pstart[g], pstart[g] + ceil(far_n[g] / tile)).
    pool: Optional[torch.Tensor] = None
    pstart: Optional[torch.Tensor] = None   # (ng,) int32 first pool tile
    steps_since: int = 0      # steps since the lists were built (tau)
    steps_build: int = 0      # steps since the last full rebuild
    # Dense: (ng, R, L) f32 entries, rows per far_layout(R); slots past
    # far_n[g] are zero.
    far: Optional[torch.Tensor] = None
    # Dense: (ng, 2, L) int32 sorted body range [start, end) behind each
    # entry, (0, 0) for the residual and unused slots.
    far_range: Optional[torch.Tensor] = None
    # (ng, K) int32 near-group ids read as extra exact sources (-1 or
    # >= ng = none); None when K = 0.
    near: Optional[torch.Tensor] = None


def _excl(x):
    """Exclusive cumulative sum (int64)."""
    return torch.cumsum(x, 0) - x


def _spare(size, fill, dtype, device):
    """A (size + 1,) buffer: slot ``size`` takes the dropped writes."""
    return torch.full((size + 1,), fill, dtype=dtype, device=device)


def _select_near_groups(bmin, bmax, K, wg, group_offset=0, n_groups=None,
                        chunk=512):
    """The K spatially nearest groups of groups ``group_offset ..
    group_offset + n_groups`` (all by default), as ``(n_groups, K)`` int32
    ids, -1 where no group qualifies (JAX ``_select_near_groups``).

    ``bmin``/``bmax``: ``(ng, 3)`` bounding boxes of all groups.
    Candidates rank by the CONTACT VOLUME of the boxes dilated by a quarter
    of the row group's half-diagonal (spatial tiles all sit at gap ~ 0, so
    the gap cannot rank them; shared-face volume can).  The Morton window
    (``|dg| <= wg``, self included) scores 0, and a score of 0 is no
    neighbour.  ``jax.lax.top_k`` puts the lower id first among equal
    scores; a stable descending sort does the same here.
    """
    ng = bmin.shape[0]
    n_groups = ng if n_groups is None else n_groups
    d = bmax - bmin
    r_all = 0.5 * torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                             + d[:, 2] * d[:, 2])
    gid = torch.arange(ng, dtype=_I64, device=bmin.device)
    out = []
    for c0 in range(group_offset, group_offset + n_groups, chunk):
        rows = gid[c0:min(c0 + chunk, group_offset + n_groups)]
        m = (0.25 * r_all[rows])[:, None]
        ov = [(torch.minimum(bmax[rows, k][:, None], bmax[None, :, k])
               - torch.maximum(bmin[rows, k][:, None], bmin[None, :, k]))
              + 2.0 * m for k in range(3)]
        contact = ((torch.clamp(ov[0], min=0.0) * torch.clamp(ov[1], min=0.0))
                   * torch.clamp(ov[2], min=0.0))
        excl = (gid[None, :] - rows[:, None]).abs() <= wg
        score = torch.where(excl, torch.zeros_like(contact), contact)
        top, ids = torch.sort(score, dim=1, descending=True, stable=True)
        top, ids = top[:, :K], ids[:, :K]
        out.append(torch.where(top > 0.0, ids, torch.full_like(ids, -1)))
    return torch.cat(out).to(_I32)


def _covered_intervals(near, wg, gsz, group_offset=0):
    """Merged, sorted, half-open covered body ranges per group (JAX
    ``_covered_intervals``): the Morton window ``[g - wg, g + wg]`` plus
    each near-group id, merged where they touch or overlap.

    ``near``: ``(ng, K)`` ids (-1 = none; K may be 0) of groups
    ``group_offset .. group_offset + ng``.  Returns ``(ng, K + 1, 2)``
    int64 in body units of the whole sorted state, sorted by start; empty
    slots carry the far-right sentinel, so containment and overlap tests
    fail on them.
    """
    ng, K = near.shape
    dev = near.device
    big = torch.tensor(_BIG_GROUP, dtype=_I64, device=dev)
    gid = torch.arange(ng, dtype=_I64, device=dev) + group_offset
    nr = near.to(_I64)
    starts = torch.cat([(gid - wg)[:, None],
                        torch.where(nr >= 0, nr, big)], dim=1)
    ends = torch.cat([(gid + wg + 1)[:, None],
                      torch.where(nr >= 0, nr + 1, big)], dim=1)
    o = torch.argsort(starts, dim=1, stable=True)
    starts = torch.gather(starts, 1, o)
    ends = torch.gather(ends, 1, o)
    out_s, out_e = [], []
    cur_s, cur_e = starts[:, 0], ends[:, 0]
    for i in range(1, K + 1):
        s_i, e_i = starts[:, i], ends[:, i]
        new = s_i > cur_e                    # half-open: touching merges
        out_s.append(torch.where(new, cur_s, big))
        out_e.append(torch.where(new, cur_e, big))
        cur_s = torch.where(new, s_i, cur_s)
        cur_e = torch.where(new, e_i, torch.maximum(cur_e, e_i))
    out_s.append(cur_s)
    out_e.append(cur_e)
    s = torch.stack(out_s, dim=1)
    e = torch.stack(out_e, dim=1)
    # Closed intervals came out ascending but interleaved with sentinels.
    o2 = torch.argsort(s, dim=1, stable=True)
    return torch.stack([torch.gather(s, 1, o2) * gsz,
                        torch.gather(e, 1, o2) * gsz], dim=2)


def _comp_prefix(x: torch.Tensor) -> torch.Tensor:
    """Compensated (hi+lo double-f32) inclusive prefix, 0-led.

    ``x``: (P, npad) rows.  Returns (2P, npad+1) stacked [hi; lo].  A plain
    f32 cumsum rounds every partial to ulp(global magnitude), so a short
    segment recovered as ``pref[e] - pref[s]`` loses its bits once the
    running sum dwarfs it; Fast2Sum keeps each step's rounding error in
    ``lo``, and :func:`_comp_seg` adds the lo difference back.
    """
    hi = torch.cumsum(x, 1)
    hi_prev = torch.cat([torch.zeros_like(hi[:, :1]), hi[:, :-1]], 1)
    r = (hi_prev - hi) + x                 # Fast2Sum residual
    lo = torch.cumsum(r, 1)
    z = torch.zeros_like(hi[:, :1])
    return torch.cat([torch.cat([z, hi], 1), torch.cat([z, lo], 1)], 0)


def _comp_seg(pref2: torch.Tensor, s: torch.Tensor, e: torch.Tensor):
    """Segment sums over compensated prefixes; returns (P,) + s.shape."""
    P = pref2.shape[0] // 2
    if s.dim() != 1 or s.numel() <= _COMP_SEG_CHUNK:
        d = pref2[:, e] - pref2[:, s]
        return d[:P] + d[P:]
    out = torch.empty((P, s.numel()), dtype=pref2.dtype, device=pref2.device)
    for c0 in range(0, s.numel(), _COMP_SEG_CHUNK):
        c1 = c0 + _COMP_SEG_CHUNK
        d = pref2[:, e[c0:c1]] - pref2[:, s[c0:c1]]
        out[:, c0:c1] = d[:P] + d[P:]
    return out


def _pack_levels(tree, quadrupole, with_acc):
    """One f32 value table per level for values emission.

    Rows [com3, vel3, mass, (traceless Q6), (acc3)]: the traceless
    conversion ``3*M2 - tr(M2)*I`` happens here once per cell instead of
    once per visited (group, cell) pair.
    """
    packed = []
    for lv in tree.levels:
        rows = [lv.com[0], lv.com[1], lv.com[2],
                lv.vel[0], lv.vel[1], lv.vel[2], lv.mass]
        if quadrupole:
            tr = lv.m2[0] + lv.m2[1] + lv.m2[2]
            rows += [3.0 * lv.m2[0] - tr, 3.0 * lv.m2[1] - tr,
                     3.0 * lv.m2[2] - tr, 3.0 * lv.m2[3],
                     3.0 * lv.m2[4], 3.0 * lv.m2[5]]
        if with_acc:
            rows += [lv.acc[0], lv.acc[1], lv.acc[2]]
        packed.append(torch.stack(rows))
    return packed


def _pack_levels_geo(tree):
    """One f32 geometry table per level for single-gather traversal.

    Rows: [com3, cnt_hi, cnt_lo, bs_hi, bs_lo, chs_hi, chs_lo, chc] = 10.
    Integers ride as exact 16-bit halves (converted, not bit-cast).
    """
    packed = []
    for lv in tree.levels:
        rows = ([lv.com[0], lv.com[1], lv.com[2]]
                + _hl(lv.count) + _hl(lv.body_start) + _hl(lv.child_start)
                + [lv.child_count.to(_F32)])
        packed.append(torch.stack(rows))
    return packed


def _hl(x):
    """Integer tensor -> [hi, lo] exact 16-bit f32 halves."""
    return [(x >> 16).to(_F32), (x & 0xFFFF).to(_F32)]


def _unhl(hi, lo):
    return (hi.to(_I64) << 16) | lo.to(_I64)


def _traverse_global(tree, bbox_min, bbox_max, ng, *, theta, soft_sq, skin,
                     gsz, intervals, list_cap, n_levels, wl_caps,
                     with_acc=False, quadrupole=False, emit_values=False,
                     level_offsets=None, ablate=()):
    """Global-worklist traversal.

    All (group, cell) pairs of one octree level live in one flat,
    group-major worklist of static capacity ``wl_caps[level]``.  Per slot:
    one packed geometry gather, the covered-interval tests against the
    group's Morton window, the skin-dilated ``s/d < theta`` acceptance,
    then emission (far entry), sliver (leaf straddling the window) or
    expansion into the next level's worklist.  Per-group caps fold
    overflow into a mass-conserving residual; worklist overflow emits the
    cell coarsely instead of opening it.

    Emission: with ``level_offsets`` (cell-id mode, the pooled build)
    each entry is one global cell id, ``(ng, L)``; without it (ranges mode)
    each entry is its ``[start, end)`` body range, ``(ng, 2, L)``.
    ``emit_values`` (values mode, the dense quadrupole build) also writes
    every entry's moment rows (:func:`_pack_levels`) and returns them as
    the dense ``(ng, R, L)`` tensor, ``R`` per :func:`far_layout`.
    ``ablate=("emit", "sliver")`` replaces both phases with counts only
    (the cheap demand probe).

    Returns (far | None, far_range, far_n, sl_start, sl_end, sl_n, res,
    wl) with ``wl`` the stacked [fills | pre-clamp demands] per level.
    """
    levels = tree.levels
    dev = bbox_min.device
    geo_levels = _pack_levels_geo(tree)
    mv_levels = [torch.stack([lv.mass, lv.vel[0], lv.vel[1], lv.vel[2]]
                             + ([lv.acc[0], lv.acc[1], lv.acc[2]]
                                if with_acc else []))
                 for lv in levels]
    theta_sq = theta * theta
    L = list_cap
    n_res = 10 if with_acc else 7
    M = intervals.shape[1]
    bounds = torch.cat([(bbox_min - skin).T, (bbox_max + skin).T])  # (6, ng)
    iv_pack = intervals.reshape(ng, 2 * M).T                       # (2M, ng)
    emit_on = "emit" not in ablate
    if emit_values:
        assert level_offsets is None
        val_levels = _pack_levels(tree, quadrupole, with_acc)
        n_cols = val_levels[0].shape[0]
        far_cols = [_spare(ng * L, 0.0, _F32, dev) for _ in range(n_cols)]

    cellid = level_offsets is not None
    if cellid:
        zid = level_offsets[-1] + ng * SLIVER_CAP
        fr_id = _spare(ng * L, zid, _I64, dev)
    else:
        fr_s = _spare(ng * L, 0, _I64, dev)
        fr_e = _spare(ng * L, 0, _I64, dev)
    far_n = torch.zeros((ng,), dtype=_I64, device=dev)
    sl_start = _spare(ng * SLIVER_CAP, 0, _I64, dev)
    sl_end = _spare(ng * SLIVER_CAP, 0, _I64, dev)
    sl_n = torch.zeros((ng,), dtype=_I64, device=dev)
    # The residual accumulates in float64: at 50M bodies one group's
    # residual can hold over half the total mass, past 2^24 unit masses,
    # where float32 sums of its thousands of folded cells drift by ~1e-4
    # of the total.
    res = torch.zeros((n_res, ng), dtype=torch.float64, device=dev)

    # Init: every group x every start-level cell, group-major.
    c0 = levels[0].code.shape[0]
    W0 = wl_caps[0]
    if W0 < ng * c0:
        raise ValueError(
            f"wl_caps[0]={W0} cannot hold the init frontier "
            f"ng*c0={ng}*{c0}; size the level-0 worklist to ng*c0")
    pad_to = ng * c0
    wl_g = torch.full((W0,), ng, dtype=_I64, device=dev)
    wl_c = torch.full((W0,), -1, dtype=_I64, device=dev)
    wl_g[:pad_to] = torch.arange(
        ng, dtype=_I64, device=dev).repeat_interleave(c0)
    cells0 = torch.arange(c0, dtype=_I64, device=dev).repeat(ng)
    wl_c[:pad_to] = torch.where(cells0 < levels[0].n_cells, cells0,
                                torch.full_like(cells0, -1))
    wl_n = torch.tensor(pad_to, dtype=_I64, device=dev)

    wl_sizes = [wl_n]
    wl_demand = [wl_n]
    for li in range(n_levels):
        lv = levels[li]
        level = tree.start_level + li
        side = 2.0 * tree.half / (2 ** level)
        last = li == n_levels - 1
        W = wl_g.shape[0]
        slot_w = torch.arange(W, dtype=_I64, device=dev)

        active = (slot_w < wl_n) & (wl_c >= 0)
        cidx = wl_c.clamp(0, lv.code.shape[0] - 1)
        gidx = wl_g.clamp(0, ng - 1)

        G = geo_levels[li][:, cidx]                      # (10, W) f32
        ccom = G[0:3]
        zero_i = torch.zeros_like(cidx)
        ccount = torch.where(active, _unhl(G[3], G[4]), zero_i)
        cstart = torch.where(active, _unhl(G[5], G[6]), zero_i)
        child_start = _unhl(G[7], G[8])
        child_count = G[9].to(_I64)
        cend = cstart + ccount

        B = bounds[:, gidx]                              # (6, W)
        iv = iv_pack[:, gidx]                            # (2M, W)
        gmin = B[0:3]
        gmax = B[3:6]

        in_union = torch.zeros((W,), dtype=torch.bool, device=dev)
        overlap = torch.zeros((W,), dtype=torch.bool, device=dev)
        for i in range(M):
            lo_i, hi_i = iv[2 * i], iv[2 * i + 1]
            in_union |= (cstart >= lo_i) & (cend <= hi_i)
            overlap |= (cstart < hi_i) & (cend > lo_i)
        straddle = active & ~in_union & overlap
        outside = active & ~in_union & ~overlap
        gap = torch.clamp(torch.maximum(gmin - ccom, ccom - gmax), min=0.0)
        dmin_sq = (gap[0] * gap[0] + gap[1] * gap[1]
                   + gap[2] * gap[2]) + soft_sq
        theta_ok = side * side < theta_sq * dmin_sq

        # A multi-body cell with NO children (overflowed tight tree caps)
        # is unopenable: emit it rather than expand into nothing.
        childless = child_count == 0
        emit_val = outside & (theta_ok | (ccount <= 1) | childless)
        emit_sl = straddle & ((ccount <= 1) | childless)
        if last:
            emit_val = outside
            emit_sl = straddle
            open_ = None
        else:
            open_ = (((outside & ~emit_val) | (straddle & ~emit_sl))
                     & (ccount > 1))

        # Per-group segment starts in the (group-sorted) worklist.
        seg_all = torch.searchsorted(
            wl_g, torch.arange(ng + 1, dtype=_I64, device=dev))
        seg_start = seg_all[:ng]

        if not last:
            W_next = wl_caps[li + 1]
            cc0 = torch.where(open_, child_count, zero_i)
            base0 = _excl(cc0)
            wl_demand.append(base0[-1] + cc0[-1])
            # Worklist overflow: whole entries degrade (values/slivers).
            ovf = open_ & (base0 + cc0 > W_next)
            emit_val = emit_val | (ovf & outside)
            emit_sl = emit_sl | (ovf & straddle)

        if emit_on:
            # Per-group cap gating: rank within the group, keep < L - 1.
            em = emit_val.to(_I64)
            excl = _excl(em)
            base = excl[seg_start.clamp(0, W - 1)]
            local = far_n[gidx] + (excl - base[gidx])
            ok = emit_val & (local < L - 1)
            over = emit_val & ~ok
            flat = torch.where(ok, gidx * L + local,
                               torch.full_like(local, ng * L))
            if cellid:
                fr_id[flat] = level_offsets[li] + cidx
            else:
                fr_s[flat] = cstart
                fr_e[flat] = cend
            if emit_values:
                A = val_levels[li][:, cidx]                # (n_cols, W)
                for r, fc in enumerate(far_cols):
                    fc[flat] = A[r]
            if bool(over.any()):
                # Entries past the per-group cap fold into the residual.
                fold = torch.nonzero(over).squeeze(1)
                MV = mv_levels[li][:, cidx[fold]]
                w = MV[0]
                fc = ccom[:, fold]
                contribs = [w, fc[0] * w, fc[1] * w, fc[2] * w,
                            MV[1] * w, MV[2] * w, MV[3] * w]
                if with_acc:
                    contribs += [MV[4] * w, MV[5] * w, MV[6] * w]
                res = _fold_residual(res, gidx[fold],
                                     torch.stack(contribs).double())
            counts = torch.zeros((ng,), dtype=_I64, device=dev)
            counts.index_add_(0, gidx, ok.to(_I64))
            far_n = torch.clamp(far_n + counts, max=L - 1)
        else:
            far_n = far_n + emit_val.sum()

        if "sliver" in ablate:
            sl_n = sl_n + emit_sl.sum()
        elif bool(emit_sl.any()):
            sl_n = _emit_slivers(emit_sl, cstart, cend, gidx, intervals, ng,
                                 M, sl_start, sl_end, sl_n)

        if not last:
            # Child expansion by run reconstruction: one run descriptor
            # per open parent, then a cumsum + gathers over W_next.
            cc = torch.where(ovf, zero_i, cc0)
            base = _excl(cc)
            has = cc > 0
            hasi = has.to(_I64)
            rpos = torch.where(has, _excl(hasi), torch.full_like(hasi, W))
            run_cs = _spare(W, 0, _I64, dev)
            run_g = _spare(W, ng, _I64, dev)
            run_base = _spare(W, 0, _I64, dev)
            run_cs[rpos] = child_start
            run_g[rpos] = wl_g
            run_base[rpos] = base
            mark = _spare(W_next, 0, _I64, dev)
            mark[torch.where(has & (base < W_next), base,
                             torch.full_like(base, W_next))] = 1
            seg = (torch.cumsum(mark[:W_next], 0) - 1).clamp(0, W - 1)
            slot = torch.arange(W_next, dtype=_I64, device=dev)
            wl_n = base[-1] + cc[-1]
            live = slot < wl_n
            wl_c = torch.where(live, run_cs[seg] + (slot - run_base[seg]),
                               torch.full_like(slot, -1))
            wl_g = torch.where(live, run_g[seg], torch.full_like(slot, ng))
            wl_sizes.append(wl_n)

    if cellid:
        far_range = fr_id[:ng * L].reshape(ng, L)
    else:
        far_range = torch.stack([fr_s[:ng * L].reshape(ng, L),
                                 fr_e[:ng * L].reshape(ng, L)], dim=1)
    far = None
    if emit_values:
        # Rows are exactly the emitted columns (far_layout): 7 monopole
        # columns get one zero pad row, 10/13/16 stand as they are.
        grid = [fc[:ng * L].reshape(ng, L) for fc in far_cols]
        if n_cols == 7:
            grid.append(torch.zeros((ng, L), dtype=_F32, device=dev))
        far = torch.stack(grid, dim=1)                           # (ng, R, L)
        del far_cols, grid
    res = res.T.to(_F32).contiguous()
    return (far, far_range, far_n,
            sl_start[:ng * SLIVER_CAP].reshape(ng, SLIVER_CAP),
            sl_end[:ng * SLIVER_CAP].reshape(ng, SLIVER_CAP), sl_n, res,
            torch.stack(wl_sizes + wl_demand))


def _fold_residual(res, groups, rows):
    """``res`` ``(k, ng)`` plus each group's columns of ``rows`` ``(k,
    K)``, summed in one fixed order: per group, its residual so far, then
    its columns in worklist order (``groups`` non-decreasing, the worklist
    being group-sorted).

    The order is that of the ``index_add_`` it replaces on the CPU, so the
    results are equal bit for bit; on a card ``torch.segment_reduce`` keeps
    it (one thread a row and group adds its run in sequence), where the
    atomics of ``index_add_`` added in the order they happened to run.
    """
    ng, K = res.shape[1], groups.shape[0]
    ar = torch.arange(ng, dtype=_I64, device=res.device)
    heads = torch.searchsorted(groups, ar) + ar
    data = res.new_empty((res.shape[0], K + ng))
    data[:, heads] = res
    data[:, torch.arange(K, dtype=_I64, device=res.device) + groups + 1] = \
        rows
    offsets = torch.cat([heads, heads.new_full((1,), K + ng)])
    return torch.segment_reduce(
        data, "sum", offsets=offsets.expand(res.shape[0], -1).contiguous(),
        axis=1, unsafe=True)


def _emit_slivers(mask, s, e, gidx, intervals, ng, M, sl_start, sl_end,
                  sl_n):
    """Clip straddling leaves against the covered intervals and append
    each uncovered fragment as a sliver (in place on sl_start/sl_end).

    Straddles are rare, so they are compacted first (capacity
    ``SL_COMPACT_PER_GROUP * ng``; overflow drops the fragment, as in the
    JAX package).  Returns the new ``sl_n``.
    """
    dev = s.device
    C = SL_COMPACT_PER_GROUP * ng
    em = mask.to(_I64)
    rank = _excl(em)
    cpos = torch.where(mask & (rank < C), rank, torch.full_like(rank, C))
    cs = _spare(C, 0, _I64, dev)
    ce = _spare(C, 0, _I64, dev)
    cg = _spare(C, ng, _I64, dev)
    cs[cpos] = s
    ce[cpos] = e
    cg[cpos] = gidx
    cs, ce, cg = cs[:C], ce[:C], cg[:C]
    cvalid = ce > cs
    cgc = cg.clamp(0, ng - 1)
    civ = intervals.reshape(ng, 2 * M).T[:, cgc]                  # (2M, C)

    # Walk the sorted intervals with a running pointer.
    cur = cs
    parts = []
    for i in range(M):
        lo_i, hi_i = civ[2 * i], civ[2 * i + 1]
        parts.append((cur, torch.minimum(ce, lo_i)))
        cur = torch.maximum(cur, hi_i)
    parts.append((cur, ce))

    cseg = torch.searchsorted(cg, torch.arange(ng, dtype=_I64, device=dev))
    for ps, pe in parts:
        take = cvalid & (pe > ps)
        tm = take.to(_I64)
        excl = _excl(tm)
        base = excl[cseg.clamp(0, C - 1)]
        local = sl_n[cgc] + (excl - base[cgc])
        ok = take & (local < SLIVER_CAP)
        flat = torch.where(ok, cgc * SLIVER_CAP + local,
                           torch.full_like(local, ng * SLIVER_CAP))
        sl_start[flat] = ps
        sl_end[flat] = pe
        counts = torch.zeros((ng + 1,), dtype=_I64, device=dev)
        counts.index_add_(0, torch.where(take, cgc, torch.full_like(cgc, ng)),
                          ok.to(_I64))
        sl_n = torch.clamp(sl_n + counts[:ng], max=SLIVER_CAP)
    return sl_n


def _device_hbm_bytes(device=None, default: float = 13.0e9) -> float:
    """Device memory to size calibration ceilings against.

    CUDA: the card's total memory from ``torch.cuda.mem_get_info``.  CPU:
    the JAX package's fallback (13 GB), so a CPU calibration matches the
    JAX package's cap for cap.
    """
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[1])
    return float(default)


def _auto_budget(npad: int) -> int:
    """Auto worklist budget: 4.2 visited pairs per body, capped (6M up to
    4.2M bodies, 10M up to 20.5M, 24M beyond -- the JAX package's
    measured limits)."""
    budget = max(262_144, int(4.2 * npad))
    cap = (6_000_000 if npad <= 4_200_000 else
           10_000_000 if npad <= 20_500_000 else 24_000_000)
    return min(budget, cap)


def _default_wl_caps(ng: int, n_levels: int, budget: int, c0: int = 64):
    """Per-level worklist capacities from the measured 1M galaxy demand
    profile; level 0 holds the whole ``ng * c0`` init frontier."""
    frac = [0.07, 0.07, 0.06, 0.07, 0.17, 0.36] + [1.0] * max(
        0, n_levels - 6)
    caps = []
    for li in range(n_levels):
        f = frac[li] if li < len(frac) else 1.0
        caps.append(int(max(ng * 8, f * budget)))
    caps[0] = max(caps[0], ng * c0)
    return tuple(caps)


def pool_cap_tiles(budget: int, ng: int, tile: int, npad: int = 0,
                   caps_total: int = 0) -> int:
    """Static tile capacity of the far pool (see the JAX docstring).

    ``caps_total`` (the calibrated per-level cap sum) is the exact
    emission bound and replaces the budget heuristic.
    """
    if caps_total:
        return int(caps_total + ng * (SLIVER_CAP + 1)) // tile + ng + 1
    factor = 1 if (npad or 0) <= 4_200_000 else 2.5
    return int(factor * budget + ng * (SLIVER_CAP + 1)) // tile + ng + 1


def _sort_state(pos, vel, mass, acc, max_depth, gsz):
    """Morton sort + group padding shared by the build and the probe.

    Tail pads repeat the last sorted body with mass 0.
    """
    n = pos.shape[1]
    half = compute_bounds(pos)
    codes = morton_encode(pos, half, max_depth)
    # Stable: at depth 8 many bodies share a code, and group membership
    # (hence every list) depends on the tie order.
    order = torch.argsort(codes, stable=True)
    npad = ((n + gsz - 1) // gsz) * gsz
    pad = npad - n
    order_pad = torch.cat([order, order[-1:].expand(pad)])
    s_codes = codes[order_pad]
    s_pos = pos[:, order_pad]
    s_mass = mass[order_pad].clone()
    s_mass[n:] = 0.0
    s_vel = vel[:, order_pad]
    s_acc = None if acc is None else acc[:, order_pad]
    return half, order, order_pad, s_codes, s_pos, s_vel, s_mass, s_acc


def build_lists(pos, vel, mass, acc=None, *, theta, softening, skin=4.0,
                max_depth=10, group_size=256, window_groups=3,
                list_cap=2048, worklist_budget=0, quadrupole=False,
                near_groups=0, with_ranges=True, pool_tile=0, pool_cap=0,
                emit_mode="auto", wl_caps=(), tree_caps=()) -> BHLists:
    """Morton sort + octree + global-worklist traversal + finish.

    ``pos``/``vel``/``acc``: ``(3, n)`` f32; ``mass``: ``(n,)`` f32, all on
    one device.  The emission mode and finish follow the JAX package:

    * ``pool_tile > 0``, monopole, ``emit_mode`` "auto"/"cellid": cell-id
      emission and the pooled cell-id finish (the default path);
      "ranges": ranges emission and :func:`_finish_pool_ranges`;
      "values": values emission, :func:`_finish_lists`, then
      :func:`build_pool`;
    * ``pool_tile == 0``: the dense ``(ng, R, L)`` layout, from "values"
      emission when ``quadrupole`` (or ``emit_mode`` is not "ranges"), else
      from "ranges" emission with the moments materialised by
      :func:`_finish_lists` in group chunks (the EXTREME path).

    ``near_groups = K > 0`` selects each group's K nearest groups
    (:func:`_select_near_groups`), whose bodies the eval sums exactly; the
    traversal drops every cell inside the merged covered intervals.
    ``with_ranges=False`` drops the dense ``far_range`` (no refresh).
    Compact emission raises ``NotImplementedError``; a pooled quadrupole
    raises ``ValueError`` (the pool is monopole-only, as in the JAX
    package).
    """
    half, order, order_pad, s_codes, s_pos, s_vel, s_mass, s_acc = \
        _sort_state(pos, vel, mass, acc, max_depth, group_size)
    return _build_from_sorted(
        s_codes, s_pos, s_vel, s_mass, s_acc, order, order_pad, pos,
        pos.shape[1], half, theta=theta, softening=softening, skin=skin,
        max_depth=max_depth, group_size=group_size,
        window_groups=window_groups, list_cap=list_cap,
        worklist_budget=worklist_budget, quadrupole=quadrupole,
        near_groups=near_groups, with_ranges=with_ranges,
        pool_tile=pool_tile, pool_cap=pool_cap, emit_mode=emit_mode,
        wl_caps=wl_caps, tree_caps=tree_caps)


def build_lists_sorted(s_pos, s_vel, s_mass, s_acc=None, *, order, theta,
                       softening, skin=4.0, max_depth=10, group_size=256,
                       window_groups=3, list_cap=2048, worklist_budget=0,
                       group_offset=0, n_groups=None, quadrupole=False,
                       near_groups=0, with_ranges=True, pool_tile=0,
                       pool_cap=0, emit_mode="auto", wl_caps=(),
                       tree_caps=()) -> BHLists:
    """:func:`build_lists` for an ALREADY Morton-sorted state (JAX
    ``build_lists_sorted``).

    ``s_pos``/``s_vel``/``s_acc``: ``(3, npad)``, ``s_mass``: ``(npad,)``,
    ``npad`` a multiple of ``group_size``, padding slots already zero-mass;
    ``order``: the ``(npad,)`` caller-meaningful id of each sorted slot,
    returned as ``BHLists.order`` (``inv_order`` is its inverse over
    ``npad``).  No sort runs: the codes are recomputed from ``s_pos`` and
    must already ascend.  ``group_offset``/``n_groups`` restrict the
    traversal and the lists to that contiguous group range, as the sharded
    window step does for each rank: the octree is still built over the
    whole state, each group's window and covered intervals are its global
    ones, and ``far_range`` holds global sorted slots.  ``ref_pos`` is
    ``s_pos`` itself.
    """
    npad = s_pos.shape[1]
    if npad % group_size:
        raise ValueError(f"pre-sorted input of {npad} slots must be padded "
                         f"to whole groups of {group_size}")
    half = compute_bounds(s_pos)
    s_codes = morton_encode(s_pos, half, max_depth)
    return _build_from_sorted(
        s_codes, s_pos, s_vel, s_mass, s_acc, order, order, s_pos, npad,
        half, theta=theta, softening=softening, skin=skin,
        max_depth=max_depth, group_size=group_size,
        window_groups=window_groups, list_cap=list_cap,
        worklist_budget=worklist_budget, group_offset=group_offset,
        n_groups=n_groups, quadrupole=quadrupole, near_groups=near_groups,
        with_ranges=with_ranges, pool_tile=pool_tile, pool_cap=pool_cap,
        emit_mode=emit_mode, wl_caps=wl_caps, tree_caps=tree_caps)


def _build_from_sorted(s_codes, s_pos, s_vel, s_mass, s_acc, order,
                       order_pad, pos, n, half, *, theta, softening, skin,
                       max_depth, group_size, window_groups, list_cap,
                       worklist_budget, quadrupole, near_groups, with_ranges,
                       pool_tile, pool_cap, emit_mode, wl_caps, tree_caps,
                       group_offset=0, n_groups=None) -> BHLists:
    """Octree, traversal and finish over a sorted, group-padded state, for
    the groups ``group_offset .. group_offset + n_groups`` (all by
    default); the emission mode and finish as :func:`build_lists` says."""
    pooled = bool(pool_tile)
    if pooled and quadrupole:
        raise ValueError("the pooled far layout is monopole-only: "
                         "quadrupole lists need pool_tile=0")
    if emit_mode in ("compact", "compact-mm") and with_ranges and pooled:
        raise NotImplementedError(
            f"build_lists(emit_mode={emit_mode!r}) is {_ROADMAP}")
    cellid = (emit_mode in ("cellid", "auto") and with_ranges
              and not quadrupole and pooled)
    emit_ranges = (with_ranges and not quadrupole
                   and (emit_mode == "ranges" or cellid))
    gsz = group_size
    npad = s_pos.shape[1]

    tree = build_octree(s_codes, s_pos, s_mass, half, max_depth=max_depth,
                        start_level=2, n=npad, sorted_vel=s_vel,
                        sorted_acc=s_acc, with_quadrupole=quadrupole,
                        level_caps=tuple(tree_caps or ()))
    n_levels = len(tree.levels)
    ng_all = npad // gsz
    ng = ng_all if n_groups is None else int(n_groups)
    g0 = int(group_offset)
    if ng < 1 or g0 < 0 or g0 + ng > ng_all:
        raise ValueError(f"groups [{g0}, {g0 + ng}) do not lie in the "
                         f"state's {ng_all} groups")
    gpos = s_pos.reshape(3, ng_all, gsz)
    bmin_all = gpos.amin(dim=2).T                                 # (ng, 3)
    bmax_all = gpos.amax(dim=2).T
    bbox_min, bbox_max = bmin_all[g0:g0 + ng], bmax_all[g0:g0 + ng]
    near = (_select_near_groups(bmin_all, bmax_all, near_groups,
                                window_groups, g0, ng) if near_groups > 0
            else torch.zeros((ng, 0), dtype=_I32, device=s_pos.device))
    intervals = _covered_intervals(near, window_groups, gsz, g0)
    near = near if near_groups > 0 else None

    budget = worklist_budget or _auto_budget(npad)
    c0 = tree.levels[0].code.shape[0]
    explicit_caps = bool(wl_caps)
    if wl_caps:
        assert len(wl_caps) == n_levels, (
            f"wl_caps has {len(wl_caps)} levels, build has {n_levels} "
            f"(depth change invalidates calibrated caps)")
        wl_caps = tuple(max(int(c), ng * (c0 if li == 0 else 8))
                        for li, c in enumerate(wl_caps))
    else:
        wl_caps = _default_wl_caps(ng, n_levels, budget, c0=c0)
    level_offs = None
    if cellid:
        offs, tot = [], 0
        for lv in tree.levels:
            offs.append(tot)
            tot += lv.code.shape[0]
        level_offs = tuple(offs + [tot])

    far, far_range, far_n, sl_start, sl_end, sl_n, res, _ = _traverse_global(
        tree, bbox_min, bbox_max, ng, theta=float(theta),
        soft_sq=float(softening) ** 2, skin=float(skin), gsz=gsz,
        intervals=intervals, list_cap=list_cap, n_levels=n_levels,
        wl_caps=wl_caps, with_acc=s_acc is not None, quadrupole=quadrupole,
        emit_values=not emit_ranges, level_offsets=level_offs)
    cap = pooled and (pool_cap or pool_cap_tiles(
        budget, ng, pool_tile, npad,
        caps_total=sum(wl_caps) if explicit_caps else 0))
    if cellid:
        return _finish_pool_cellid(
            tree, level_offs, far_range, far_n, sl_start, sl_end, sl_n, res,
            s_pos, s_vel, s_mass, order, order_pad, pos, n, list_cap,
            tile=pool_tile, cap_tiles=cap, s_acc=s_acc, near=near)
    del tree
    if pooled and emit_ranges:
        return _finish_pool_ranges(
            far_range, far_n, sl_start, sl_end, sl_n, res, s_pos, s_vel,
            s_mass, order, order_pad, pos, n, list_cap, tile=pool_tile,
            cap_tiles=cap, s_acc=s_acc, near=near)
    lists = _finish_lists(far, far_range if with_ranges else None, far_n,
                          sl_start, sl_end, sl_n, res, s_pos, s_vel, s_mass,
                          order, order_pad, pos, n, list_cap, s_acc=s_acc,
                          near=near)
    if pooled:
        pool, pstart, far_n2 = build_pool(lists.far, lists.far_range,
                                          lists.far_n, tile=pool_tile,
                                          cap_tiles=cap)
        lists = lists._replace(pool=pool, pstart=pstart, far_n=far_n2,
                               far=None, far_range=None)
    return lists


def _finish_lists(far, far_range, far_n, sl_start, sl_end, sl_n, res,
                  s_pos, s_vel, s_mass, order, order_pad, pos, n, list_cap,
                  s_acc=None, near=None) -> BHLists:
    """Dense finish: sliver moments, the residual entry, the BHLists.

    ``far``: the ``(ng, R, L)`` values-emission tensor, or None after
    ranges emission -- then every entry's monopole moments are segment
    sums over ``far_range`` of compensated prefix sums of the sorted
    state, materialised ``_COMP_SEG_CHUNK // L`` groups at a time so that
    only the ``(ng, R, L)`` output is ever whole (at 50M bodies the flat
    segment sums and their stacked rows would otherwise coexist with it).
    Slivers (window-boundary fragments) append after the real entries,
    monopole in Q but carrying mean velocity/acceleration; slot ``L - 1``
    stays reserved, and what does not fit folds into the residual, which
    appends right after the last entry.
    """
    dev = s_pos.device
    ng = far_n.shape[0]
    L = list_cap
    SC = SLIVER_CAP
    with_acc = s_acc is not None
    n_rows = far.shape[1] if far is not None else (10 if with_acc else 8)
    quad, acc0 = far_layout(n_rows)
    pref = _state_prefix(s_pos, s_vel, s_mass, s_acc)     # (2P, npad+1)

    if far is None:
        far = torch.empty((ng, n_rows, L), dtype=_F32, device=dev)
        CHG = max(1, _COMP_SEG_CHUNK // L)
        for g0 in range(0, ng, CHG):
            g1 = min(ng, g0 + CHG)
            C = g1 - g0
            segf = _comp_seg(pref, far_range[g0:g1, 0].reshape(C * L),
                             far_range[g0:g1, 1].reshape(C * L))
            fm = segf[0]
            finv = torch.where(fm > 0, 1.0 / torch.clamp(fm, min=1e-30),
                               torch.zeros_like(fm))
            frows = [segf[r] * finv for r in range(1, 7)] + [fm]
            if with_acc:
                frows += [segf[r] * finv for r in range(7, 10)]
            frows += [torch.zeros_like(fm)] * (n_rows - len(frows))
            far[g0:g1] = torch.stack(frows).reshape(
                n_rows, C, L).transpose(0, 1)
            del segf, frows

    # Sliver moments from prefix sums: a small (ng, SC) gather.
    seg = _comp_seg(pref, sl_start, sl_end)                 # (P, ng, SC)
    del pref
    k = torch.arange(SC, dtype=_I64, device=dev)[None, :]
    svalid = k < sl_n[:, None]
    sm = torch.where(svalid, seg[0], torch.zeros_like(seg[0]))
    sinv = torch.where(sm > 0, 1.0 / torch.clamp(sm, min=1e-30),
                       torch.zeros_like(sm))
    zero = torch.zeros_like(sm)
    srows = [seg[r] * sinv for r in range(1, 7)] + [sm]
    if quad:
        srows += [zero] * 6
    if acc0 is not None:
        srows += ([seg[r] * sinv for r in range(7, 10)] if with_acc
                  else [zero] * 3)
    srows += [zero] * (n_rows - len(srows))
    svals = torch.stack(srows, dim=1)                       # (ng, R, SC)

    # Append slivers; what does not fit below slot L - 1 folds into the
    # residual.
    fits = svalid & (far_n[:, None] + k < L - 1)
    gi = torch.arange(ng, dtype=_I64, device=dev)[:, None].expand(ng, SC)
    slot = (far_n[:, None] + k).expand(ng, SC)
    gf, sf = gi[fits], slot[fits]
    far[gf, :, sf] = svals.transpose(1, 2)[fits]
    if far_range is not None:
        far_range[gf, 0, sf] = sl_start[fits]
        far_range[gf, 1, sf] = sl_end[fits]
    over = svalid & ~fits
    if bool(over.any()):
        om = torch.where(over, sm, zero)
        parts = [om.sum(dim=1)[:, None],
                 (svals[:, 0:3] * om[:, None]).sum(dim=2),
                 (svals[:, 3:6] * om[:, None]).sum(dim=2)]
        if with_acc:
            parts.append((svals[:, acc0:acc0 + 3] * om[:, None]).sum(dim=2))
        res = res + torch.cat(parts, dim=1)
    far_n = torch.clamp(far_n + sl_n, max=L - 1)

    # Residual: one entry right after the real entries.
    res_m = res[:, 0]
    has_res = res_m > 0
    inv_m = torch.where(has_res, 1.0 / torch.clamp(res_m, min=1e-30),
                        torch.zeros_like(res_m))
    zg = torch.zeros((ng,), dtype=_F32, device=dev)
    rrows = [res[:, r] * inv_m for r in range(1, 7)] + [res_m]
    if quad:
        rrows += [zg] * 6
    if acc0 is not None:
        rrows += ([res[:, r] * inv_m for r in range(7, 10)] if with_acc
                  else [zg] * 3)
    rrows += [zg] * (n_rows - len(rrows))
    rslot = torch.clamp(far_n, max=L - 1)
    rg = torch.nonzero(has_res).reshape(-1)
    far[rg, :, rslot[rg]] = torch.stack(rrows, dim=1)[rg]
    if far_range is not None:
        far_range[rg, :, rslot[rg]] = 0
        far_range = far_range.to(_I32)
    far_n = torch.clamp(far_n + has_res.to(_I64), max=L)

    inv_order = torch.empty((n,), dtype=_I32, device=dev)
    inv_order[order] = torch.arange(n, dtype=_I32, device=dev)
    return BHLists(order=order_pad.to(_I32), inv_order=inv_order,
                   far_n=far_n.to(_I32), ref_pos=pos, far=far,
                   far_range=far_range, near=near)


def _finish_pool_cellid(tree, level_offsets, fr_id, far_n, sl_start, sl_end,
                        sl_n, res, s_pos, s_vel, s_mass, order, order_pad,
                        pos, n, list_cap, *, tile, cap_tiles, s_acc=None,
                        near=None):
    """Cell-id finish: pool moments come straight from the cell tables.

    Every far entry is an octree cell, so assembly gathers its finished
    moments and body range from ONE global table with one packed gather
    per pool slot.  Slivers (window-straddle fragments, not cells) get
    their moments from compensated prefix sums and append to the table as
    extra columns with synthetic ids; one zero column backs unused slots
    (zero mass, so the eval's last-tile tail contributes nothing).
    """
    dev = s_pos.device
    ng = far_n.shape[0]
    L = list_cap
    with_acc = s_acc is not None
    n_pref = 10 if with_acc else 7
    SC = SLIVER_CAP
    C_tot = level_offsets[-1]
    zid = C_tot + ng * SC

    fr_id = torch.cat([fr_id.reshape(ng * L),
                       torch.full((1,), zid, dtype=_I64, device=dev)])

    # Global cell table: [com3, vel3, mass, (acc3), bs_hi, bs_lo, cnt_hi,
    # cnt_lo].
    def level_rows(lv):
        rows = [lv.com[0], lv.com[1], lv.com[2],
                lv.vel[0], lv.vel[1], lv.vel[2], lv.mass]
        if with_acc:
            rows += [lv.acc[0], lv.acc[1], lv.acc[2]]
        return torch.stack(rows + _hl(lv.body_start) + _hl(lv.count))
    table = torch.cat([level_rows(lv) for lv in tree.levels], dim=1)
    R_t = n_pref + 4

    # Sliver moments from compensated prefix sums (<= ng*SC ranges).
    pref = _state_prefix(s_pos, s_vel, s_mass, s_acc)           # (2P, npad+1)
    seg_sl = _comp_seg(pref, sl_start, sl_end)                  # (P, ng, SC)
    m_sl = seg_sl[0]
    inv_sl = torch.where(m_sl > 0, 1.0 / torch.clamp(m_sl, min=1e-30),
                         torch.zeros_like(m_sl))
    sl_rows = [seg_sl[i + 1].reshape(ng * SC) * inv_sl.reshape(ng * SC)
               for i in range(n_pref - 1)]
    sl_rows.insert(6, m_sl.reshape(ng * SC))       # [com3, vel3, m, (acc3)]
    sl_rows += _hl(sl_start.reshape(ng * SC))
    sl_rows += _hl((sl_end - sl_start).reshape(ng * SC))
    table = torch.cat([table, torch.stack(sl_rows),
                       torch.zeros((R_t, 1), dtype=_F32, device=dev)], dim=1)

    # Append sliver entries (slot L-1 stays reserved for the residual).
    k = torch.arange(SC, dtype=_I64, device=dev)[None, :]
    take = k < sl_n[:, None]
    fits = take & (far_n[:, None] + k < L - 1)
    gi = torch.arange(ng, dtype=_I64, device=dev)[:, None]
    flat = torch.where(fits, gi * L + far_n[:, None] + k,
                       torch.full_like(k * gi, ng * L))
    sl_ids = C_tot + (gi * SC + k)
    fr_id[flat.reshape(-1)] = sl_ids.reshape(-1)
    fr_id[ng * L] = zid
    far_n = torch.clamp(far_n + sl_n, max=L - 1)

    over = take & ~fits
    if bool(over.any()):
        om = over.to(_F32)
        res = res + torch.stack([(seg_sl[i] * om).sum(dim=1)
                                 for i in range(n_pref)], dim=1)

    # Pool-capacity guard: a group whose tiles would start past the static
    # cap folds its ENTIRE list into its residual (never an OOB tile).
    tiles_try = (far_n + 1 + tile - 1) // tile                # +1: residual
    start_try = _excl(tiles_try)
    unfit = start_try + tiles_try > cap_tiles - ng
    if bool(unfit.any()):
        fi2 = fr_id[:ng * L].reshape(ng, L)
        CH = 512 if L % 512 == 0 else L
        add = torch.zeros((ng, n_pref), dtype=_F32, device=dev)
        for c0 in range(0, L, CH):
            ids = fi2[:, c0:c0 + CH]
            t = table[:, ids.reshape(-1)].reshape(R_t, ng, CH)
            m = t[6]
            em = ((c0 + torch.arange(CH, dtype=_I64, device=dev))[None, :]
                  < far_n[:, None]) & unfit[:, None]
            mw = torch.where(em, m, torch.zeros_like(m))
            parts = [mw] + [t[r] * mw for r in list(range(6))
                            + (list(range(7, 10)) if with_acc else [])]
            add = add + torch.stack([p.sum(dim=1) for p in parts], dim=1)
        res = res + add
        far_n = torch.where(unfit, torch.zeros_like(far_n), far_n)

    def slot_rows(idx):
        # ONE packed table gather per pool slot.
        t = table[:, fr_id[idx]]
        bs_p = _unhl(t[n_pref], t[n_pref + 1])
        fe_p = bs_p + _unhl(t[n_pref + 2], t[n_pref + 3])
        zero = torch.zeros_like(t[0])
        rows = [t[0], t[1], t[2], t[3], t[4], t[5], t[6]]
        rows += [t[7], t[8], t[9]] if with_acc else [zero] * 3
        return rows + _hl(bs_p) + _hl(fe_p) + [zero, zero]

    return _assemble_pool(slot_rows, far_n, res, L, tile, cap_tiles,
                          with_acc, order, order_pad, pos, n, near)


def _assemble_pool(slot_rows, far_n, res, L, tile, cap_tiles, with_acc,
                   order, order_pad, pos, n, near) -> BHLists:
    """Lay out the pooled lists: group g's ``far_n[g]`` entries, plus its
    residual entry where ``res`` holds mass, in tiles from ``pstart[g]``.

    ``slot_rows(idx)`` gives the 16 pool rows of the flat list slots
    ``idx`` (``g * L + k``; ``ng * L`` = an empty slot), called in chunks
    of ``_POOL_ASM_CHUNK`` tiles.  ``res``: ``(ng, 7 | 10)`` f32 [m, m*com3,
    m*vel3 (, m*acc3)]; the residual entry (no body range) goes right
    after the group's real entries.
    """
    dev = far_n.device
    ng = far_n.shape[0]
    res_m = res[:, 0]
    has_res = res_m > 0
    far_n_tot = far_n + has_res.to(_I64)
    tiles_g = (far_n_tot + tile - 1) // tile
    pstart = _excl(tiles_g)
    tot_tiles = tiles_g.sum()
    lane = torch.arange(tile, dtype=_I64, device=dev)[None]
    pool = torch.empty((cap_tiles, POOL_ROWS, tile), dtype=_F32, device=dev)
    for t0 in range(0, cap_tiles, _POOL_ASM_CHUNK):
        t_idx = torch.arange(t0, min(cap_tiles, t0 + _POOL_ASM_CHUNK),
                             dtype=_I64, device=dev)
        CT = t_idx.shape[0]
        g_c = (torch.searchsorted(pstart, t_idx, right=True) - 1).clamp(
            0, ng - 1)
        ent = (t_idx - pstart[g_c])[:, None] * tile + lane
        valid = (t_idx < tot_tiles)[:, None] & (ent < far_n_tot[g_c][:, None])
        is_res = valid & has_res[g_c][:, None] & (
            ent == (far_n_tot[g_c] - 1)[:, None])
        is_rng = valid & ~is_res
        idx = torch.where(is_rng, g_c[:, None] * L + ent.clamp(max=L - 1),
                          torch.full_like(ent, ng * L)).reshape(-1)
        pool[t0:t0 + CT] = torch.stack(slot_rows(idx)).reshape(
            POOL_ROWS, CT, tile).transpose(0, 1)

    inv_m = torch.where(has_res, 1.0 / torch.clamp(res_m, min=1e-30),
                        torch.zeros_like(res_m))
    zg = torch.zeros((ng,), dtype=_F32, device=dev)
    res_rows = [res[:, r] * inv_m for r in range(1, 7)] + [res_m]
    res_rows += ([res[:, r] * inv_m for r in range(7, 10)] if with_acc
                 else [zg] * 3)
    res_rows += [zg] * (POOL_ROWS - len(res_rows))
    rslot = torch.clamp(far_n_tot - 1, min=0)
    rg = torch.nonzero(has_res).reshape(-1)
    pool[(pstart + rslot // tile)[rg], :, (rslot % tile)[rg]] = \
        torch.stack(res_rows, dim=1)[rg]

    inv_order = torch.empty((n,), dtype=_I32, device=dev)
    inv_order[order] = torch.arange(n, dtype=_I32, device=dev)
    return BHLists(order=order_pad.to(_I32), inv_order=inv_order,
                   far_n=far_n_tot.to(_I32), ref_pos=pos, pool=pool,
                   pstart=pstart.to(_I32), steps_since=0, steps_build=0,
                   near=near)


def _state_prefix(s_pos, s_vel, s_mass, s_acc):
    """Compensated prefixes of [m, m*pos, m*vel (, m*acc)] over the sorted
    state: (2P, npad + 1), P = 7 or 10."""
    w = s_mass[None, :]
    cols = [s_mass[None, :], s_pos * w, s_vel * w]
    if s_acc is not None:
        cols.append(s_acc * w)
    return _comp_prefix(torch.cat(cols, dim=0))


def build_pool(far, far_range, far_n, *, tile, cap_tiles):
    """Compact dense monopole lists ``(ng, R in {8, 10}, L)`` into the tile
    pool (JAX ``build_pool``); returns ``(pool, pstart, far_n)``.

    A group whose tiles would start past ``cap_tiles - ng`` folds its WHOLE
    list into one mass-weighted entry at slot 0 (``far_n`` becomes 1),
    never an out-of-bounds tile.  Then one packed gather writes every
    pool slot; slots past a group's ``far_n`` read a zero column.  Body
    ranges ride rows 10-13 as exact 16-bit halves (zeros without
    ``far_range``).
    """
    ng, R, L = far.shape
    assert R in (8, 10), "pool layout is monopole-only"
    dev = far.device
    far_n = far_n.to(_I64)
    tiles_try = (far_n + tile - 1) // tile
    unfit = _excl(tiles_try) + tiles_try > cap_tiles - ng
    if bool(unfit.any()):
        k = torch.arange(L, dtype=_I64, device=dev)[None, :]
        em = ((k < far_n[:, None]) & unfit[:, None]).to(_F32)
        w = far[:, 6, :] * em
        m = w.sum(dim=1)
        inv = torch.where(m > 0, 1.0 / torch.clamp(m, min=1e-30),
                          torch.zeros_like(m))
        fold = [(far[:, i, :] * w).sum(dim=1) * inv for i in range(R)
                if i != 6]
        fold.insert(6, m)
        entry0 = torch.stack(fold, dim=1)                       # (ng, R)
        folded = torch.zeros_like(far)
        folded[:, :, 0] = entry0
        far = torch.where(unfit[:, None, None], folded, far)
        far_n = torch.where(unfit, torch.ones_like(far_n), far_n)
        if far_range is not None:
            far_range = torch.where(unfit[:, None, None],
                                    torch.zeros_like(far_range), far_range)

    tiles_g = (far_n + tile - 1) // tile
    pstart = _excl(tiles_g)
    t_idx = torch.arange(cap_tiles, dtype=_I64, device=dev)
    g_c = (torch.searchsorted(pstart, t_idx, right=True) - 1).clamp(0, ng - 1)
    ent = (t_idx - pstart[g_c])[:, None] * tile + torch.arange(
        tile, dtype=_I64, device=dev)[None]
    valid = ((t_idx < tiles_g.sum())[:, None]
             & (ent < far_n[g_c][:, None]) & (ent < L))
    idx = torch.where(valid, g_c[:, None] * L + ent.clamp(max=L - 1),
                      torch.full_like(ent, ng * L)).reshape(-1)
    farf = far.transpose(0, 1).reshape(R, ng * L)
    zero = torch.zeros((ng * L,), dtype=_F32, device=dev)
    rows = [farf[i] for i in range(7)]
    rows += [farf[7 + i] for i in range(3)] if R == 10 else [zero] * 3
    if far_range is not None:
        fs = far_range[:, 0, :].reshape(ng * L).to(_I64)
        fe = far_range[:, 1, :].reshape(ng * L).to(_I64)
    else:
        fs = fe = torch.zeros((ng * L,), dtype=_I64, device=dev)
    rows += _hl(fs) + _hl(fe)
    src = torch.nn.functional.pad(torch.stack(rows), (0, 1))  # (14, ngL+1)
    vals = torch.cat([src[:, idx], torch.zeros(
        (POOL_ROWS - 14, idx.numel()), dtype=_F32, device=dev)])
    pool = vals.reshape(POOL_ROWS, cap_tiles, tile).transpose(0, 1)
    return pool.contiguous(), pstart.to(_I32), far_n.to(_I32)


def _pool_ranges(pool):
    """(fs, fe) int64 body ranges of every pool slot, from rows 10-13."""
    ct, _, tile = pool.shape
    flat = pool.transpose(0, 1).reshape(POOL_ROWS, ct * tile)
    return _unhl(flat[10], flat[11]), _unhl(flat[12], flat[13])


def _finish_pool_ranges(far_range, far_n, sl_start, sl_end, sl_n, res,
                        s_pos, s_vel, s_mass, order, order_pad, pos, n,
                        list_cap, *, tile, cap_tiles, s_acc=None, near=None):
    """Ranges finish: slivers, the residual and the moments straight into
    the tile pool, from prefix sums (JAX ``_finish_pool_ranges``).

    Every real entry's monopole moments are segment sums of the sorted
    state over its ``[start, end)``; slivers ARE ranges and append as
    entries (slot ``L - 1`` stays reserved), and sliver overflow folds into
    the residual.  The cumulative capacity guard folds a group whose tiles
    would pass ``cap_tiles - ng`` whole into its residual.  The residual
    is the one entry without a range (fs = fe = 0), scattered after
    assembly.  The folds accumulate in float64 (the JAX package sums them
    in float32; see the traversal's residual).
    """
    dev = s_pos.device
    ng = far_n.shape[0]
    L = list_cap
    with_acc = s_acc is not None
    n_pref = 10 if with_acc else 7
    SC = SLIVER_CAP
    pref = _state_prefix(s_pos, s_vel, s_mass, s_acc)
    res = res.double()

    fr_s = far_range[:, 0, :].reshape(ng * L).clone()
    fr_e = far_range[:, 1, :].reshape(ng * L).clone()
    k = torch.arange(SC, dtype=_I64, device=dev)[None, :]
    take = k < sl_n[:, None]
    fits = take & (far_n[:, None] + k < L - 1)
    gi = torch.arange(ng, dtype=_I64, device=dev)[:, None]
    flat = torch.where(fits, gi * L + far_n[:, None] + k,
                       torch.full_like(k * gi, ng * L)).reshape(-1)
    fr_s = torch.cat([fr_s, fr_s.new_zeros(1)])
    fr_e = torch.cat([fr_e, fr_e.new_zeros(1)])
    fr_s[flat] = sl_start.reshape(-1)
    fr_e[flat] = sl_end.reshape(-1)
    fr_s[ng * L] = 0
    fr_e[ng * L] = 0
    far_n = torch.clamp(far_n + sl_n, max=L - 1)

    over = take & ~fits
    if bool(over.any()):
        seg_sl = _comp_seg(pref, sl_start, sl_end)             # (P, ng, SC)
        om = over.double()
        res = res + torch.stack([(seg_sl[i].double() * om).sum(dim=1)
                                 for i in range(n_pref)], dim=1)

    tiles_try = (far_n + 1 + tile - 1) // tile                # +1: residual
    unfit = _excl(tiles_try) + tiles_try > cap_tiles - ng
    if bool(unfit.any()):
        fs2 = fr_s[:ng * L].reshape(ng, L)
        fe2 = fr_e[:ng * L].reshape(ng, L)
        CH = 512 if L % 512 == 0 else L
        add = torch.zeros((ng, n_pref), dtype=torch.float64, device=dev)
        for c0 in range(0, L, CH):
            seg = _comp_seg(pref, fs2[:, c0:c0 + CH], fe2[:, c0:c0 + CH])
            em = (((c0 + torch.arange(CH, dtype=_I64, device=dev))[None, :]
                   < far_n[:, None]) & unfit[:, None]).double()
            add = add + torch.stack([(seg[p].double() * em).sum(dim=1)
                                     for p in range(n_pref)], dim=1)
        res = res + add
        far_n = torch.where(unfit, torch.zeros_like(far_n), far_n)
    fse = torch.stack([fr_s, fr_e])              # (2, ngL + 1), last = 0

    def slot_rows(idx):
        # One packed range gather, then the segment sums of each range.
        fsel = fse[:, idx]
        seg = _comp_seg(pref, fsel[0], fsel[1])
        m = seg[0]
        inv = torch.where(m > 0, 1.0 / torch.clamp(m, min=1e-30),
                          torch.zeros_like(m))
        zero = torch.zeros_like(m)
        rows = [seg[r] * inv for r in range(1, 7)] + [m]
        rows += ([seg[r] * inv for r in range(7, 10)] if with_acc
                 else [zero] * 3)
        return rows + _hl(fsel[0]) + _hl(fsel[1]) + [zero, zero]

    return _assemble_pool(slot_rows, far_n, res.to(_F32), L, tile,
                          cap_tiles, with_acc, order, order_pad, pos, n, near)


# ---------------------------------------------------------------------------
# Moment refresh
# ---------------------------------------------------------------------------

def refresh_lists(lists: BHLists, pos_s, vel_s, mass_s, acc_s=None,
                  dt=0.0, tau_clamp=24.0) -> BHLists:
    """Re-materialise every far entry's moments from the CURRENT sorted
    state (JAX ``refresh_lists``).

    Each entry is a contiguous run ``[start, end)`` of the frozen sort, so
    its current monopole moments are segment sums of compensated prefix
    sums: no sort, octree or traversal.  Entries without a range (the
    residual) are REBASED instead: their com and velocity advance by the
    elapsed ``tau = steps_since * dt`` (clamped quadratic term included),
    so the advance stays continuous across the reset.  Quadrupole rows
    keep their build values.  ``steps_since`` resets to 0;
    ``steps_build`` keeps counting.  Inputs are SORTED ``(3, n)``/``(n,)``.
    """
    npad = lists.order.shape[0]
    pad = npad - pos_s.shape[1]
    if pad:
        pos_s = torch.cat([pos_s, pos_s[:, -1:].expand(3, pad)], dim=1)
        mass_s = torch.cat([mass_s, mass_s.new_zeros(pad)])
        vel_s = torch.cat([vel_s, vel_s.new_zeros((3, pad))], dim=1)
        if acc_s is not None:
            acc_s = torch.cat([acc_s, acc_s.new_zeros((3, pad))], dim=1)
    tau, coef2, tc = _rebase_coefs(lists.steps_since, dt, tau_clamp)
    if lists.pool is not None:
        return lists._replace(
            pool=_refresh_pool(lists.pool, pos_s, vel_s, mass_s, acc_s, tau,
                               coef2, tc), steps_since=0)
    return lists._replace(
        far=_refresh_dense_core(lists.far, lists.far_range, pos_s, vel_s,
                                mass_s, acc_s, tau, coef2, tc),
        steps_since=0)


def _rebase_coefs(steps_since, dt, tau_clamp):
    """:func:`advance_coefs`' (tau, coef2) and the clamped ``t_c = min(tau,
    tau_clamp*dt)`` that advances the velocity, in float32 arithmetic."""
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    f = np.float32
    return tau, coef2, float(min(f(tau), f(tau_clamp) * f(dt)))


def _refresh_dense_core(far, far_range, pos_s, vel_s, mass_s, acc_s, tau,
                        coef2, tc):
    """Dense refresh: ``(ng, R, L)`` far + ``(ng, 2, L)`` ranges + padded
    sorted state -> the refreshed far tensor."""
    ng, R, L = far.shape
    quad, acc0 = far_layout(R)
    pref = _state_prefix(pos_s, vel_s, mass_s,
                         acc_s if acc0 is not None else None)
    with_acc = acc_s is not None and acc0 is not None
    fs = far_range[:, 0, :].reshape(ng * L).to(_I64)
    fe = far_range[:, 1, :].reshape(ng * L).to(_I64)
    seg = _comp_seg(pref, fs, fe)                       # (P, ng*L)
    m = seg[0]
    inv = torch.where(m > 0, 1.0 / torch.clamp(m, min=1e-30),
                      torch.zeros_like(m))
    rows = [seg[r] * inv for r in range(1, 7)] + [m]
    if quad:
        rows += [far[:, 7 + i, :].reshape(ng * L) for i in range(6)]
    if acc0 is not None:
        rows += ([seg[r] * inv for r in range(7, 10)] if with_acc
                 else [far[:, acc0 + i, :].reshape(ng * L) for i in range(3)])
    rows += [torch.zeros_like(m)] * (R - len(rows))
    new = torch.stack(rows).reshape(R, ng, L).transpose(0, 1)
    del seg, rows
    # Rebase the rangeless entries (the residual slot).
    com = far[:, 0:3] + far[:, 3:6] * tau
    vel = far[:, 3:6]
    if acc0 is not None:
        com = com + far[:, acc0:acc0 + 3] * coef2
        vel = vel + far[:, acc0:acc0 + 3] * tc
    rebased = torch.cat([com, vel, far[:, 6:]], dim=1)
    valid = (fe > fs).reshape(ng, 1, L)
    return torch.where(valid, new, rebased)


def _refresh_pool(pool, pos_s, vel_s, mass_s, acc_s, tau, coef2, tc):
    """Pooled refresh: two packed gathers over the pool's slots; padding
    slots (fs = fe = 0) refresh to zero mass, the residual rebases."""
    ct, _, tile = pool.shape
    zero3 = torch.zeros_like(pos_s)
    pref = _state_prefix(pos_s, vel_s, mass_s,
                         zero3 if acc_s is None else acc_s)
    fs, fe = _pool_ranges(pool)
    seg = _comp_seg(pref, fs, fe)
    m = seg[0]
    inv = torch.where(m > 0, 1.0 / torch.clamp(m, min=1e-30),
                      torch.zeros_like(m))
    new10 = torch.stack([seg[r] * inv for r in range(1, 7)] + [m]
                        + [seg[r] * inv for r in range(7, 10)])
    del seg
    flat = pool.transpose(0, 1).reshape(POOL_ROWS, ct * tile)
    com = flat[0:3] + flat[3:6] * tau + flat[7:10] * coef2
    vel = flat[3:6] + flat[7:10] * tc
    rebased = torch.cat([com, vel, flat[6:10]])
    out = torch.cat([torch.where((fe > fs)[None, :], new10, rebased),
                     flat[10:16]])
    return out.reshape(POOL_ROWS, ct, tile).transpose(0, 1).contiguous()


# ---------------------------------------------------------------------------
# Per-step evaluation
# ---------------------------------------------------------------------------

def eval_accel_sorted(lists: BHLists, pos_s, mass_s, dt, *, G, softening,
                      group_size=256, window_groups=3, tau_clamp=24.0,
                      use_cols=False, far_tile=512):
    """Accelerations for SORTED ``(3, n)`` state -- the stepper's path.

    Pads the group tail by repeating the last body with mass 0 and returns
    sorted-order accelerations.  Pooled lists go to the pooled kernel
    (:func:`~spatialsim_tpu_torch.ops.bh_eval_kernel.window_eval_pool`),
    dense lists to the dense one
    (:func:`~spatialsim_tpu_torch.ops.bh_eval_kernel.window_eval`) with
    their near-group table, in its column form for monopole lists when
    ``use_cols`` (pooled lists ignore it, as in the JAX package).
    """
    n = pos_s.shape[1]
    pad = lists.order.shape[0] - n
    if pad:
        s_pos = torch.cat([pos_s, pos_s[:, -1:].expand(3, pad)], dim=1)
        s_mass = torch.cat([mass_s, mass_s.new_zeros(pad)])
    else:
        s_pos, s_mass = pos_s.contiguous(), mass_s.contiguous()
    kw = dict(G=G, softening=softening, group_size=group_size,
              window_groups=window_groups, tau_clamp=tau_clamp)
    if lists.pool is not None:
        acc = window_eval_pool(s_pos, s_mass, lists.pool, lists.pstart,
                               lists.far_n, lists.steps_since, dt, **kw)
    else:
        acc = window_eval(s_pos, s_mass, lists.far, lists.far_n, lists.near,
                          lists.steps_since, dt, use_cols=use_cols,
                          far_tile=far_tile, **kw)
    return acc[:, :n]


def eval_accel(lists: BHLists, pos, mass, dt, **kw):
    """Accelerations at ORIGINAL-order positions (testing/one-shot API);
    pays the sort-in and unsort-out gathers."""
    n = pos.shape[1]
    o = lists.order[:n].long()
    acc = eval_accel_sorted(lists, pos[:, o], mass[o], dt, **kw)
    return acc[:, lists.inv_order.long()]


# ---------------------------------------------------------------------------
# Stepper with rebuild policy
# ---------------------------------------------------------------------------

class WindowBHState(NamedTuple):
    """Window-engine state, stored in MORTON-SORTED order (the order of the
    current lists): the step needs no gathers between rebuilds, and
    host-facing reads map back through ``lists.inv_order``."""

    pos: torch.Tensor            # (3, n) f32, sorted order
    vel: torch.Tensor            # (3, n) f32, sorted order
    mass: torch.Tensor           # (n,) f32, sorted order
    lists: BHLists
    # Previous step's accelerations (sorted order), fed to the rebuild's
    # second-order entry advance; None when advance_order < 2.
    acc: Optional[torch.Tensor] = None


def state_original_order(state: WindowBHState):
    """(pos, vel, mass) in ORIGINAL body order (host-facing)."""
    inv = state.lists.inv_order.long()
    return state.pos[:, inv], state.vel[:, inv], state.mass[inv]


def _build_kw(config):
    """build_lists keyword arguments from an (resolved) NBodyConfig.

    As in the JAX package: the quadrupole accepts at ``theta *
    (quad_accept_scale or 1)``, and the quadrupole, near groups (the
    pooled kernel reads no near table) and ``use_pallas_eval=False``
    (whose XLA eval reads the dense layout) turn the pool off.  In the
    port every dense list goes to the dense CUDA kernel.
    """
    near_groups = getattr(config, "near_groups", 0)
    quad = getattr(config, "use_quadrupole", False)
    theta = config.theta
    if quad:
        theta = theta * (getattr(config, "quad_accept_scale", 0.0) or 1.0)
    dense = (quad or near_groups
             or not getattr(config, "use_pallas_eval", True))
    return dict(theta=theta, softening=config.softening,
                skin=config.skin, max_depth=config.max_depth,
                group_size=config.group_size,
                window_groups=config.window_groups,
                list_cap=config.list_capacity,
                worklist_budget=getattr(config, "worklist_budget", 0),
                wl_caps=tuple(getattr(config, "wl_caps", ()) or ()),
                quadrupole=quad, near_groups=near_groups,
                pool_tile=0 if dense else getattr(config, "pool_tile", 0),
                pool_cap=getattr(config, "pool_cap", 0),
                emit_mode=getattr(config, "traversal_emit", "auto"),
                tree_caps=tuple(getattr(config, "tree_caps", ()) or ()))


def _eval_kw(config):
    return dict(G=config.G, softening=config.softening,
                group_size=config.group_size,
                window_groups=config.window_groups,
                tau_clamp=float(getattr(config, "advance_tau_clamp", 24)))


def make_window_step(config, n: int, substeps: int = 1):
    """Production step with rebuild policy: ``step(state, dt) -> state``.

    Each substep rebuilds first when ``steps_build >= rebuild_interval``
    (a host-side check on the Python-int counter) or, in drift mode
    "max", when any body drifted more than ``skin/2`` since the build (one
    device read); otherwise, with ``refresh_interval > 0``, it refreshes
    the lists' moments (:func:`refresh_lists`) when ``steps_since >=
    refresh_interval``.  Then it evaluates, integrates and bumps the
    counters.  The returned callable counts its rebuilds in
    ``step.rebuilds`` and its refreshes in ``step.refreshes``.  Pooled and
    dense lists take the same step.

    Unlike the JAX package, the decision is taken before every substep at
    every N: above 4M bodies JAX splits the step into two programs and
    defers a due rebuild to the next frame boundary (up to ``substeps-1``
    steps late).  The EXTREME presets run one substep a frame, where the
    two are the same.
    """
    from spatialsim_tpu_torch.config.nbody import resolve_config
    config = resolve_config(config, n)
    kw = _build_kw(config)
    ekw = _eval_kw(config)
    damping = config.damping
    interval = config.rebuild_interval
    refresh_iv = getattr(config, "refresh_interval", 0)
    skin = config.skin
    drift_mode = getattr(config, "rebuild_drift_mode", "max")
    advance2 = getattr(config, "advance_order", 2) >= 2

    def substep(state: WindowBHState, dt: float) -> WindowBHState:
        lists = state.lists
        need = lists.steps_build >= interval
        if not need and drift_mode == "max":
            drift = float((state.pos - lists.ref_pos).abs().max())
            need = drift > skin * 0.5
        pos, vel, mass = state.pos, state.vel, state.mass
        if need:
            pos, vel, mass, lists = _resort_state(
                pos, vel, mass, lists.order, lists.inv_order, kw,
                acc=state.acc if advance2 else None)
            step.rebuilds += 1
        elif refresh_iv and lists.steps_since >= refresh_iv:
            lists = refresh_lists(lists, pos, vel, mass,
                                  state.acc if advance2 else None, dt,
                                  ekw["tau_clamp"])
            step.refreshes += 1
        acc = eval_accel_sorted(lists, pos, mass, dt, **ekw)
        pos, vel = integrate(pos, vel, acc, dt, damping)
        lists = lists._replace(steps_since=lists.steps_since + 1,
                               steps_build=lists.steps_build + 1)
        return WindowBHState(pos, vel, mass, lists,
                             acc if advance2 else None)

    def step(state: WindowBHState, dt: float) -> WindowBHState:
        for _ in range(substeps):
            state = substep(state, float(dt))
        return state

    step.rebuilds = 0
    step.refreshes = 0
    return step


def _resort_state(pos, vel, mass, prev_order, prev_inv, kw, acc=None):
    """Rebuild lists from a sorted-layout state and re-sort it.

    build_lists returns a permutation of its INPUT layout; composing it
    with the previous mapping keeps ``order``/``inv_order`` relative to the
    ORIGINAL body ids, so host reads and frames stay stable.
    """
    n = pos.shape[1]
    nl = build_lists(pos, vel, mass, acc, **kw)
    o = nl.order.long()                 # (npad,) new slot -> previous slot
    o_real = o[:n]
    pos2 = pos[:, o_real]
    vel2 = vel[:, o_real]
    mass2 = mass[o_real]
    to_orig = prev_order.long()[o]      # new slot -> original body id
    o_inv = torch.empty((n,), dtype=_I64, device=pos.device)
    o_inv[o_real] = torch.arange(n, dtype=_I64, device=pos.device)
    inv_new = o_inv[prev_inv.long()]    # original id -> new slot
    # ref_pos is its own tensor: nothing may alias the live positions.
    nl = nl._replace(order=to_orig.to(_I32), inv_order=inv_new.to(_I32),
                     ref_pos=pos2.clone())
    return pos2, vel2, mass2, nl


def init_window_state(pos, vel, mass, config) -> WindowBHState:
    """Build lists from ORIGINAL-order inputs and return the sorted state.

    With ``advance_order >= 2`` the first build uses zero accelerations
    (the first interval advances ballistically); later rebuilds use the
    previous step's accelerations carried in the state.
    """
    from spatialsim_tpu_torch.config.nbody import resolve_config
    config = resolve_config(config, pos.shape[1])
    n = pos.shape[1]
    advance2 = getattr(config, "advance_order", 2) >= 2
    acc0 = torch.zeros_like(pos) if advance2 else None
    lists = build_lists(pos, vel, mass, acc0, **_build_kw(config))
    o_real = lists.order[:n].long()
    pos_s = pos[:, o_real]
    lists = lists._replace(ref_pos=pos_s.clone())
    return WindowBHState(pos_s, vel[:, o_real], mass[o_real], lists,
                         torch.zeros_like(pos_s) if advance2 else None)


# ---------------------------------------------------------------------------
# Calibration on the real initial conditions
# ---------------------------------------------------------------------------

def _measure_tree_caps(config, pos, headroom=2.0):
    """One-time per-level occupancy count -> tight static tree caps
    (x2 drift headroom, rounded up to 1024, never above ``min(8^d, n)``)."""
    kw = _build_kw(config)
    max_depth = kw["max_depth"]
    gsz = kw["group_size"]
    n = pos.shape[1]
    npad = ((n + gsz - 1) // gsz) * gsz
    n_levels = max_depth - 2 + 1
    half = compute_bounds(pos)
    codes = torch.sort(morton_encode(pos, half, max_depth)).values
    occs = []
    for li in range(n_levels):
        c = codes >> (3 * (max_depth - (2 + li)))
        occs.append(1 + (c[1:] != c[:-1]).sum())
    occs = torch.stack(occs).cpu().numpy()
    caps = []
    for li in range(n_levels):
        full = level_capacity(2 + li, npad)
        want = int(occs[li] * headroom) + 1024
        caps.append(int(min(full, -(-want // 1024) * 1024)))
    return tuple(caps)


def _traverse_probe(config, pos, vel, mass, wl_caps, count_emissions=False):
    """One traversal probe on real initial conditions.

    ``count_emissions=False``: emission and sliver phases are count-only
    (``ablate=("emit", "sliver")``); returns the stacked
    ``[fills | pre-clamp demands]`` (2*n_levels,) numpy vector.
    ``count_emissions=True``: emits for real (ranges mode) and returns
    numpy ``(wl, far_n, sl_n)``.  ``config`` must carry ``tree_caps``.
    """
    kw = _build_kw(config)
    gsz = kw["group_size"]
    max_depth = kw["max_depth"]
    n_levels = max_depth - 2 + 1
    half, _, _, s_codes, s_pos, _, s_mass, _ = _sort_state(
        pos, vel, mass, None, max_depth, gsz)
    npad = s_pos.shape[1]
    ng = npad // gsz
    tree = build_octree(s_codes, s_pos, s_mass, half, max_depth=max_depth,
                        start_level=2, n=npad,
                        level_caps=tuple(kw.get("tree_caps", ())))
    gpos = s_pos.reshape(3, ng, gsz)
    out = _traverse_global(
        tree, gpos.amin(dim=2).T, gpos.amax(dim=2).T, ng,
        theta=float(kw["theta"]), soft_sq=float(kw["softening"]) ** 2,
        skin=float(kw["skin"]), gsz=gsz,
        intervals=_covered_intervals(
            torch.zeros((ng, 0), dtype=_I32, device=pos.device),
            kw["window_groups"], gsz),
        list_cap=kw["list_cap"], n_levels=n_levels, wl_caps=tuple(wl_caps),
        with_acc=False, ablate=() if count_emissions else ("emit", "sliver"))
    wl = out[7].cpu().numpy()
    if count_emissions:
        return wl, out[2].cpu().numpy(), out[5].cpu().numpy()
    return wl


def calibrate_config(config, pos, vel, mass, rounds=3, headroom=1.5):
    """Demand-calibrate tree caps, worklist caps and the pool cap on the
    real initial conditions (port of the JAX ``calibrate_config``).

    Measures occupancy-tight ``tree_caps``; then runs count-only traversal
    probes, growing every level whose pre-clamp demand exceeds its cap (up
    to ``rounds`` times: folding undercounts deeper demand), bounded by
    ``ng * cells(level)``, 8x the previous cap, and a device-memory
    ceiling; the two deepest levels never grow past their defaults.  A
    counted-emissions probe then sizes ``pool_cap`` (x1.5) when caps grew
    or when the budget-derived pool would fold whole groups (a fault of
    the JAX package at 1M bodies, ``ROADMAP.md`` Queue 3); otherwise the
    worklist caps and the pool stay at their defaults, as in JAX.
    """
    from spatialsim_tpu_torch.config.nbody import resolve_config
    config = resolve_config(config, pos.shape[1])
    if not getattr(config, "tree_caps", ()):
        config = config.replace(tree_caps=_measure_tree_caps(config, pos))
    if getattr(config, "wl_caps", ()):
        return config
    kw = _build_kw(config)
    n = pos.shape[1]
    gsz = kw["group_size"]
    npad = ((n + gsz - 1) // gsz) * gsz
    n_levels = kw["max_depth"] - 2 + 1
    ng = npad // gsz
    budget = kw["worklist_budget"] or _auto_budget(npad)
    defaults = _default_wl_caps(ng, n_levels, budget,
                                c0=level_capacity(2, npad))

    # Per-level ceiling from device memory: ~200 B of live traversal state
    # per worklist slot, a quarter of what the bodies leave free.
    usable = _device_hbm_bytes(pos.device) - 120.0 * n
    lvl_ceil = int(max(8_000_000, usable * 0.25 / 200.0))
    HARD_CEIL = min(48_000_000, lvl_ceil)
    lvl_ceils = [HARD_CEIL] * n_levels
    for li in range(max(0, n_levels - 2), n_levels):
        lvl_ceils[li] = min(HARD_CEIL, defaults[li])
    caps = list(defaults)
    grown = False
    for _ in range(max(1, rounds)):
        wl = _traverse_probe(config, pos, vel, mass, caps)
        demand = wl[n_levels:]
        clamped = [int(demand[li]) > caps[li]
                   and caps[li] < min(lvl_ceils[li],
                                      ng * level_capacity(li + 2, npad))
                   for li in range(n_levels)]
        if not any(clamped):
            break
        new = []
        for li in range(n_levels):
            exact = ng * level_capacity(li + 2, npad)
            if li > 0:
                exact = min(exact, 8 * new[li - 1])
            tgt = max(caps[li], int(int(demand[li]) * headroom))
            tgt = -(-tgt // 1024) * 1024
            new.append(int(max(caps[li],
                               min(max(tgt, ng * 8), exact,
                                   lvl_ceils[li]))))
        new[0] = max(new[0], ng * level_capacity(2, npad))
        if new == caps:
            break      # growth bound by the 8x-parent chain: no progress
        grown = True
        caps = new
    if grown:
        config = config.replace(wl_caps=tuple(caps))
    tile = kw["pool_tile"]
    if tile and not getattr(config, "pool_cap", 0):
        # Size the pool from COUNTED emissions.  The JAX package does this
        # only when caps grew, but its budget default can be too small
        # even when they fit: at the 1M galaxy the default's usable tiles
        # (cap - ng, the rest reserved for folded groups) are 8,701
        # against 10,600 needed, and 677 of 3907 groups fold their WHOLE
        # far field into one residual monopole (force errors ~300x |a|).
        # Ungrown configs whose default fits keep it, as in the JAX code.
        _, far_n, sl_n = _traverse_probe(config, pos, vel, mass, caps,
                                         count_emissions=True)
        need = int(np.sum(
            (far_n.astype(np.int64) + sl_n + 1 + tile - 1) // tile))
        exact = int(sum(caps) + ng * (SLIVER_CAP + 1)) // tile + ng + 1
        default = pool_cap_tiles(budget, ng, tile, npad)
        if grown or need > default - ng:
            config = config.replace(
                pool_cap=min(int(need * 1.5) + ng + 1, exact))
    return config


# ---------------------------------------------------------------------------
# One-shot and diagnostic entry points
# ---------------------------------------------------------------------------

def window_bh_accel(pos, vel, mass, config, dt=0.0):
    """One-shot accelerations at ORIGINAL-order ``(3, n)`` positions from
    fresh lists (built without accelerations): the testing entry point."""
    from spatialsim_tpu_torch.config.nbody import resolve_config
    config = resolve_config(config, pos.shape[1])
    lists = build_lists(pos, vel, mass, **_build_kw(config))
    return eval_accel(lists, pos, mass, float(dt), **_eval_kw(config))


def build_diagnostics(pos, vel, mass, config):
    """Rebuild instrumentation (JAX ``build_diagnostics``): per-level
    worklist fills and pre-clamp demands against their caps, far-list
    occupancy and the residual's share of the mass, on an octree at full
    level capacities.  Returns a dict of host numbers."""
    from spatialsim_tpu_torch.config.nbody import resolve_config
    config = resolve_config(config, pos.shape[1])
    kw = _build_kw(config)
    n = pos.shape[1]
    gsz = kw["group_size"]
    max_depth = kw["max_depth"]
    npad = ((n + gsz - 1) // gsz) * gsz
    n_levels = max_depth - 2 + 1
    ng = npad // gsz
    budget = kw["worklist_budget"] or _auto_budget(npad)
    wl_caps = (tuple(kw["wl_caps"]) if kw["wl_caps"] else
               _default_wl_caps(ng, n_levels, budget,
                                c0=level_capacity(2, npad)))
    half, _, _, s_codes, s_pos, s_vel, s_mass, _ = _sort_state(
        pos, vel, mass, None, max_depth, gsz)
    tree = build_octree(s_codes, s_pos, s_mass, half, max_depth=max_depth,
                        start_level=2, n=npad, sorted_vel=s_vel,
                        with_quadrupole=kw["quadrupole"])
    gpos = s_pos.reshape(3, ng, gsz)
    bbox_min, bbox_max = gpos.amin(dim=2).T, gpos.amax(dim=2).T
    K = kw["near_groups"]
    near = (_select_near_groups(bbox_min, bbox_max, K, kw["window_groups"])
            if K > 0 else torch.zeros((ng, 0), dtype=_I32, device=pos.device))
    # Ranges emission: far_n, the residual and the worklist sizes do not
    # depend on the emission mode.
    out = _traverse_global(
        tree, bbox_min, bbox_max, ng, theta=float(kw["theta"]),
        soft_sq=float(kw["softening"]) ** 2, skin=float(kw["skin"]),
        gsz=gsz, intervals=_covered_intervals(near, kw["window_groups"], gsz),
        list_cap=kw["list_cap"], n_levels=n_levels, wl_caps=wl_caps,
        emit_values=False)
    far_n = out[2].cpu().numpy()
    wl = out[7].cpu().numpy()
    return {
        "n_levels": n_levels,
        "wl_caps": list(wl_caps),
        "wl_sizes": wl[:n_levels].tolist(),
        "wl_demand": wl[n_levels:].tolist(),
        "far_n_mean": float(far_n.mean()),
        "far_n_max": int(far_n.max()),
        "far_n_p99": float(np.percentile(far_n, 99)),
        "list_cap": kw["list_cap"],
        "groups_at_cap": int((far_n >= kw["list_cap"] - 1).sum()),
        "ng": ng,
        "residual_mass_frac": float(out[6][:, 0].sum())
        / max(float(s_mass.sum()), 1e-30),
        "cells_per_level": [int(lv.n_cells) for lv in tree.levels],
    }
