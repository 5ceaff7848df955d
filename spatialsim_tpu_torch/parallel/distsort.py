"""Distributed sample sort over the bodies axis (port of
``spatialsim_tpu/parallel/distsort.py``).

The sharded rebuild's sort: each rank sorts only its shard and ships
bodies straight to their owners, instead of gathering the whole unsorted
state and sorting all of it on every rank.

1. a stable local sort of the shard's Morton codes;
2. splitters from ``n_samples`` evenly spaced local codes, gathered from
   every rank and sorted (every rank picks the same ``size - 1``);
3. one :func:`~spatialsim_tpu_torch.parallel.collectives.all_to_all` of
   per-destination bins of a fixed capacity (the shard is sorted, so each
   bin is one contiguous run);
4. a stable sort of the received runs (bin sentinels sink to the end);
5. the exact rebalance to ``nl`` bodies a rank: global ranks from an
   exclusive scan of the received counts, the few boundary bodies from
   the two neighbours (two non-cyclic shifts).

Ties fall as in one stable global sort of the shards in rank order: by
code, then by rank, then by position in the shard.  A bin or the
rebalance that overflows its fixed capacity sets ``ok`` to False on every
rank (one max-reduction), and the caller falls back to a replicated sort:
correctness never depends on the sample.
"""

from __future__ import annotations

import torch

from spatialsim_tpu_torch.parallel.collectives import (
    all_gather, all_to_all, pmax, shift)


def _pad_bins(codes, vals_f, vals_i, dest, D, cap, big):
    """Locally sorted rows -> ``(D * cap)`` per-destination bins (codes
    ``big`` and zero payloads in the unused slots), and whether a bin
    overflowed.  ``dest`` ascends, so each destination is one run."""
    nl = codes.shape[0]
    dev = codes.device
    bstart = torch.searchsorted(dest, torch.arange(D, dtype=dest.dtype,
                                                   device=dev))
    bcount = torch.cat([bstart[1:], bstart.new_tensor([nl])]) - bstart
    ovf = bool((bcount > cap).any())
    k = torch.arange(cap, device=dev)
    valid = (k[None, :] < bcount[:, None]).reshape(-1)
    src = (bstart[:, None] + k[None, :]).clamp(0, nl - 1).reshape(-1)
    pc = torch.where(valid, codes[src], torch.full_like(codes[src], big))
    pf = torch.where(valid[None, :], vals_f[:, src], 0.0)
    pi = torch.where(valid[None, :], vals_i[:, src], 0)
    return pc, pf, pi, ovf


def sample_sort_local(codes_l, rows_f, rows_i, mesh, *, n_samples=128,
                      cap_factor=2.0):
    """This rank's part of the distributed sample sort.

    Args:
      codes_l: ``(nl,)`` integer Morton codes of this rank's bodies.
      rows_f: ``(F, nl)`` float32 payload rows (pos, vel, mass, acc...).
      rows_i: ``(I, nl)`` int32 payload rows (previous slot ids); integers
        travel as int32, never bit-cast through float rows.
      mesh: the bodies axis (:func:`~spatialsim_tpu_torch.parallel.mesh.
        make_mesh`); every rank has the same ``nl``.
    Returns:
      ``(codes, rows_f, rows_i, ok)``: this rank's exact ``nl``-body shard
      of the globally sorted order, and ``ok``, a Python bool equal on every
      rank (False: a fixed capacity overflowed and the shard is not valid).
    """
    D = mesh.size
    nl = codes_l.shape[0]
    dev = codes_l.device
    big = torch.iinfo(codes_l.dtype).max

    # 1. Local sort.
    o = torch.argsort(codes_l, stable=True)
    codes, vf, vi = codes_l[o], rows_f[:, o], rows_i[:, o]

    # 2. Splitters from evenly spaced samples of every rank.
    s_idx = (torch.arange(n_samples, device=dev) * nl) // n_samples + nl // (
        2 * n_samples)
    samp = codes[s_idx.clamp(0, nl - 1)]
    all_samp = torch.sort(all_gather(samp, mesh), stable=True).values
    sp_idx = (torch.arange(1, D, device=dev) * D * n_samples) // D
    splitters = all_samp[sp_idx]                               # (D - 1,)

    # 3. Contiguous destination runs -> fixed bins -> one exchange each.
    dest = torch.searchsorted(splitters, codes, right=True)
    cap = int(cap_factor * nl / D + 0.5)
    cap = max(64, ((cap + 7) // 8) * 8)
    pc, pf, pi, ovf1 = _pad_bins(codes, vf, vi, dest, D, cap, big)
    F, I = vf.shape[0], vi.shape[0]
    rc = all_to_all(pc, mesh)
    rf = all_to_all(pf.reshape(F, D, cap).transpose(0, 1), mesh).transpose(
        0, 1).reshape(F, D * cap)
    ri = all_to_all(pi.reshape(I, D, cap).transpose(0, 1), mesh).transpose(
        0, 1).reshape(I, D * cap)

    # 4. Merge the D sorted runs (sentinels sink).
    o2 = torch.argsort(rc, stable=True)
    rc, rf, ri = rc[o2], rf[:, o2], ri[:, o2]
    r_n = (rc != big).sum()

    # 5. Exact rebalance: the received run holds global ranks [o_b, o_b +
    # r_n), this rank owns [rank * nl, (rank + 1) * nl); the boundary
    # bodies come from the two neighbours.
    all_rn = all_gather(r_n, mesh)                             # (D,)
    o_b = int((torch.cumsum(all_rn, 0) - all_rn)[mesh.rank])
    r_n = int(r_n)
    H, DC = cap, D * cap
    start = max(r_n - H, 0)                 # the last H valid slots
    meta = torch.tensor([r_n, o_b], dtype=torch.int64, device=dev)
    fl_c, fl_f, fl_i, meta_l = shift(
        [rc[start:start + H], rf[:, start:start + H],
         ri[:, start:start + H], meta], mesh, +1)
    fr_c, fr_f, fr_i = shift([rc[:H], rf[:, :H], ri[:, :H]], mesh, -1)
    rn_l, ob_l = (int(v) for v in meta_l)    # the left neighbour's

    stage_c = torch.cat([fl_c, rc, fr_c])
    stage_f = torch.cat([fl_f, rf, fr_f], dim=1)
    stage_i = torch.cat([fl_i, ri, fr_i], dim=1)
    t = mesh.rank * nl + torch.arange(nl, device=dev)          # target ranks
    # from-left slot k holds the left neighbour's rank ob_l + max(rn_l -
    # H, 0) + k.
    left_rank0 = ob_l + max(rn_l - H, 0)
    s = torch.where(t < o_b, t - left_rank0,
                    torch.where(t < o_b + r_n, H + (t - o_b),
                                H + DC + (t - (o_b + r_n))))
    ovf2 = bool(((s < 0) | (s >= H + DC + H)).any())
    s = s.clamp(0, H + DC + H - 1)
    bad = torch.tensor([int(ovf1 or ovf2)], dtype=torch.int32, device=dev)
    ok = int(pmax(bad, mesh)[0]) == 0
    return stage_c[s], stage_f[:, s], stage_i[:, s], ok
