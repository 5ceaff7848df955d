"""Per-step window + far-list evaluation (port of
``spatialsim_tpu/ops/bh_eval_kernel.py``).

For each Morton group of ``gsz`` sorted bodies: a direct sum over the
``2*wg+1`` window groups (and, in the dense layout, over up to ``K`` near
groups), plus the group's far entries, each advanced to now as
``com + v*tau (+ a*coef2)``.  Pair law ``m * rsqrt(d^2 + eps^2)^3`` gated
on ``d^2 > eps^2``; quadrupole entries add ``-Q.d/r^5 + 2.5 (d^T Q d)
d/r^7``.  G multiplies once at the end.  Two far layouts:

* pooled ``(ct, 16, tile)`` tiles from ``pstart[g]`` (the default path):
  :func:`window_eval_pool_reference` (plain PyTorch) and
  :func:`window_eval_pool` (the wrapper of ``csrc/window_eval_pool.cu``);
* dense ``(ng, R, L)`` rows (above 20.5M bodies, and for the quadrupole):
  :func:`window_eval_reference` and :func:`window_eval` (the wrapper of
  ``csrc/window_eval.cu``).

A wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain version for CPU tensors.  The plain versions chunk over groups (a
``(ng, 256, 6144)`` pair tensor at 1M bodies would not fit).
"""

from __future__ import annotations

import numpy as np
import torch

from spatialsim_tpu_torch import _kernels

POOL_ROWS = 16
# Pairwise temporaries per chunk stay near 2^24 elements (64 MB each).
_PAIRS_PER_CHUNK = 1 << 24


def advance_coefs(steps_since: int, dt: float, tau_clamp: float):
    """(tau, coef2) as Python floats, computed in float32 like the JAX
    package: ``tau = steps*dt``, ``t_c = min(tau, tau_clamp*dt)``,
    ``coef2 = t_c*tau - t_c^2/2``."""
    f = np.float32
    tau = f(steps_since) * f(dt)
    tc = min(tau, f(tau_clamp) * f(dt))
    coef2 = tc * tau - f(0.5) * tc * tc
    return float(tau), float(coef2)


def window_eval_pool_reference(s_pos, s_mass, pool, pstart, far_n,
                               steps_since, dt, *, G, softening,
                               group_size=256, window_groups=2,
                               tau_clamp=24.0):
    """Plain-tensor window + pooled far-list accelerations.

    Args:
      s_pos: ``(3, npad)`` f32, Morton-sorted, ``npad = ng * group_size``.
      s_mass: ``(npad,)`` f32 (padding bodies carry mass 0).
      pool: ``(ct, 16, tile)`` f32; ``pstart``/``far_n``: ``(ng,)`` int.
      steps_since: int steps since the build; ``dt``: float step.
    Returns:
      ``(3, npad)`` f32 accelerations in sorted order.

    Each group's tiles are gathered (index clamped to the pool's last
    tile, as in the kernel) into a dense block whose tiles past
    ``ceil(far_n/tile)`` get mass 0; chunks of groups bound the pairwise
    temporaries.
    """
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    gsz, wg = group_size, window_groups
    npad = s_pos.shape[1]
    ng = npad // gsz
    ct, _, tile = pool.shape
    soft_sq = float(softening) ** 2
    dev = s_pos.device

    P4 = torch.cat([s_pos, s_mass[None, :]], dim=0)
    P4 = torch.nn.functional.pad(P4, (wg * gsz, wg * gsz))
    n_t = (far_n.to(torch.int64) + tile - 1) // tile
    T = max(1, int(n_t.max()))
    S = (2 * wg + 1) * gsz + T * tile
    chunk = max(1, _PAIRS_PER_CHUNK // (gsz * S))
    out = torch.empty_like(s_pos)
    t_ar = torch.arange(T, dtype=torch.int64, device=dev)
    for g0 in range(0, ng, chunk):
        g1 = min(ng, g0 + chunk)
        C = g1 - g0
        tgt = s_pos[:, g0 * gsz:g1 * gsz].reshape(3, C, gsz)
        win = torch.cat([P4[:, (g0 + k) * gsz:(g1 + k) * gsz]
                         .reshape(4, C, 1, gsz) for k in range(2 * wg + 1)],
                        dim=2).reshape(4, C, (2 * wg + 1) * gsz)
        tidx = (pstart[g0:g1].to(torch.int64)[:, None] + t_ar).clamp(0, ct - 1)
        tl = pool[tidx]                                   # (C, T, 16, tile)
        fx = tl[:, :, 0] + tl[:, :, 3] * tau + tl[:, :, 7] * coef2
        fy = tl[:, :, 1] + tl[:, :, 4] * tau + tl[:, :, 8] * coef2
        fz = tl[:, :, 2] + tl[:, :, 5] * tau + tl[:, :, 9] * coef2
        keep = (t_ar[None, :] < n_t[g0:g1, None])[:, :, None]
        fm = torch.where(keep, tl[:, :, 6], torch.zeros_like(fx))
        far = torch.stack([fx, fy, fz, fm]).reshape(4, C, T * tile)
        src = torch.cat([win, far], dim=2)                # (4, C, S)
        dx = src[0][:, None, :] - tgt[0][:, :, None]      # (C, gsz, S)
        dy = src[1][:, None, :] - tgt[1][:, :, None]
        dz = src[2][:, None, :] - tgt[2][:, :, None]
        dist_sq = dx * dx + dy * dy + dz * dz + soft_sq
        inv = torch.rsqrt(dist_sq)
        w = torch.where(dist_sq > soft_sq,
                        src[3][:, None, :] * (inv * inv * inv),
                        torch.zeros_like(dist_sq))
        acc = torch.stack([(w * dx).sum(dim=2), (w * dy).sum(dim=2),
                           (w * dz).sum(dim=2)]) * G      # (3, C, gsz)
        out[:, g0 * gsz:g1 * gsz] = acc.reshape(3, C * gsz)
    return out


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def window_eval_pool(s_pos, s_mass, pool, pstart, far_n, steps_since, dt, *,
                     G, softening, group_size=256, window_groups=2,
                     tau_clamp=24.0):
    """Window + pooled far-list accelerations through the CUDA kernel.

    Same arguments and result as :func:`window_eval_pool_reference`
    (``pstart``/``far_n`` must be int32).  CPU tensors take the plain
    version.  CUDA tensors launch ``csrc/window_eval_pool.cu`` -- one block
    of ``group_size`` threads per group -- on the current stream without
    synchronising, and add one to ``window_eval_pool.launches``.
    """
    dev = s_pos.device
    if dev.type == "cpu":
        return window_eval_pool_reference(
            s_pos, s_mass, pool, pstart, far_n, steps_since, dt, G=G,
            softening=softening, group_size=group_size,
            window_groups=window_groups, tau_clamp=tau_clamp)
    if dev.type != "cuda":
        raise ValueError(f"window_eval_pool: unsupported device {dev}")
    gsz = int(group_size)
    npad = s_pos.shape[1]
    if gsz < 1 or gsz > 1024 or npad % gsz:
        raise ValueError(f"group_size {gsz} must divide npad {npad} and "
                         f"be <= 1024 (one thread per body)")
    ng = npad // gsz
    ct, rows, tile = pool.shape
    if rows != POOL_ROWS or ct < 1 or tile < 1:
        raise ValueError(f"pool must be (ct>=1, 16, tile), got {pool.shape}")
    _check("s_pos", s_pos, (3, npad), torch.float32, dev)
    _check("s_mass", s_mass, (npad,), torch.float32, dev)
    _check("pool", pool, (ct, rows, tile), torch.float32, dev)
    _check("pstart", pstart, (ng,), torch.int32, dev)
    _check("far_n", far_n, (ng,), torch.int32, dev)
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    out = torch.empty_like(s_pos)
    lib = _kernels.library()
    err = lib.spatialsim_window_eval_pool(
        s_pos.data_ptr(), s_mass.data_ptr(), pool.data_ptr(),
        pstart.data_ptr(), far_n.data_ptr(), out.data_ptr(), npad, ng, gsz,
        int(window_groups), ct, tile, float(softening) ** 2, float(G), tau,
        coef2, _kernels.stream_ptr(dev))
    _kernels.check(err, "window_eval_pool")
    window_eval_pool.launches += 1
    return out


window_eval_pool.launches = 0


# ---------------------------------------------------------------------------
# Dense (ng, R, L) layout
# ---------------------------------------------------------------------------

DENSE_ROWS = (8, 10, 13, 16)


def far_layout(n_rows: int):
    """(quadrupole?, acc_row_offset | None) of a dense far tensor's rows:
    8 = [com3, v3, m, pad]; 10 adds the mean acceleration (rows 7:10); 13
    = monopole + traceless quadrupole (7:13); 16 = both (acc 13:16)."""
    quad = n_rows in (13, 16)
    acc0 = (13 if quad else 7) if n_rows in (10, 16) else None
    return quad, acc0


def _mono_sum(tx, ty, tz, sx, sy, sz, sm, soft_sq):
    """Monopole sums of sources ``(C, S)`` onto targets ``(C, gsz)`` by
    direct coordinate differences; returns three ``(C, gsz)``."""
    dx = sx[:, None, :] - tx[:, :, None]
    dy = sy[:, None, :] - ty[:, :, None]
    dz = sz[:, None, :] - tz[:, :, None]
    r2 = dx * dx + dy * dy + dz * dz + soft_sq
    inv = torch.rsqrt(r2)
    w = torch.where(r2 > soft_sq, sm[:, None, :] * (inv * inv * inv),
                    torch.zeros_like(r2))
    return (w * dx).sum(2), (w * dy).sum(2), (w * dz).sum(2)


def _quad_sum(tx, ty, tz, sx, sy, sz, sm, q6, soft_sq):
    """Monopole + traceless-quadrupole sums (``_pair_accum_quad``):
    ``m d/r^3 - Q.d/r^5 + 2.5 (d^T Q d) d/r^7``, d = source - target;
    ``q6``: (qxx, qyy, qzz, qxy, qxz, qyz), each ``(C, S)``."""
    dx = sx[:, None, :] - tx[:, :, None]
    dy = sy[:, None, :] - ty[:, :, None]
    dz = sz[:, None, :] - tz[:, :, None]
    r2 = dx * dx + dy * dy + dz * dz + soft_sq
    inv = torch.rsqrt(r2)
    inv2 = inv * inv
    inv3 = torch.where(r2 > soft_sq, inv * inv2, torch.zeros_like(r2))
    qxx, qyy, qzz, qxy, qxz, qyz = (q[:, None, :] for q in q6)
    qdx = qxx * dx + qxy * dy + qxz * dz
    qdy = qxy * dx + qyy * dy + qyz * dz
    qdz = qxz * dx + qyz * dy + qzz * dz
    dqd = dx * qdx + dy * qdy + dz * qdz
    inv5 = inv3 * inv2
    cw = sm[:, None, :] * inv3 + 2.5 * dqd * inv5 * inv2
    return ((cw * dx - inv5 * qdx).sum(2), (cw * dy - inv5 * qdy).sum(2),
            (cw * dz - inv5 * qdz).sum(2))


def window_eval_reference(s_pos, s_mass, far, far_n, near=None,
                          steps_since=0, dt=0.0, *, G, softening,
                          group_size=256, window_groups=2, tau_clamp=24.0,
                          groups=None):
    """Plain-tensor window + near groups + dense far-list accelerations.

    Args:
      s_pos: ``(3, npad)`` f32, Morton-sorted, ``npad = ng * group_size``.
      s_mass: ``(npad,)`` f32 (padding bodies carry mass 0).
      far: ``(ng, R, L)`` f32 stored entries, rows per :func:`far_layout`.
      far_n: ``(ng,)`` int entries per group (those past it are not read).
      near: ``(ng, K)`` int group ids, or None; an id < 0 or >= ng is none.
      groups: optional 1-D group ids; then only their bodies are computed.
    Returns:
      ``(3, npad)`` f32 accelerations in sorted order, or ``(3,
      len(groups) * group_size)`` for ``groups``, group by group.

    Window groups past either end and "none" near ids read a zero block,
    as the TPU kernel does.  Chunks of groups bound the pairwise
    temporaries near ``_PAIRS_PER_CHUNK`` elements.
    """
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    gsz, wg = group_size, window_groups
    npad = s_pos.shape[1]
    ng = npad // gsz
    R, L = far.shape[1], far.shape[2]
    quad, acc0 = far_layout(R)
    soft_sq = float(softening) ** 2
    dev = s_pos.device
    K = 0 if near is None else near.shape[1]
    gids = (torch.arange(ng, device=dev) if groups is None
            else torch.as_tensor(groups, device=dev).long().reshape(-1))
    # Block h of P4 holds group h - wg; block ng + 2*wg is all zero.
    P4 = torch.nn.functional.pad(torch.cat([s_pos, s_mass[None, :]], 0),
                                 (wg * gsz, (wg + 1) * gsz))
    zero_block = ng + 2 * wg
    n_use = far_n.long().clamp(0, L)
    Lm = max(1, int(n_use[gids].max()))
    S = (2 * wg + 1 + K) * gsz + Lm
    chunk = max(1, _PAIRS_PER_CHUNK // (gsz * S))
    lane = torch.arange(gsz, device=dev)
    slot = torch.arange(Lm, device=dev)
    out = torch.empty((3, gids.numel() * gsz), dtype=s_pos.dtype, device=dev)
    for c0 in range(0, gids.numel(), chunk):
        g = gids[c0:c0 + chunk]
        C = g.numel()
        t = s_pos[:, (g[:, None] * gsz + lane).reshape(-1)].reshape(3, C, gsz)
        blocks = [g + k for k in range(2 * wg + 1)]
        if K:
            nb = near[g].long()
            blocks += list(torch.where((nb >= 0) & (nb < ng), nb + wg,
                                       torch.full_like(nb, zero_block)).T)
        cols = (torch.stack(blocks, 1)[:, :, None] * gsz + lane).reshape(C, -1)
        src = P4[:, cols]                                  # (4, C, nb*gsz)
        acc = list(_mono_sum(t[0], t[1], t[2], src[0], src[1], src[2],
                             src[3], soft_sq))
        fe = far[g, :, :Lm]                                # (C, R, Lm)
        keep = slot[None, :] < n_use[g][:, None]
        fp = [fe[:, r] + fe[:, 3 + r] * tau for r in range(3)]
        if acc0 is not None:
            fp = [fp[r] + fe[:, acc0 + r] * coef2 for r in range(3)]
        fm = torch.where(keep, fe[:, 6], torch.zeros_like(fe[:, 6]))
        if quad:
            q6 = [torch.where(keep, fe[:, 7 + r], torch.zeros_like(fm))
                  for r in range(6)]
            fa = _quad_sum(t[0], t[1], t[2], *fp, fm, q6, soft_sq)
        else:
            fa = _mono_sum(t[0], t[1], t[2], *fp, fm, soft_sq)
        out[:, c0 * gsz:(c0 + C) * gsz] = torch.stack(
            [(a + b) * G for a, b in zip(acc, fa)]).reshape(3, C * gsz)
    return out


def window_eval(s_pos, s_mass, far, far_n, near=None, steps_since=0, dt=0.0,
                *, G, softening, group_size=256, window_groups=2,
                tau_clamp=24.0):
    """Window + near groups + dense far-list accelerations through the
    CUDA kernel.

    Same arguments and result as :func:`window_eval_reference` (no
    ``groups``; ``far_n`` and ``near`` must be int32).  CPU tensors take
    the plain version.  CUDA tensors launch ``csrc/window_eval.cu`` -- one
    block of ``group_size`` threads per group -- on the current stream
    without synchronising, and add one to ``window_eval.launches``.
    """
    dev = s_pos.device
    if dev.type == "cpu":
        return window_eval_reference(
            s_pos, s_mass, far, far_n, near, steps_since, dt, G=G,
            softening=softening, group_size=group_size,
            window_groups=window_groups, tau_clamp=tau_clamp)
    if dev.type != "cuda":
        raise ValueError(f"window_eval: unsupported device {dev}")
    gsz = int(group_size)
    npad = s_pos.shape[1]
    if gsz < 1 or gsz > 1024 or npad % gsz:
        raise ValueError(f"group_size {gsz} must divide npad {npad} and "
                         f"be <= 1024 (one thread per body)")
    ng = npad // gsz
    if far.dim() != 3 or far.shape[0] != ng or far.shape[1] not in DENSE_ROWS:
        raise ValueError(f"far must be (ng={ng}, R in {DENSE_ROWS}, L), got "
                         f"{tuple(far.shape)}")
    R, L = far.shape[1], far.shape[2]
    _check("s_pos", s_pos, (3, npad), torch.float32, dev)
    _check("s_mass", s_mass, (npad,), torch.float32, dev)
    _check("far", far, (ng, R, L), torch.float32, dev)
    _check("far_n", far_n, (ng,), torch.int32, dev)
    K = 0
    if near is not None:
        K = near.shape[1] if near.dim() == 2 else -1
        _check("near", near, (ng, K), torch.int32, dev)
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    out = torch.empty_like(s_pos)
    lib = _kernels.library()
    err = lib.spatialsim_window_eval(
        s_pos.data_ptr(), s_mass.data_ptr(), far.data_ptr(),
        far_n.data_ptr(), near.data_ptr() if K else None, out.data_ptr(),
        npad, ng, gsz, int(window_groups), K, R, L, float(softening) ** 2,
        float(G), tau, coef2, _kernels.stream_ptr(dev))
    _kernels.check(err, "window_eval")
    window_eval.launches += 1
    return out


window_eval.launches = 0
