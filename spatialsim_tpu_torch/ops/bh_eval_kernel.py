"""Per-step window + pooled far-list evaluation (port of the pooled path of
``spatialsim_tpu/ops/bh_eval_kernel.py``).

For each Morton group of ``gsz`` sorted bodies: a direct sum over the
``2*wg+1`` window groups, plus the group's ``ceil(far_n/tile)`` pool tiles
from ``pstart[g]``, each far entry advanced to now as
``com + v*tau + a*coef2``.  Pair law ``m * rsqrt(d^2 + eps^2)^3`` gated on
``d^2 > eps^2``; G multiplies once at the end.

* :func:`window_eval_pool_reference` -- plain PyTorch, chunked over groups
  (a ``(ng, 256, 6144)`` pair tensor at 1M bodies would not fit).
* :func:`window_eval_pool` -- the wrapper of ``csrc/window_eval_pool.cu``.
  A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
  plain version.
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
