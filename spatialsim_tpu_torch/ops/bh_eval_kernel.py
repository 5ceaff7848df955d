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
* dense ``(ng, R, L)`` rows (above 20.5M bodies, the quadrupole and near
  groups): :func:`window_eval_reference` and :func:`window_eval` (the
  wrapper of ``csrc/window_eval.cu``), which also selects the two other
  forms of the JAX package's dense call for monopole rows:

  - the column form (``use_cols``): the same pair law, summed into 8
    interleaved partial sums per target (source index mod 8) that are
    added once per group, over whole ``far_tile`` tiles of entries:
    :func:`window_eval_cols_reference` and :func:`window_eval_cols`
    (``csrc/window_eval_cols.cu``);
  - the matrix form (``use_mxu``): ``a = G (sum w s_c - t_c sum w)`` on
    coordinates centred on the group's mean, with ``d^2 = |t_c|^2 +
    |s_c|^2 - 2 t_c.s_c + eps^2`` and ``w = m rsqrt(max(d^2, eps^2))^3``
    (no gate: the self pair cancels): :func:`window_eval_mxu_reference` and
    :func:`window_eval_mxu` (``csrc/window_eval_mxu.cu``).  It is its own
    function, not the row form's: its d^2 cancels in float32.  Its kernel
    has two instances, the register tile and a split-TF32 contraction on
    tensor cores; :func:`mxu_plan` picks one, :func:`mxu_launch` takes it
    explicitly.

The row form also takes the JAX package's stage ablation, ``dbg``
(:func:`dbg_flags`): the window loop, the targets or the output's
layout switched off one at a time, for measuring where a kernel's time
goes (``tools/decide7.py``); the CUDA kernel runs it in instances of its
own, counted in ``window_eval.dbg_launches``.

The dense forms take the JAX package's call modes (:func:`eval_mode`):
``haloed`` (the source carries ``window_groups`` halo groups on each side
of the evaluated shard) and ``local_slice=(group_offset, n_groups)`` (one
group range of the whole sorted state); the sharded window step
(``spatialsim_tpu_torch/parallel/sharded.py``) evaluates its shard so.

A wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain version for CPU tensors.  The plain versions chunk over groups (a
``(ng, 256, 6144)`` pair tensor at 1M bodies would not fit).  The pooled
kernel and the dense row and column kernels hold T targets a thread
(``csrc/window_eval_tile.cuh``) and launch heavy groups first:
:func:`tile_targets` (row forms) and :func:`cols_plan` pick T from fixed
tables, :func:`heavy_first` the block order, and :func:`pool_launch` /
:func:`dense_launch` / :func:`cols_launch` take both explicitly, for the
card tests and ``chip_smoke.py``'s comparisons.
"""

from __future__ import annotations

import weakref

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


# Targets a thread holds (T) in the pooled and dense row-form kernels
# (csrc/window_eval_tile.cuh), by group size and quadrupole rows: a group
# runs as group_size / T threads.  Chosen by timing T 1, 2, 4 and 8, heavy
# groups first, on an H100 at the main path's shapes (PERF.md, kernels 2
# and 3): at 1M bodies (group 256, 2-4 waves) a larger T lengthens the
# heaviest blocks, at 50M (group 1024, ~120 waves) T 4 and 8 tie; the
# kernels have no T = 8 instance.
_TILE_TARGETS = {(256, False): 2, (1024, False): 4,
                 (256, True): 2, (1024, True): 2}


def tile_targets(group_size: int, rows: int = 8) -> int:
    """T for groups of ``group_size`` with ``rows`` far rows (8 for the
    pool): the table's entry, else 2, halved until it divides the group
    size."""
    t = _TILE_TARGETS.get((int(group_size), rows in (13, 16)), 2)
    while group_size % t:
        t //= 2
    return t


def heavy_first(far_n, near=None, group_size=0, tiles=None):
    """Group ids by their sources, most first (ties by id): far_n (with
    ``tiles = (L, tile)``, rounded up to whole tiles and capped at L, as
    the column kernel reads them), plus ``group_size`` for each near id in
    range.  The launch order that puts the longest blocks in the first
    wave, so none of them is left to run alone at the end."""
    work = (far_n.to(torch.int64) if tiles is None
            else _tile_counts(far_n, *tiles))
    if near is not None:
        ng = far_n.shape[0]
        work = work + group_size * ((near >= 0) & (near < ng)).sum(1)
    return torch.argsort(work, descending=True, stable=True).to(torch.int32)


class _OrderCache:
    """The heavy-first order of the last lists a wrapper saw, kept while
    their ``far_n`` (and ``near``) tensors live unchanged: lists change at
    a rebuild, so the sort runs once per rebuild, not once per step."""

    def __init__(self):
        self.refs, self.key, self.order = (None, None), None, None

    def __call__(self, far_n, near=None, group_size=0, tiles=None):
        tensors = (far_n, near)
        key = tuple(None if t is None else t._version for t in tensors) + (
            group_size, tiles)
        if self.key != key or any((r() if r else None) is not t
                                  for r, t in zip(self.refs, tensors)):
            self.order = heavy_first(far_n, near, group_size, tiles)
            self.refs = tuple(None if t is None else weakref.ref(t)
                              for t in tensors)
            self.key = key
        return self.order


def _group_args(s_pos, group_size):
    gsz = int(group_size)
    npad = s_pos.shape[1]
    if gsz < 1 or gsz > 1024 or npad % gsz:
        raise ValueError(f"group_size {gsz} must divide npad {npad} and "
                         f"be <= 1024")
    return npad, npad // gsz, gsz


def window_eval_pool(s_pos, s_mass, pool, pstart, far_n, steps_since, dt, *,
                     G, softening, group_size=256, window_groups=2,
                     tau_clamp=24.0):
    """Window + pooled far-list accelerations through the CUDA kernel.

    Same arguments and result as :func:`window_eval_pool_reference`
    (``pstart``/``far_n`` must be int32).  CPU tensors take the plain
    version.  CUDA tensors launch ``csrc/window_eval_pool.cu`` -- one block
    of ``group_size / T`` threads per group, T targets a thread
    (:func:`tile_targets`), heavy groups first (:func:`heavy_first`,
    sorted once per lists) -- on the current stream without synchronising,
    and add one to ``window_eval_pool.launches``.
    """
    if s_pos.device.type == "cpu":
        return window_eval_pool_reference(
            s_pos, s_mass, pool, pstart, far_n, steps_since, dt, G=G,
            softening=softening, group_size=group_size,
            window_groups=window_groups, tau_clamp=tau_clamp)
    return pool_launch(s_pos, s_mass, pool, pstart, far_n, steps_since, dt,
                       G=G, softening=softening, group_size=group_size,
                       window_groups=window_groups, tau_clamp=tau_clamp,
                       targets=tile_targets(group_size),
                       order=_pool_order(far_n))


_pool_order = _OrderCache()


def pool_launch(s_pos, s_mass, pool, pstart, far_n, steps_since, dt, *, G,
                softening, group_size, window_groups, tau_clamp, targets,
                order=None):
    """Launch ``csrc/window_eval_pool.cu`` with ``targets`` (T) targets a
    thread and blocks in ``order`` (int32 group ids; None: group i is block
    i) on checked CUDA inputs; adds one to ``window_eval_pool.launches``."""
    dev = s_pos.device
    if dev.type != "cuda":
        raise ValueError(f"window_eval_pool: unsupported device {dev}")
    npad, ng, gsz = _group_args(s_pos, group_size)
    ct, rows, tile = pool.shape
    if rows != POOL_ROWS or ct < 1 or tile < 1:
        raise ValueError(f"pool must be (ct>=1, 16, tile), got {pool.shape}")
    _check("s_pos", s_pos, (3, npad), torch.float32, dev)
    _check("s_mass", s_mass, (npad,), torch.float32, dev)
    _check("pool", pool, (ct, rows, tile), torch.float32, dev)
    _check("pstart", pstart, (ng,), torch.int32, dev)
    _check("far_n", far_n, (ng,), torch.int32, dev)
    if order is not None:
        _check("order", order, (ng,), torch.int32, dev)
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    out = torch.empty_like(s_pos)
    err = _kernels.entry.spatialsim_window_eval_pool(
        s_pos.data_ptr(), s_mass.data_ptr(), pool.data_ptr(),
        pstart.data_ptr(), far_n.data_ptr(),
        None if order is None else order.data_ptr(), out.data_ptr(), npad,
        ng, gsz, int(targets), int(window_groups), ct, tile,
        float(softening) ** 2, float(G), tau, coef2, _kernels.stream(s_pos))
    if err:
        _kernels.fail(err, "window_eval_pool")
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




def _dense_chunks(s_pos, s_mass, near, n_far, gsz, wg, groups, g0=0,
                  ng=None):
    """Chunks of the dense eval's groups, for the plain versions.

    Yields ``(c0, g, t, src)``: the chunk's offset in the output, its group
    ids ``g`` (C,), targets ``t`` ``(3, C, gsz)`` and window + near sources
    ``src`` ``(4, C, (2*wg+1+K)*gsz)`` rows [x, y, z, m].  Group g of the
    output (``ng`` groups, all of the source's by default) reads source
    group ``g + g0`` as its targets and source groups ``g + g0 - wg .. g +
    g0 + wg`` as its window (:func:`eval_mode`).  Window groups past either
    end of the source and "none" near ids (< 0 or past the source) read a
    zero block, as the TPU kernel does.  ``n_far`` far slots a group bound
    the chunk so that pairwise temporaries stay near ``_PAIRS_PER_CHUNK``
    elements.
    """
    dev = s_pos.device
    ngs = s_pos.shape[1] // gsz
    ng = ngs if ng is None else ng
    K = 0 if near is None else near.shape[1]
    gids = (torch.arange(ng, device=dev) if groups is None
            else torch.as_tensor(groups, device=dev).long().reshape(-1))
    # Block h of P4 holds source group h - wg; block ngs + 2*wg is all zero.
    P4 = torch.nn.functional.pad(torch.cat([s_pos, s_mass[None, :]], 0),
                                 (wg * gsz, (wg + 1) * gsz))
    zero_block = ngs + 2 * wg
    S = (2 * wg + 1 + K) * gsz + n_far
    chunk = max(1, _PAIRS_PER_CHUNK // (gsz * S))
    lane = torch.arange(gsz, device=dev)
    for c0 in range(0, gids.numel(), chunk):
        g = gids[c0:c0 + chunk]
        C = g.numel()
        t = s_pos[:, ((g + g0)[:, None] * gsz + lane).reshape(-1)].reshape(
            3, C, gsz)
        blocks = [g + g0 + k for k in range(2 * wg + 1)]
        if K:
            nb = near[g].long()
            blocks += list(torch.where((nb >= 0) & (nb < ngs), nb + wg,
                                       torch.full_like(nb, zero_block)).T)
        cols = (torch.stack(blocks, 1)[:, :, None] * gsz + lane).reshape(C, -1)
        yield c0, g, t, P4[:, cols]


def eval_mode(npad, group_size, window_groups, near=None, haloed=False,
              local_slice=None):
    """``(g0, ng, ngs)`` of a dense eval over a source of ``npad`` slots:
    output group g reads source group ``g + g0``, for ``ng`` groups out of
    the source's ``ngs``.  The JAX package's call modes:

    * neither: the whole source, ``g0 = 0``, ``ng = ngs``;
    * ``haloed``: the source carries ``window_groups`` halo groups on each
      side of the evaluated shard, ``g0 = wg``, ``ng = ngs - 2*wg``;
    * ``local_slice = (group_offset, n_groups)``: that group range of the
      global sorted source.

    Window groups outside the source read zero blocks.  Both modes refuse
    near groups, as the JAX package does: near ids index the full state.
    """
    gsz, wg = int(group_size), int(window_groups)
    ngs = npad // gsz
    if haloed and local_slice is not None:
        raise ValueError("haloed and local_slice are mutually exclusive")
    if haloed:
        g0, ng = wg, ngs - 2 * wg
    elif local_slice is not None:
        g0, ng = (int(v) for v in local_slice)
    else:
        return 0, ngs, ngs
    if ng < 1 or g0 < 0 or g0 + ng > ngs:
        raise ValueError(f"groups [{g0}, {g0 + ng}) do not lie in the "
                         f"source's {ngs} groups")
    if near is not None and near.shape[1] > 0:
        raise ValueError("near groups require the full-state eval path "
                         "(neither haloed nor local_slice)")
    return g0, ng, ngs


def _far_sources(far, g, n_use, n_slots, tau, coef2):
    """Stored far entries of groups ``g``, slots ``[0, n_slots)``, advanced
    to now: ``(fx, fy, fz)``, the mass with slots past ``n_use`` zeroed,
    and the quadrupole rows (None for monopole rows), each ``(C, n_slots)``.
    """
    R = far.shape[1]
    quad, acc0 = far_layout(R)
    fe = far[g, :, :n_slots]                                  # (C, R, n)
    keep = (torch.arange(n_slots, device=far.device)[None, :]
            < n_use[g][:, None])
    fp = [fe[:, r] + fe[:, 3 + r] * tau for r in range(3)]
    if acc0 is not None:
        fp = [fp[r] + fe[:, acc0 + r] * coef2 for r in range(3)]
    fm = torch.where(keep, fe[:, 6], torch.zeros_like(fe[:, 6]))
    q6 = ([torch.where(keep, fe[:, 7 + r], torch.zeros_like(fm))
           for r in range(6)] if quad else None)
    return fp, fm, q6


# The stage-ablation flags of the row form (``_eval_kernel``'s ``dbg``),
# and the bit each sets in the CUDA kernel's flags word (``nostage`` has no
# stage of its own on the card: :func:`dbg_flags`).
DBG_BITS = {"nowin": 1, "nostage": 0, "notgt": 2, "nouttr": 4}


def dbg_flags(dbg: str) -> frozenset:
    """The set of stage-ablation flags in ``dbg``, comma-separated:

    * ``nowin``: the group's own Morton window is not summed (the near
      groups and the far list are);
    * ``nostage``: the TPU kernel does not copy the window into the
      scratch that only its window loop reads, so it is defined only with
      ``nowin`` (alone it reads an unwritten scratch) and then changes
      nothing: alone it raises ``ValueError``;
    * ``notgt``: every target is (0, 0, 0.5);
    * ``nouttr``: each block of :func:`ablate_block` targets of a group
      gets ``G * sum(ax + ay + az)`` over the block in all three rows.

    An unknown flag raises ``ValueError``."""
    flags = frozenset(f.strip() for f in dbg.split(",") if f.strip())
    unknown = flags - set(DBG_BITS)
    if unknown:
        raise ValueError(f"dbg: unknown flags {sorted(unknown)}; the "
                         f"flags are {sorted(DBG_BITS)}")
    if "nostage" in flags and "nowin" not in flags:
        raise ValueError("dbg: 'nostage' needs 'nowin': it skips the copy "
                         "of the window into a scratch that only the window "
                         "loop reads, so without 'nowin' the TPU kernel "
                         "sums an unwritten scratch")
    return flags


def ablate_block(group_size: int) -> int:
    """Targets a ``nouttr`` sum covers: the TPU kernel's default target
    block, the whole group up to 512, else 256."""
    return int(group_size) if group_size <= 512 else 256


def _block_sums(acc, gsz, G):
    """``nouttr``'s output from the accumulators ``acc`` (three ``(C,
    gsz)``, without G): ``G * sum(ax + ay + az)`` over each block of
    :func:`ablate_block` targets, in all three rows of the block's
    targets; ``(3, C * gsz)``."""
    v = (acc[0] + acc[1]) + acc[2]
    iblk = ablate_block(gsz)
    nb = -(-gsz // iblk)
    v = torch.nn.functional.pad(v, (0, nb * iblk - gsz))
    s = v.reshape(v.shape[0], nb, iblk).sum(2) * G
    s = s.repeat_interleave(iblk, dim=1)[:, :gsz].reshape(-1)
    return torch.stack([s, s, s])


def window_eval_reference(s_pos, s_mass, far, far_n, near=None,
                          steps_since=0, dt=0.0, *, G, softening,
                          group_size=256, window_groups=2, tau_clamp=24.0,
                          groups=None, haloed=False, local_slice=None,
                          dbg=""):
    """Plain-tensor window + near groups + dense far-list accelerations:
    the row form, ``_eval_kernel``.

    Args:
      s_pos: ``(3, npad)`` f32, Morton-sorted, ``npad = ng * group_size``.
      s_mass: ``(npad,)`` f32 (padding bodies carry mass 0).
      far: ``(ng, R, L)`` f32 stored entries, rows per :func:`far_layout`.
      far_n: ``(ng,)`` int entries per group (those past it are not read).
      near: ``(ng, K)`` int group ids, or None; an id < 0 or >= ng is none.
      groups: optional 1-D group ids; then only their bodies are computed.
      haloed, local_slice: the JAX package's call modes (:func:`eval_mode`);
        then ``far``, ``far_n`` and ``groups`` cover the ``ng`` evaluated
        groups.
      dbg: stage-ablation flags (:func:`dbg_flags`); "" is the function.
    Returns:
      ``(3, ng * group_size)`` f32 accelerations in sorted order (``ng``
      the evaluated groups: all of them without a mode), or ``(3,
      len(groups) * group_size)`` for ``groups``, group by group.
    """
    flags = dbg_flags(dbg)
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    gsz = group_size
    n_win = (2 * window_groups + 1) * gsz
    g0, ng, _ = eval_mode(s_pos.shape[1], gsz, window_groups, near, haloed,
                          local_slice)
    L = far.shape[2]
    soft_sq = float(softening) ** 2
    n_use = far_n.long().clamp(0, L)
    gsel = (n_use if groups is None else
            n_use[torch.as_tensor(groups, device=far.device).long()])
    Lm = max(1, int(gsel.max()))
    out = []
    for _, g, t, src in _dense_chunks(s_pos, s_mass, near, Lm, gsz,
                                      window_groups, groups, g0, ng):
        if "notgt" in flags:
            t = torch.tensor([0.0, 0.0, 0.5], dtype=t.dtype,
                             device=t.device)[:, None, None].expand_as(t)
        if "nowin" in flags:
            src = src[:, :, n_win:]
        acc = _mono_sum(t[0], t[1], t[2], src[0], src[1], src[2], src[3],
                        soft_sq)
        fp, fm, q6 = _far_sources(far, g, n_use, Lm, tau, coef2)
        fa = (_quad_sum(t[0], t[1], t[2], *fp, fm, q6, soft_sq)
              if q6 is not None else
              _mono_sum(t[0], t[1], t[2], *fp, fm, soft_sq))
        acc = [a + b for a, b in zip(acc, fa)]
        out.append(_block_sums(acc, gsz, G) if "nouttr" in flags else
                   torch.stack([a * G for a in acc]).reshape(3, -1))
    return torch.cat(out, dim=1)


def _tile_counts(far_n, L, far_tile):
    """Far slots the column and matrix forms read per group: whole tiles
    of ``min(far_tile, L)`` entries up to ``far_n``, clamped to ``L``."""
    tile = min(int(far_tile), L)
    n = (far_n.long().clamp(0, L) + tile - 1) // tile * tile
    return n.clamp(max=L)


def _check_cols(L, gsz, far_tile):
    if L % 8 or gsz % 8 or min(int(far_tile), L) % 8:
        raise ValueError(f"the column form sums sources in runs of 8: the "
                         f"list cap {L}, the group size {gsz} and the far "
                         f"tile {far_tile} must be multiples of 8")


def window_eval_cols_reference(s_pos, s_mass, far, far_n, near=None,
                               steps_since=0, dt=0.0, *, G, softening,
                               group_size=256, window_groups=2,
                               tau_clamp=24.0, far_tile=512, haloed=False,
                               local_slice=None):
    """Plain-tensor column form (``_eval_kernel_cols``), monopole rows
    (R 8/10).

    The row form's pair law, gated on ``d^2 > eps^2``, over the window,
    the near groups and whole ``far_tile`` tiles of stored entries (slots
    past ``far_n`` inside the last tile are read as stored; the build
    leaves them zero).  Every target sums its sources into 8 partial sums
    by source index mod 8 (within the window and near blocks, and within
    the far list) and adds the 8 once at the end.  Arguments, modes and
    result as :func:`window_eval_reference` (no ``groups``).
    """
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    gsz = group_size
    g0, ng, _ = eval_mode(s_pos.shape[1], gsz, window_groups, near, haloed,
                          local_slice)
    L = far.shape[2]
    _check_cols(L, gsz, far_tile)
    soft_sq = float(softening) ** 2
    n_use = _tile_counts(far_n, L, far_tile)
    Lm = max(8, int(n_use.max()))
    out = []
    for _, g, t, src in _dense_chunks(s_pos, s_mass, near, Lm, gsz,
                                      window_groups, None, g0, ng):
        fp, fm, _ = _far_sources(far, g, n_use, Lm, tau, coef2)
        sx, sy, sz, sm = (torch.cat([src[r], f], dim=1)
                          for r, f in enumerate(fp + [fm]))
        C, S = sx.shape
        dx = sx[:, None, :] - t[0][:, :, None]                # (C, gsz, S)
        dy = sy[:, None, :] - t[1][:, :, None]
        dz = sz[:, None, :] - t[2][:, :, None]
        r2 = dx * dx + dy * dy + dz * dz + soft_sq
        inv = torch.rsqrt(r2)
        w = torch.where(r2 > soft_sq, sm[:, None, :] * (inv * inv * inv),
                        torch.zeros_like(r2))
        out.append(torch.stack(
            [(w * d).reshape(C, gsz, S // 8, 8).sum(2).sum(2) * G
             for d in (dx, dy, dz)]).reshape(3, -1))
    return torch.cat(out, dim=1)


def _fma32(a, b, c):
    """``fmaf(a, b, c)`` of float32 tensors: ``a * b + c`` rounded once.

    The product is exact in float64; the sum is rounded to odd there (its
    exact error by TwoSum), and rounding that to float32 is the single
    rounding of the exact result."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where((err != 0) & even, torch.nextafter(s, toward),
                       s).float()


def _dot3_fma(u, v):
    """``u . v`` over three components as the FMA chain ``fma(u2, v2,
    fma(u1, v1, u0 * v0))``."""
    return _fma32(u[2], v[2], _fma32(u[1], v[1], u[0] * v[0]))


def window_eval_mxu_reference(s_pos, s_mass, far, far_n, near=None,
                              steps_since=0, dt=0.0, *, G, softening,
                              group_size=256, window_groups=2,
                              tau_clamp=24.0, far_tile=512, haloed=False,
                              local_slice=None):
    """Plain-tensor matrix form (``_eval_kernel_mxu``), monopole rows
    (R 8/10).

    Coordinates are centred on the mean of the group's ``gsz`` target slots
    (the padding repeats included), summed in float64 and rounded once.
    For targets ``t_c`` and sources ``s_c``: ``d^2 = ((|t_c|^2 + |s_c|^2)
    - 2 t_c.s_c) + eps^2``, ``w = m * rsqrt(max(d^2, eps^2))^3`` (no gate),
    ``a = G (sum w s_c - t_c sum w)``; the self pair cancels in the last
    difference.  d^2 cancels in float32, so its rounding is part of the
    function: the squares and the cross term are FMA chains, as XLA rounds
    the JAX form's sum and contraction, and the centre and the chains round
    exactly as the kernel rounds them.  The JAX package takes a float32
    mean, which moves the result by ~5e-5 of max|a| at 2K bodies.  Sources
    and modes as :func:`window_eval_cols_reference`; in a mode the centre
    is still the mean of the group's own target slots.
    """
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    gsz = group_size
    g0, ng, _ = eval_mode(s_pos.shape[1], gsz, window_groups, near, haloed,
                          local_slice)
    L = far.shape[2]
    soft_sq = float(softening) ** 2
    n_use = _tile_counts(far_n, L, far_tile)
    Lm = max(1, int(n_use.max()))
    out = []
    for _, g, t, src in _dense_chunks(s_pos, s_mass, near, Lm, gsz,
                                      window_groups, None, g0, ng):
        fp, fm, _ = _far_sources(far, g, n_use, Lm, tau, coef2)
        center = (t.double().sum(dim=2, keepdim=True) / gsz).to(t.dtype)
        tc = t - center
        sc = [torch.cat([src[r], fp[r]], dim=1) - center[r] for r in range(3)]
        sm = torch.cat([src[3], fm], dim=1)
        ti_sq = _dot3_fma(tc, tc)
        ps_sq = _dot3_fma(sc, sc)
        cross = _dot3_fma([x[:, :, None] for x in tc],
                          [x[:, None, :] for x in sc])       # (C, gsz, S)
        d2 = ((ti_sq[:, :, None] + ps_sq[:, None, :]) - 2.0 * cross) + soft_sq
        inv = torch.rsqrt(torch.clamp(d2, min=soft_sq))
        w = sm[:, None, :] * (inv * inv * inv)
        ws = w.sum(2)
        out.append(torch.stack(
            [((w * sc[r][:, None, :]).sum(2) - tc[r] * ws) * G
             for r in range(3)]).reshape(3, -1))
    return torch.cat(out, dim=1)


def _dense_args(name, s_pos, s_mass, far, far_n, near, group_size, rows,
                window_groups, haloed, local_slice):
    """Check a dense kernel's inputs on the card; returns (npad, ng, gsz,
    K, R, L, g0, ngs): the source's ``npad`` slots and ``ngs`` groups, and
    the ``ng`` evaluated groups from source group ``g0`` on
    (:func:`eval_mode`)."""
    dev = s_pos.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    npad, ngs, gsz = _group_args(s_pos, group_size)
    g0, ng, _ = eval_mode(npad, gsz, window_groups, near, haloed,
                          local_slice)
    if far.dim() != 3 or far.shape[0] != ng or far.shape[1] not in rows:
        raise ValueError(f"{name}: far must be (ng={ng}, R in {rows}, L), "
                         f"got {tuple(far.shape)}")
    R, L = far.shape[1], far.shape[2]
    _check("s_pos", s_pos, (3, npad), torch.float32, dev)
    _check("s_mass", s_mass, (npad,), torch.float32, dev)
    _check("far", far, (ng, R, L), torch.float32, dev)
    _check("far_n", far_n, (ng,), torch.int32, dev)
    K = 0
    if near is not None:
        K = near.shape[1] if near.dim() == 2 else -1
        _check("near", near, (ng, K), torch.int32, dev)
    return npad, ng, gsz, K, R, L, g0, ngs


def window_eval(s_pos, s_mass, far, far_n, near=None, steps_since=0, dt=0.0,
                *, G, softening, group_size=256, window_groups=2,
                tau_clamp=24.0, use_cols=False, use_mxu=False, far_tile=512,
                haloed=False, local_slice=None, dbg=""):
    """Window + near groups + dense far-list accelerations through a CUDA
    kernel.

    Same arguments, modes and result as :func:`window_eval_reference` (no
    ``groups``; ``far_n`` and ``near`` must be int32).  The form is the JAX
    package's selection, part of this function's definition (not a
    fallback): the matrix form (:func:`window_eval_mxu`) when ``use_mxu``
    and R is 8 or 10; else the column form (:func:`window_eval_cols`) when
    ``use_cols`` and R is not 13 or 16; else the row form.  Only the row
    form reads ``dbg`` (:func:`dbg_flags`), as in the JAX package.  CPU
    tensors take the form's plain version.  CUDA tensors launch the row
    form's ``csrc/window_eval.cu`` -- one block of ``group_size / T``
    threads per group, T targets a thread (:func:`tile_targets`), heavy
    groups first (:func:`heavy_first`, sorted once per lists) -- on the
    current stream without synchronising, and add one to
    ``window_eval.launches`` (with ablation flags: its ablation instances,
    and ``window_eval.dbg_launches``); a kernel that does not build or
    launch raises.
    """
    kw = dict(G=G, softening=softening, group_size=group_size,
              window_groups=window_groups, tau_clamp=tau_clamp,
              haloed=haloed, local_slice=local_slice)
    R = far.shape[1]
    if use_mxu and R in (8, 10):
        return window_eval_mxu(s_pos, s_mass, far, far_n, near, steps_since,
                               dt, far_tile=far_tile, **kw)
    if use_cols and R not in (13, 16):
        return window_eval_cols(s_pos, s_mass, far, far_n, near,
                                steps_since, dt, far_tile=far_tile, **kw)
    if s_pos.device.type == "cpu":
        return window_eval_reference(s_pos, s_mass, far, far_n, near,
                                     steps_since, dt, dbg=dbg, **kw)
    return dense_launch(s_pos, s_mass, far, far_n, near, steps_since, dt,
                        targets=tile_targets(group_size, R),
                        order=_dense_order(far_n, near, int(group_size)),
                        dbg=dbg, **kw)


_dense_order = _OrderCache()


def dense_launch(s_pos, s_mass, far, far_n, near, steps_since, dt, *, G,
                 softening, group_size, window_groups, tau_clamp, targets,
                 order=None, haloed=False, local_slice=None, dbg=""):
    """Launch ``csrc/window_eval.cu`` (the row form) with ``targets`` (T)
    targets a thread and blocks in ``order`` (int32 group ids; None: group
    i is block i) on checked CUDA inputs, in the call mode ``haloed`` /
    ``local_slice`` (:func:`eval_mode`); adds one to
    ``window_eval.launches``.  With ablation flags (``dbg``,
    :func:`dbg_flags`) it launches the kernel's ablation instance (a
    nonzero ``flags`` word) and adds one to
    ``window_eval.dbg_launches`` instead."""
    flags = dbg_flags(dbg)
    npad, ng, gsz, K, R, L, g0, ngs = _dense_args(
        "window_eval", s_pos, s_mass, far, far_n, near, group_size,
        DENSE_ROWS, window_groups, haloed, local_slice)
    if order is not None:
        _check("order", order, (ng,), torch.int32, s_pos.device)
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    out = s_pos.new_empty((3, ng * gsz))
    args = (s_pos.data_ptr(), s_mass.data_ptr(), far.data_ptr(),
            far_n.data_ptr(), near.data_ptr() if K else None,
            None if order is None else order.data_ptr(), out.data_ptr(), ng,
            g0, ngs, gsz, int(targets), int(window_groups), K, R, L,
            float(softening) ** 2, float(G), tau, coef2)
    err = _kernels.entry.spatialsim_window_eval(
        *args, sum(DBG_BITS[f] for f in flags), _kernels.stream(s_pos))
    if err:
        _kernels.fail(err, "window_eval")
    if flags:
        window_eval.dbg_launches += 1
    else:
        window_eval.launches += 1
    return out


window_eval.launches = 0
window_eval.dbg_launches = 0


def window_eval_cols(s_pos, s_mass, far, far_n, near=None, steps_since=0,
                     dt=0.0, *, G, softening, group_size=256,
                     window_groups=2, tau_clamp=24.0, far_tile=512,
                     haloed=False, local_slice=None):
    """The column form through ``csrc/window_eval_cols.cu``.

    Same arguments, modes and result as :func:`window_eval_cols_reference`,
    which CPU tensors take.  CUDA tensors launch the kernel's instance that
    :func:`cols_plan` picks -- one block of ``group_size / T`` threads per
    group, T targets a thread, 8 partial sums a target, heavy groups first
    where the plan says so (sorted once per lists) -- on the current
    stream without synchronising, and add one to
    ``window_eval_cols.launches``.
    """
    if s_pos.device.type == "cpu":
        return window_eval_cols_reference(
            s_pos, s_mass, far, far_n, near, steps_since, dt, G=G,
            softening=softening, group_size=group_size,
            window_groups=window_groups, tau_clamp=tau_clamp,
            far_tile=far_tile, haloed=haloed, local_slice=local_slice)
    T, heavy = cols_plan(group_size)
    order = (_cols_order(far_n, near, int(group_size),
                         (far.shape[2], int(far_tile))) if heavy else None)
    return cols_launch(s_pos, s_mass, far, far_n, near, steps_since, dt,
                       G=G, softening=softening, group_size=group_size,
                       window_groups=window_groups, tau_clamp=tau_clamp,
                       far_tile=far_tile, targets=T, order=order,
                       haloed=haloed, local_slice=local_slice)


# The column kernel's instance by group size: (T, heavy groups first).
# Chosen by timing T 1, 2 and 4, in group order and heavy-first, on an
# H100 at the A/B tool's 1M lists (PERF.md, kernel 3b).
_COLS_PLAN = {256: (2, True)}
_cols_order = _OrderCache()


def cols_plan(group_size: int):
    """(T, heavy-first?) of the column kernel at ``group_size`` (a
    multiple of 8): the table's entry, else (2, True), with T halved until
    ``group_size / T`` is a multiple of 8, so that source k of a staged
    batch is source k of its block mod 8, the TPU kernel's partial."""
    T, heavy = _COLS_PLAN.get(int(group_size), (2, True))
    while T > 1 and group_size % (8 * T):
        T //= 2
    return T, heavy


def cols_launch(s_pos, s_mass, far, far_n, near, steps_since, dt, *, G,
                softening, group_size, window_groups, tau_clamp, far_tile,
                targets, order=None, haloed=False, local_slice=None):
    """Launch ``csrc/window_eval_cols.cu`` with ``targets`` (T) targets a
    thread and blocks in ``order`` (int32 group ids; None: group i is block
    i) on checked CUDA inputs, in the call mode ``haloed`` /
    ``local_slice``; adds one to ``window_eval_cols.launches``."""
    npad, ng, gsz, K, R, L, g0, ngs = _dense_args(
        "window_eval_cols", s_pos, s_mass, far, far_n, near, group_size,
        (8, 10), window_groups, haloed, local_slice)
    _check_cols(L, gsz, far_tile)
    if order is not None:
        _check("order", order, (ng,), torch.int32, s_pos.device)
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    out = s_pos.new_empty((3, ng * gsz))
    err = _kernels.entry.spatialsim_window_eval_cols(
        s_pos.data_ptr(), s_mass.data_ptr(), far.data_ptr(),
        far_n.data_ptr(), near.data_ptr() if K else None,
        None if order is None else order.data_ptr(), out.data_ptr(), ng,
        g0, ngs, gsz, int(targets), int(window_groups), K, R, L,
        min(int(far_tile), L), float(softening) ** 2, float(G), tau, coef2,
        _kernels.stream(s_pos))
    if err:
        _kernels.fail(err, "window_eval_cols")
    window_eval_cols.launches += 1
    return out


window_eval_cols.launches = 0


def window_eval_mxu(s_pos, s_mass, far, far_n, near=None, steps_since=0,
                    dt=0.0, *, G, softening, group_size=256, window_groups=2,
                    tau_clamp=24.0, far_tile=512, haloed=False,
                    local_slice=None):
    """The matrix form through ``csrc/window_eval_mxu.cu``.

    Same arguments, modes and result as :func:`window_eval_mxu_reference`,
    which CPU tensors take.  CUDA tensors launch the kernel's instance that
    :func:`mxu_plan` picks -- the register tile on CUDA cores (``"fma"``,
    T targets a thread) or the contraction on tensor cores (``"mma"``, M
    m16 tiles of targets a warp), heavy groups first where the plan says
    so (sorted once per lists) -- on the current stream without
    synchronising, and add one to ``window_eval_mxu.launches``.  An
    instance the group size does not allow raises; nothing falls back.
    """
    if s_pos.device.type == "cpu":
        return window_eval_mxu_reference(
            s_pos, s_mass, far, far_n, near, steps_since, dt, G=G,
            softening=softening, group_size=group_size,
            window_groups=window_groups, tau_clamp=tau_clamp,
            far_tile=far_tile, haloed=haloed, local_slice=local_slice)
    contraction, n, heavy = mxu_plan(group_size)
    order = (_mxu_order(far_n, near, int(group_size),
                        (far.shape[2], int(far_tile))) if heavy else None)
    return mxu_launch(s_pos, s_mass, far, far_n, near, steps_since, dt,
                      G=G, softening=softening, group_size=group_size,
                      window_groups=window_groups, tau_clamp=tau_clamp,
                      far_tile=far_tile, targets=n, order=order,
                      contraction=contraction, haloed=haloed,
                      local_slice=local_slice)


# The matrix kernel's instance by group size: (contraction, T or M, heavy
# groups first).  Chosen by timing the register tile at T 1, 2 and 4 and
# the tensor-core contraction at M 2 and 4, each in group order and
# heavy-first, on an H100 at the A/B tool's 1M lists (PERF.md, kernel 3c):
# the tile at T=2 heavy-first was the fastest at K=8 in every run and at
# K=0 in most; the tensor-core contraction issues fewer instructions a
# pair but fewer of them a clock.
_MXU_PLAN = {256: ("fma", 2, True)}
_mxu_order = _OrderCache()
MXU_CONTRACTIONS = {"fma": (1, 2, 4), "mma": (2, 4)}


def mxu_plan(group_size: int):
    """(contraction, T or M, heavy-first?) of the matrix kernel at
    ``group_size``: the table's entry, else ("fma", 2, True); for the register
    tile T halved until ``group_size / T`` is a multiple of 32 (whole warps
    for the centre's reduction)."""
    contraction, n, heavy = _MXU_PLAN.get(int(group_size), ("fma", 2, True))
    if contraction == "fma":
        while n > 1 and group_size % (32 * n):
            n //= 2
    return contraction, n, heavy


def _check_mxu(group_size, contraction, n):
    """Raise unless the matrix kernel has the instance (contraction, n) at
    ``group_size``."""
    gsz = int(group_size)
    if contraction not in MXU_CONTRACTIONS:
        raise ValueError(f"window_eval_mxu: contraction {contraction!r} is "
                         f"not one of {sorted(MXU_CONTRACTIONS)}")
    if n not in MXU_CONTRACTIONS[contraction]:
        raise ValueError(f"window_eval_mxu: the {contraction} instance takes "
                         f"{MXU_CONTRACTIONS[contraction]}, not {n}")
    if contraction == "mma" and (gsz % 16 or not 16 <= gsz <= 1024):
        raise ValueError(f"window_eval_mxu: group_size {gsz} must be a "
                         f"multiple of 16 up to 1024 for the tensor-core "
                         f"contraction (m16 tiles of targets)")
    if contraction == "fma" and (gsz % (32 * n) or gsz > 1024):
        raise ValueError(f"window_eval_mxu: group_size {gsz} must be a "
                         f"multiple of {32 * n} up to 1024 for T={n} "
                         f"(whole warps of group_size / T threads)")


def mxu_launch(s_pos, s_mass, far, far_n, near, steps_since, dt, *, G,
               softening, group_size, window_groups, tau_clamp, far_tile,
               targets, order=None, contraction="fma", haloed=False,
               local_slice=None):
    """Launch ``csrc/window_eval_mxu.cu``'s instance ``contraction``
    (``"fma"``: ``targets`` = T targets a thread; ``"mma"``: ``targets`` =
    M m16 tiles of targets a warp) with blocks in ``order`` (int32 group
    ids; None: group i is block i) on checked CUDA inputs, in the call mode
    ``haloed`` / ``local_slice``; adds one to
    ``window_eval_mxu.launches``."""
    _check_mxu(group_size, contraction, targets)
    npad, ng, gsz, K, R, L, g0, ngs = _dense_args(
        "window_eval_mxu", s_pos, s_mass, far, far_n, near, group_size,
        (8, 10), window_groups, haloed, local_slice)
    tile = min(int(far_tile), L)
    if tile < 1:
        raise ValueError(f"window_eval_mxu: far_tile {far_tile} must be >= 1")
    if order is not None:
        _check("order", order, (ng,), torch.int32, s_pos.device)
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    out = s_pos.new_empty((3, ng * gsz))
    err = _kernels.entry.spatialsim_window_eval_mxu(
        s_pos.data_ptr(), s_mass.data_ptr(), far.data_ptr(),
        far_n.data_ptr(), near.data_ptr() if K else None,
        None if order is None else order.data_ptr(), out.data_ptr(), ng,
        g0, ngs, gsz, int(contraction == "mma"), int(targets),
        int(window_groups), K, R, L, tile, float(softening) ** 2, float(G),
        tau, coef2, _kernels.stream(s_pos))
    if err:
        _kernels.fail(err, "window_eval_mxu")
    window_eval_mxu.launches += 1
    return out


window_eval_mxu.launches = 0


def mxu_occupancy(group_size, contraction, targets, rows, window_groups=0,
                  K=0):
    """(resident blocks per SM, registers a thread, threads a block) of the
    matrix kernel's instance (``contraction``, ``targets``) at ``rows``, as
    the card's occupancy calculator gives them."""
    import ctypes
    _check_mxu(group_size, contraction, targets)
    out = (ctypes.c_int * 3)()
    err = _kernels.entry.spatialsim_window_eval_mxu_occupancy(
        int(rows), int(group_size), int(contraction == "mma"), int(targets),
        int(window_groups), int(K), ctypes.addressof(out))
    _kernels.check(err, "occupancy")
    return tuple(out)


def occupancy(group_size, targets, rows=None, window_groups=0, K=0,
              cols=False):
    """(resident blocks per SM, registers a thread, threads a block) of the
    pooled kernel (``rows`` None), of the dense row-form kernel at
    ``rows`` or, with ``cols``, of the column kernel at ``rows``, as the
    card's occupancy calculator gives them."""
    import ctypes
    out = (ctypes.c_int * 3)()
    entry = _kernels.entry
    if rows is None:
        err = entry.spatialsim_window_eval_pool_occupancy(
            int(group_size), int(targets), ctypes.addressof(out))
    else:
        err = (entry.spatialsim_window_eval_cols_occupancy if cols
               else entry.spatialsim_window_eval_occupancy)(
            int(rows), int(group_size), int(targets), int(window_groups),
            int(K), ctypes.addressof(out))
    _kernels.check(err, "occupancy")
    return tuple(out)
