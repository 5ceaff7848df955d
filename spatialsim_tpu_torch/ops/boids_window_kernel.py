"""Boids Morton-window neighbour accumulation through a hand-written CUDA
kernel (port of ``spatialsim_tpu/ops/boids_window_kernel.py``).

:func:`boids_window_accumulate` is the wrapper of ``csrc/boids_window.cu``.
A CUDA tensor launches the kernel on PyTorch's current stream (or raises);
a CPU tensor takes the plain version, :func:`boids_window_reference`
(:func:`spatialsim_tpu_torch.ops.boids_ops.window_accumulate_reference`).
Both window passes of every window-mode boids step come through here, the
sharded step's haloed shards too (``haloed=True``).

The kernel holds T targets a thread and skips, warp by warp, the 32-source
chunks whose box lies at least the perception radius from the box of the
warp's targets. :func:`chunk_cull_reference` is the plain model of that
decision, in the kernel's float32 operations.
"""

from __future__ import annotations

import torch

from spatialsim_tpu_torch import _kernels

# Accumulator rows of one window pass: [sep3, align3, coh3, csum3,
# sep_count, nb_count], coh3 the summed offsets p_s - p_t.
ACC_ROWS = 14
_MAX_GROUP = 1024
# Targets a thread the kernel is built for, and the one the wrapper uses:
# at T = 1 a warp's box holds 32 targets and culls the most (the fastest on
# an H100 at 500K, both passes).
BOIDS_TARGETS = (1, 2, 4)
DEFAULT_TARGETS = 1
CHUNK = 32             # sources a warp culls at once, and targets a row


def boids_threads(gsz: int, targets: int) -> int:
    """Threads a block: whole warps of ``targets`` targets covering the
    group (the slots past ``gsz`` hold no target)."""
    per_warp = CHUNK * targets
    return CHUNK * (-(-gsz // per_warp))


def _check(name, t, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected float32 {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def boids_window_accumulate(s_pos, s_vel, s_col, s_grpf=None, *, gsz, wg,
                            perception_sq, separation_sq, prev_wg=None,
                            haloed=False):
    """Window neighbour accumulators of one pass over SORTED padded state.

    Args:
      s_pos, s_vel, s_col: ``(3, npad)`` float32, contiguous, ``npad`` a
        multiple of ``gsz``; padding slots carry positions at 1e9.
      s_grpf: ``(npad,)`` float32 previous pass's group id per slot
        (padding at -1e9), or None for a first pass; pairs with
        ``|grp_t - grp_s| <= prev_wg`` (default ``wg``) are left out.
      haloed: the inputs carry ``wg`` halo groups on each side of the
        evaluated slots (the sharded step's shard between its neighbours'
        edge groups, or the far-away fill): only the inner groups are
        targets, and their windows read the halos.
    Returns:
      ``(14, n)`` float32 rows ``[sep3, align3, coh3, csum3, sep_count,
      nb_count]``, ``coh3`` the summed offsets ``p_s - p_t``; ``n`` is
      ``npad``, or ``npad - 2 * wg * gsz`` when ``haloed``.

    CUDA tensors launch the kernel (``DEFAULT_TARGETS`` targets a thread,
    the box cull on) without synchronising and add one to
    ``boids_window_accumulate.launches``.
    """
    kw = dict(gsz=gsz, wg=wg, perception_sq=perception_sq,
              separation_sq=separation_sq, prev_wg=prev_wg, haloed=haloed)
    if s_pos.device.type == "cpu":
        return boids_window_reference(s_pos, s_vel, s_col, s_grpf, **kw)
    return boids_window_launch(s_pos, s_vel, s_col, s_grpf,
                               targets=DEFAULT_TARGETS, cull=True, **kw)


def boids_window_reference(s_pos, s_vel, s_col, s_grpf=None, *, gsz, wg,
                           perception_sq, separation_sq, prev_wg=None,
                           haloed=False):
    """The plain version of :func:`boids_window_accumulate`, on any device:
    :func:`~spatialsim_tpu_torch.ops.boids_ops.window_accumulate_reference`,
    with ``haloed`` inputs split into the evaluated slots and their
    ``halo9``/``halo_grpf``."""
    from spatialsim_tpu_torch.ops.boids_ops import window_accumulate_reference
    kw = dict(gsz=gsz, wg=wg, perception_sq=perception_sq,
              separation_sq=separation_sq, prev_wg=prev_wg)
    if haloed:
        pw = wg * gsz
        rows = [s_vel, s_pos, s_col]
        kw["halo9"] = (torch.cat([r[:, :pw] for r in rows]),
                       torch.cat([r[:, -pw:] for r in rows]))
        s_pos, s_vel, s_col = (r[:, pw:-pw] for r in (s_pos, s_vel, s_col))
        if s_grpf is not None:
            kw["halo_grpf"] = (s_grpf[:pw], s_grpf[-pw:])
            s_grpf = s_grpf[pw:-pw]
    return window_accumulate_reference(s_pos, s_vel, s_col, s_grpf, **kw)


def boids_window_launch(s_pos, s_vel, s_col, s_grpf=None, *, gsz, wg,
                        perception_sq, separation_sq, prev_wg=None,
                        targets, cull, haloed=False):
    """Launch ``csrc/boids_window.cu`` with ``targets`` (T) targets a
    thread and the box cull on or off, on checked CUDA inputs; adds one to
    ``boids_window_accumulate.launches``.  Every instance gives the same
    rows, bit for bit.  ``haloed`` as :func:`boids_window_accumulate`:
    source groups ``ngs = npad / gsz``, target group g reads source group
    ``g + wg`` of them (``g0 = 0`` and ``ng = ngs`` otherwise)."""
    tensors = [s_pos, s_vel, s_col] + ([s_grpf] if s_grpf is not None
                                       else [])
    if s_pos.device.type != "cuda" or any(t.device != s_pos.device
                                          for t in tensors):
        raise ValueError(f"boids_window_accumulate: unsupported devices "
                         f"{[str(t.device) for t in tensors]}")
    npad = s_pos.shape[1]
    if not 1 <= gsz <= _MAX_GROUP or npad == 0 or npad % gsz:
        raise ValueError(f"boids_window_accumulate: npad={npad} must be a "
                         f"positive multiple of gsz={gsz} (1..{_MAX_GROUP})")
    if wg < 0:
        raise ValueError(f"boids_window_accumulate: wg={wg} < 0")
    if targets not in BOIDS_TARGETS:
        raise ValueError(f"boids_window_accumulate: targets={targets} not "
                         f"in {BOIDS_TARGETS}")
    ngs = npad // gsz
    g0, ng = (wg, ngs - 2 * wg) if haloed else (0, ngs)
    if ng < 1:
        raise ValueError(f"boids_window_accumulate: {ngs} groups hold no "
                         f"target group inside {wg} halo groups a side")
    for name, t in (("s_pos", s_pos), ("s_vel", s_vel), ("s_col", s_col)):
        _check(name, t, (3, npad))
    if s_grpf is not None:
        _check("s_grpf", s_grpf, (npad,))
    out = torch.empty((ACC_ROWS, ng * gsz), dtype=torch.float32,
                      device=s_pos.device)
    err = _kernels.entry.spatialsim_boids_window(
        s_pos.data_ptr(), s_vel.data_ptr(), s_col.data_ptr(),
        None if s_grpf is None else s_grpf.data_ptr(), out.data_ptr(),
        ng, g0, ngs, gsz, wg, float(perception_sq), float(separation_sq),
        float(prev_wg if prev_wg is not None else wg), int(targets),
        int(bool(cull)), _kernels.stream(s_pos))
    if err:
        _kernels.fail(err, "boids_window")
    boids_window_accumulate.launches += 1
    return out


boids_window_accumulate.launches = 0


def boids_occupancy(gsz, targets, cull=True, dedup=False):
    """(resident blocks per SM, registers a thread, threads a block) of one
    instance, as the card's occupancy calculator gives them."""
    import ctypes
    out = (ctypes.c_int * 3)()
    err = _kernels.entry.spatialsim_boids_window_occupancy(
        int(gsz), int(targets), int(bool(cull)), int(bool(dedup)),
        ctypes.addressof(out))
    _kernels.check(err, "boids_window occupancy")
    return tuple(out)


def _boxes(rows, ng, slots, size):
    """(lo, hi) of ``rows`` ``(r, ng * gsz)`` over runs of ``size`` of each
    group's ``slots`` staged slots; the slots past gsz hold nothing and are
    left out (+inf lo, -inf hi), as in the kernel."""
    r = rows.shape[0]
    gsz = rows.shape[1] // ng
    inf = float("inf")
    lo = rows.new_full((r, ng, slots), inf)
    hi = rows.new_full((r, ng, slots), -inf)
    lo[:, :, :gsz] = rows.reshape(r, ng, gsz)
    hi[:, :, :gsz] = rows.reshape(r, ng, gsz)
    return (lo.reshape(r, ng, slots // size, size).amin(-1),
            hi.reshape(r, ng, slots // size, size).amax(-1))


def _gap(alo, ahi, blo, bhi):
    """max(blo - ahi, alo - bhi, 0), each difference rounded to float32."""
    return torch.clamp(torch.maximum(blo - ahi, alo - bhi), min=0.0)


def chunk_cull_reference(s_pos, *, gsz, wg, perception_sq, targets):
    """The kernel's skip decisions, in plain float32 tensor ops.

    For each group g, warp w of its ``32 * targets`` targets (slots
    ``w * 32T ..``), window offset k (group ``g - wg + k``) and 32-source
    chunk c of that group, the warp skips the chunk where the gap^2 of the
    two boxes, rounded as the kernel rounds d^2 (per-axis differences,
    then ((x^2 + y^2) + z^2), each operation rounded to float32), is >=
    ``perception_sq``.

    Returns a dict: ``skip`` ``(ng, W, 2wg+1, C)`` bool (True also for
    window groups past either end), ``in_range`` ``(ng, 2wg+1)`` (window
    groups inside ``[0, ng)``), and ``pairs`` / ``tested`` (pairs of
    in-range chunks, and of those not skipped, ``32T * 32`` each).
    """
    npad = s_pos.shape[1]
    ng = npad // gsz
    nthr = boids_threads(gsz, targets)
    slots = nthr * targets
    W, C = nthr // CHUNK, slots // CHUNK
    t_lo, t_hi = _boxes(s_pos, ng, slots, CHUNK * targets)
    c_lo, c_hi = _boxes(s_pos, ng, slots, CHUNK)
    K = 2 * wg + 1
    skip = torch.ones((ng, W, K, C), dtype=torch.bool, device=s_pos.device)
    g = torch.arange(ng, device=s_pos.device)
    in_range = torch.zeros((ng, K), dtype=torch.bool, device=s_pos.device)
    for k in range(K):
        h = g - wg + k
        ok = (h >= 0) & (h < ng)
        in_range[:, k] = ok
        hc = h.clamp(0, ng - 1)
        a_lo, a_hi = t_lo[:, :, :, None], t_hi[:, :, :, None]   # (3,ng,W,1)
        b_lo, b_hi = c_lo[:, hc, None, :], c_hi[:, hc, None, :]  # (3,ng,1,C)
        gx, gy, gz = (_gap(a_lo[i], a_hi[i], b_lo[i], b_hi[i])
                      for i in range(3))
        gap2 = (gx * gx + gy * gy) + gz * gz
        skip[:, :, k, :] = ~(gap2 < perception_sq) | ~ok[:, None, None]
    per = CHUNK * targets * CHUNK
    n_in = int(in_range.sum()) * W * C
    return dict(skip=skip, in_range=in_range, pairs=n_in * per,
                tested=(n_in - int(
                    (skip & in_range[:, None, :, None]).sum())) * per)
