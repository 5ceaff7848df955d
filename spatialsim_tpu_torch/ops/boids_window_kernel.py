"""Boids Morton-window neighbour accumulation through a hand-written CUDA
kernel (port of ``spatialsim_tpu/ops/boids_window_kernel.py``).

:func:`boids_window_accumulate` is the wrapper of ``csrc/boids_window.cu``.
A CUDA tensor launches the kernel on PyTorch's current stream (or raises);
a CPU tensor takes the plain version,
:func:`spatialsim_tpu_torch.ops.boids_ops.window_accumulate_reference`.
Both window passes of every window-mode boids step come through here.
"""

from __future__ import annotations

import torch

from spatialsim_tpu_torch import _kernels

# Accumulator rows of one window pass: [sep3, align3, coh3, csum3,
# sep_count, nb_count], coh3 the summed offsets p_s - p_t.
ACC_ROWS = 14
_MAX_GROUP = 1024      # one thread per target of a group


def _check(name, t, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected float32 {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def boids_window_accumulate(s_pos, s_vel, s_col, s_grpf=None, *, gsz, wg,
                            perception_sq, separation_sq, prev_wg=None):
    """Window neighbour accumulators of one pass over SORTED padded state.

    Args:
      s_pos, s_vel, s_col: ``(3, npad)`` float32, contiguous, ``npad`` a
        multiple of ``gsz``; padding slots carry positions at 1e9.
      s_grpf: ``(npad,)`` float32 previous pass's group id per slot
        (padding at -1e9), or None for a first pass; pairs with
        ``|grp_t - grp_s| <= prev_wg`` (default ``wg``) are left out.
    Returns:
      ``(14, npad)`` float32 rows ``[sep3, align3, coh3, csum3, sep_count,
      nb_count]``, ``coh3`` the summed offsets ``p_s - p_t``.

    CUDA tensors launch the kernel without synchronising and add one to
    ``boids_window_accumulate.launches``.
    """
    kw = dict(gsz=gsz, wg=wg, perception_sq=perception_sq,
              separation_sq=separation_sq, prev_wg=prev_wg)
    if s_pos.device.type == "cpu":
        from spatialsim_tpu_torch.ops.boids_ops import (
            window_accumulate_reference)
        return window_accumulate_reference(s_pos, s_vel, s_col, s_grpf, **kw)
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
    for name, t in (("s_pos", s_pos), ("s_vel", s_vel), ("s_col", s_col)):
        _check(name, t, (3, npad))
    if s_grpf is not None:
        _check("s_grpf", s_grpf, (npad,))
    out = torch.empty((ACC_ROWS, npad), dtype=torch.float32,
                      device=s_pos.device)
    lib = _kernels.library()
    err = lib.spatialsim_boids_window(
        s_pos.data_ptr(), s_vel.data_ptr(), s_col.data_ptr(),
        None if s_grpf is None else s_grpf.data_ptr(), out.data_ptr(),
        npad, gsz, wg, float(perception_sq), float(separation_sq),
        float(prev_wg if prev_wg is not None else wg),
        _kernels.stream_ptr(s_pos.device))
    _kernels.check(err, "boids_window")
    boids_window_accumulate.launches += 1
    return out


boids_window_accumulate.launches = 0
