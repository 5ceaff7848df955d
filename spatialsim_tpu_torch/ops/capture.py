"""The frame capture through hand-written CUDA kernels (``csrc/capture.cu``).

Each frame the recorder reads the window engine's Morton-sorted state in
original body order (``NBodySimulation.device_frame``) and colours the
velocities (``ops/colors.py`` ``colors_by_velocity``), then copies
``(N, 3)`` rows to the host.  On the card each is a
hand-written kernel that writes fresh ``(N, 3)`` rows and returns their
``(3, N)`` ``.T`` view, so the values and shapes are the plain versions'
and the callers' ``.T.contiguous()`` is the same storage, with no copy:

* :func:`original_order` dispatches: on the CPU
  :func:`original_order_reference` (the plain gather), on the card
  :func:`capture_original` (the kernel, which refuses anything but float32
  CUDA tensors);
* :func:`capture_colors` is the colour kernel, which
  ``colors_by_velocity`` takes on every input that is not on the CPU.

Each dispatch adds one to the profiler-only counter
``capture.kernel_calls`` or ``capture.plain_calls``
(``utils/profiling.py``); each launch adds one to its wrapper's
``launches``.
"""

from __future__ import annotations

import torch

from spatialsim_tpu_torch import _kernels
from spatialsim_tpu_torch.utils.profiling import count

_INT_MAX = 2**31 - 1


def original_order(inv_order, pos, vel):
    """``(3, n)`` Morton-sorted ``pos`` and ``vel`` mapped to original body
    order by ``inv_order`` (original id -> sorted slot); a pair.

    On the CPU the plain gather; anywhere else :func:`capture_original`
    (``(3, n)`` views of fresh ``(n, 3)`` rows)."""
    if pos.device.type == "cpu":
        count("capture.plain_calls")
        return original_order_reference(inv_order, pos, vel)
    count("capture.kernel_calls")
    return capture_original(inv_order, pos, vel)


def original_order_reference(inv_order, pos, vel):
    """The plain version of :func:`original_order`: ``a[:, inv_order]`` of
    each, contiguous ``(3, n)``, on any device."""
    inv = inv_order.long()
    return pos[:, inv], vel[:, inv]


def _check_rows(name, t, n=None):
    """A float32 ``(3, n)`` tensor (``n`` its own when None)."""
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != 3 or (
            n is not None and t.shape[1] != n):
        want = f"(3, {n})" if n is not None else "(3, n)"
        raise ValueError(f"{name}: expected float32 {want}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.shape[1] > _INT_MAX:
        raise ValueError(f"{name}: {t.shape[1]} bodies exceed int32")


def _check_device(name, tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: unsupported devices "
                         f"{[str(t.device) for t in tensors]}")


def capture_original(inv_order, pos, vel):
    """Rows of the sorted ``(3, n)`` float32 arrays ``pos`` and ``vel`` in
    original body order by ``inv_order`` (``(n,)`` int32, original id ->
    sorted slot), through ``csrc/capture.cu``: two launches, each body's
    pos and vel staged in one 32 B row in sorted order, then gathered.
    Returns a pair of ``(3, n)`` ``.T`` views of fresh ``(n, 3)``
    row-major tensors.  Refuses a bad shape, dtype or device before any
    launch; launches on PyTorch's current stream without synchronising and
    adds one to ``capture_original.launches``."""
    _check_rows("capture_original: pos", pos)
    n = pos.shape[1]
    _check_rows("capture_original: vel", vel, n)
    for name, t in (("pos", pos), ("vel", vel)):
        if not t.is_contiguous():
            raise ValueError(f"capture_original: {name} must be contiguous")
    if inv_order.dtype != torch.int32 or tuple(inv_order.shape) != (n,) \
            or not inv_order.is_contiguous():
        raise ValueError(f"capture_original: inv_order must be contiguous "
                         f"int32 ({n},), got {inv_order.dtype} "
                         f"{tuple(inv_order.shape)}")
    _check_device("capture_original", [pos, vel, inv_order])
    out_p, out_v = (torch.empty((n, 3), dtype=torch.float32,
                                device=pos.device) for _ in range(2))
    if n:
        stage = torch.empty((n, 8), dtype=torch.float32, device=pos.device)
        err = _kernels.entry.spatialsim_capture_original(
            pos.data_ptr(), vel.data_ptr(), inv_order.data_ptr(),
            stage.data_ptr(), out_p.data_ptr(), out_v.data_ptr(), n,
            _kernels.stream(pos))
        if err:
            _kernels.fail(err, "capture_original")
        capture_original.launches += 1
    return out_p.T, out_v.T


def capture_colors(vel, max_speed: float):
    """Velocity colours of a ``(3, n)`` float32 CUDA view, any strides,
    through ``csrc/capture.cu``: the values of
    ``ops.colors.colors_by_velocity_reference`` on the card, as the
    ``(3, n)`` ``.T`` view of a fresh ``(n, 3)`` row-major tensor.
    Refuses a bad shape, dtype or device before any launch; launches on
    PyTorch's current stream without synchronising and adds one to
    ``capture_colors.launches``."""
    _check_rows("capture_colors: vel", vel)
    _check_device("capture_colors", [vel])
    n = vel.shape[1]
    sc, si = vel.stride()
    if max(sc, si) > _INT_MAX:
        raise ValueError(f"capture_colors: strides {vel.stride()} exceed "
                         f"int32")
    out = torch.empty((n, 3), dtype=torch.float32, device=vel.device)
    if n:
        err = _kernels.entry.spatialsim_capture_colors(
            vel.data_ptr(), out.data_ptr(), n, sc, si, float(max_speed),
            _kernels.stream(vel))
        if err:
            _kernels.fail(err, "capture_colors")
        capture_colors.launches += 1
    return out.T


capture_original.launches = 0
capture_colors.launches = 0
