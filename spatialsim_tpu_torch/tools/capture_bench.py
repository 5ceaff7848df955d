"""The frame capture's kernels (``csrc/capture.cu``) against their byte
bounds, the plain path and the copy to the host.

    python -m spatialsim_tpu_torch.tools.capture_bench [--bodies 1m 10m]
        [--reps 20] [--device cuda|cpu]

For each body count: a random ``(3, n)`` float32 state and a random
permutation as ``inv_order``.  Each
line times one call by CUDA events, after a 128 MB write that leaves
nothing of the inputs in the 50 MB L2, and reports the median of
``--reps`` calls with the first and third quartiles:

* ``original``: ``capture_original`` of pos and vel, beside its bound:
  bytes over 3.35 TB/s, the random side in whole 32 B sectors
  (:func:`original_bytes`);
* ``colours rows`` / ``colours (3, n)``: ``capture_colors`` on the
  ``(n, 3)`` rows the capture gives, and on a contiguous ``(3, n)``;
  bound :func:`colour_bytes`;
* ``plain``: the plain gather and colours with their two transposes, the
  capture's kernels before ``csrc/capture.cu``;
* ``capture plain`` / ``capture kernels``: the recorder's whole capture,
  those then ``.T.contiguous()`` and ``non_blocking`` copies into pinned
  buffers; ``copies``: the two copies alone.

Then the checks: the rows equal the plain gather bit for bit;
the colours on both inputs against the plain version on the contiguous
input, and the plain version on the ``(n, 3)``-backed view against it,
as the count of differing values and the largest gap in ulps.  On the
CPU only the plain lines run, on the host clock ("not measured" for the
rest).
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from spatialsim_tpu_torch.ops.capture import (capture_colors,
                                              capture_original,
                                              original_order_reference)
from spatialsim_tpu_torch.ops.colors import colors_by_velocity_reference
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import device_of

PEAK_BYTES = 3.35e12        # H100 SXM HBM3, NVIDIA's data sheet
SECTOR = 32
MAX_SPEED = 15.0
FLUSH_BYTES = 128 << 20
SIZES = {"1m": 1_000_000, "10m": 10_000_000}


def row_sectors(n: int) -> int:
    """32 B sectors that n rows of 12 B at byte offsets 12 i cover: 10
    every 8 rows."""
    full, rest = divmod(n, 8)
    return 10 * full + sum((12 * i + 11) // SECTOR - 12 * i // SECTOR + 1
                           for i in range(rest))


def original_bytes(n: int) -> int:
    """The least bytes that mapping pos and vel to original order moves:
    the sorted arrays and an index read once, the rows written at random
    in the whole 32 B sectors they cover (a gather straight from the
    ``(3, n)`` arrays reads a sector for each of 6 components: 220 B a
    body against these 108)."""
    return 4 * n + 2 * (12 * n + SECTOR * row_sectors(n))


def colour_bytes(n: int) -> int:
    return 24 * n


def quartiles(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return q1, q2, q3


class Timer:
    """Times one call at a time: a 128 MB write first (the card's L2 is
    50 MB), then CUDA events around the call; host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                                 device=device) if self.cuda else None

    def ms(self, fn, reps):
        fn()                                        # warm-up
        out = []
        for _ in range(reps):
            if self.cuda:
                self.flush.fill_(1.0)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                out.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                fn()
                out.append((time.perf_counter() - t0) * 1e3)
        return quartiles(out)


def ulp_gap(a, b):
    """Largest gap between two float32 tensors in ulps (their int32 bit
    patterns; both non-negative or NaN here) and the count of values that
    differ."""
    gap = (a.contiguous().view(torch.int32).long()
           - b.contiguous().view(torch.int32).long()).abs()
    return int(gap.max()), int((gap != 0).sum())


def state(n, device, seed=0):
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.standard_normal((3, n), np.float32) * 500,
                          device=device)
    vel = torch.as_tensor(rng.standard_normal((3, n), np.float32) * 6,
                          device=device)
    inv = torch.as_tensor(rng.permutation(n).astype(np.int32), device=device)
    return pos, vel, inv


def run(n, reps=20, device="cuda", out=print):
    """Time and check at ``n`` bodies; returns ``{line: (q1, median,
    q3)}`` in ms."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    pos, vel, inv = state(n, device)
    timer = Timer(device)
    res = {}

    def line(name, fn, nbytes=None):
        q = timer.ms(fn, reps)
        res[name] = q
        text = (f"n={n:,} {name}: {q[1]:.4f} ms (q1 {q[0]:.4f}, q3 "
                f"{q[2]:.4f})")
        if nbytes is not None:
            bound = nbytes / PEAK_BYTES * 1e3
            text += (f"; bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), "
                     f"{100 * bound / q[1]:.1f}% of it")
        out(text)

    pin = dict(dtype=torch.float32, pin_memory=cuda)
    pos_h, col_h = torch.empty((n, 3), **pin), torch.empty((n, 3), **pin)

    def capture(pos_o, vel_o, colours):
        pos_h.copy_(pos_o.T.contiguous(), non_blocking=cuda)
        col_h.copy_(colours(vel_o, MAX_SPEED).T.contiguous(),
                    non_blocking=cuda)

    def plain():
        pos_o, vel_o = original_order_reference(inv, pos, vel)
        return pos_o.T.contiguous(), colors_by_velocity_reference(
            vel_o, MAX_SPEED).T.contiguous()

    line("plain", plain)
    line("capture plain", lambda: capture(
        *original_order_reference(inv, pos, vel),
        colors_by_velocity_reference))
    if not cuda:
        out(f"n={n:,} original, colours, copies: not measured (no card)")
        return res
    rows = capture_original(inv, pos, vel)
    line("original", lambda: capture_original(inv, pos, vel),
         original_bytes(n))
    line("colours rows", lambda: capture_colors(rows[1], MAX_SPEED),
         colour_bytes(n))
    line("colours (3, n)", lambda: capture_colors(vel, MAX_SPEED),
         colour_bytes(n))
    line("capture kernels", lambda: capture(
        *capture_original(inv, pos, vel), capture_colors))
    pos_d, col_d = plain()
    line("copies", lambda: (pos_h.copy_(pos_d, non_blocking=True),
                            col_h.copy_(col_d, non_blocking=True)))

    same = all(torch.equal(g.contiguous().view(torch.int32),
                           w.view(torch.int32))
               for g, w in zip(rows, original_order_reference(inv, pos,
                                                              vel)))
    out(f"n={n:,} the rows equal the plain gather bit for bit: {same}")
    for name, v in (("rows", rows[1]), ("(3, n)", vel)):
        want = colors_by_velocity_reference(v.contiguous(), MAX_SPEED)
        gap, differ = ulp_gap(capture_colors(v, MAX_SPEED), want)
        out(f"n={n:,} colours {name} against the plain version on a "
            f"contiguous input: {differ} values differ, largest {gap} ulp")
    gap, differ = ulp_gap(colors_by_velocity_reference(rows[1], MAX_SPEED),
                          colors_by_velocity_reference(rows[1].contiguous(),
                                                       MAX_SPEED))
    out(f"n={n:,} the plain version on the (n, 3) rows against it: "
        f"{differ} values differ, largest {gap} ulp")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bodies", nargs="+", default=["1m", "10m"],
                    help="1m, 10m or a body count")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device, "capture_bench")
    print(device_line(device))
    for b in args.bodies:
        run(SIZES.get(b.lower()) or int(b), args.reps, device)


if __name__ == "__main__":
    main()
