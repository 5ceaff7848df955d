"""The traversal-kernel option probes of ``scripts/decide18.py`` on this
card (port of that script's ``main()``).

    python -m spatialsim_tpu_torch.tools.decide18 --device cuda
    python -m spatialsim_tpu_torch.tools.decide18 --device cpu --quick

It runs the script's list at the script's sizes through the kernels of
``csrc/probes_decide18.cu``: the int32 table read by a dependent chain at
32, 128, 256 and 512 KB, the gated second reduce at hit rates 0, 15 and
100%, the row store, and the iteration core at 1, 2 and 4 runs a step.
The probe's table scale (1e-6) fires no decision, so the iteration core
returns 0 there; each k also runs on the table at 2^18 x 1e-6, where
decisions fire and ``acc mod 3`` moves the next step's starts (so each
step's reads wait on the last step's word, as a traversal's do).
A table goes to shared memory where the card lets one block opt in to
that much; the larger ones cannot be held there, which the run prints
before it reads them from device memory (``where="global"``), so every
size has a number.  Output as ``tools/decide15.py``'s: ``nvidia-smi``'s
name and power limit, then ms a call (CUDA events, after a warm-up) and ns
per read, iteration, store or run as the script computes them.
"""

from __future__ import annotations

import argparse
import sys

import torch

from spatialsim_tpu_torch.ops import traversal_probes as tp
from spatialsim_tpu_torch.tools.decide15 import (
    device_line, entry, run_probes)

SMEM_SIZES = (8192, 32768, 65536, 131072)     # int32 entries: 32-512 KB
FIRE_SCALE = 1e-6 * 2 ** 18   # the iteration core's table where words fire


def _smem(label, n_i32, where, n_ops, reps, device):
    idx4 = tp.smem_inputs(device)
    return entry(
        label, tp.smem_table,
        lambda: tp.smem_table(idx4, n_i32, n_ops, reps, where=where),
        lambda: tp.smem_table_reference(idx4.cpu(), n_i32, n_ops, reps),
        n_ops * reps, "read",
        # Per step: 1009 i, two adds, acc mod 7, mod n and the accumulate.
        6 * n_ops * reps, 16 + 4)


def _gated(label, pct, n_ops, reps, device):
    x = tp.lane_row(device)
    w = int(x.sum())        # the word: acc * 1e-20 never moves it here
    hits = sum((w + i) % 100 < pct for i in range(n_ops)) * reps
    return entry(
        label, tp.gated_reduce,
        lambda: tp.gated_reduce(x, pct, n_ops, reps),
        lambda: tp.gated_reduce_reference(x.cpu(), pct, n_ops, reps),
        n_ops * reps, "iter",
        # Per step the word reduce (128 adds, 127 sums, t: 2), the gate
        # (3); per hit the second reduce (128 multiplies, 128 adds, 127).
        260 * n_ops * reps + 383 * hits, 512 + 4)


def _row_store(label, n_cells, n_ops, reps, device):
    idx = tp.indices(n_cells, n_ops, device)
    return entry(
        label, tp.row_store, lambda: tp.row_store(idx, n_cells, reps),
        lambda: tp.row_store_reference(idx, n_cells, reps), n_ops * reps,
        "store", 128 * n_ops * reps,
        # The indices; the scratch table and scr[0] written.
        4 * n_ops + 512 * n_cells + 512)


def _iteration(label, k, n_iters, reps, device, scale=1e-6):
    tree, idx = tp.iteration_inputs(k, scale=scale, n_iters=n_iters,
                                    device=device)
    rows = tp.iteration_rows(tree.cpu(), idx.cpu(), k, n_iters, reps)
    runs = n_iters * k * reps
    return entry(
        label, tp.iteration_core,
        lambda: tp.iteration_core(tree, idx, k, n_iters, reps),
        lambda: tp.iteration_core_reference(tree.cpu(), idx.cpu(), k,
                                            n_iters, reps),
        runs, "run",
        # Per run the opening test of the 8 weighted lanes (~12 each) and
        # the word; the other 120 lanes' results are dead in the probe.
        104 * runs, 512 * rows + 4 * idx.numel() + 4,
        expect_zero=scale == 1e-6)


def probes(device, quick=False, out=print):
    """The script's probes in its order; the tables that shared memory
    cannot hold go to device memory, with a printed line saying so."""
    r = (lambda n: 1) if quick else (lambda n: n)
    limit = tp.smem_optin_bytes(device) if device.type == "cuda" else None
    res = []
    for n in SMEM_SIZES:
        kb = n * 4 // 1024
        where = "shared"
        if limit is not None and 4 * n > limit:
            out(f"  smem {kb}KB: {4 * n} B exceeds the {limit} B of shared "
                f"memory one block can opt in to: read from device memory")
            where = "global"
        res.append(_smem(f"smem {kb}KB ({where})", n, where, 4096, r(20),
                         device))
    res += [_gated(f"gated {p}%", p, 4096, r(20), device)
            for p in (0, 15, 100)]
    res.append(_row_store("row-store", 8192, 4096, r(20), device))
    res += [_iteration(f"iter-core k{k}", k, 2048, r(10), device)
            for k in tp.K_RUNS]
    res += [_iteration(f"iter-core k{k} at 2^18 x 1e-6", k, 2048, r(10),
                       device, FIRE_SCALE) for k in tp.K_RUNS]
    return res


def run(device="cuda", quick=False, out=print):
    """The probes of ``scripts/decide18.py``; returns the timed entries."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("decide18: device cuda requested but "
                           "torch.cuda.is_available() is False")
    out(device_line(device))
    return run_probes(probes(device, quick, out), device, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="one in-kernel repetition (a CPU rehearsal)")
    a = ap.parse_args(argv)
    run(a.device, a.quick)
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
