"""The traversal-kernel option probes of ``scripts/decide18.py`` on this
card (port of that script's ``main()``).

    python -m spatialsim_tpu_torch.tools.decide18 --device cuda
    python -m spatialsim_tpu_torch.tools.decide18 --device cpu --quick
    python -m spatialsim_tpu_torch.tools.decide18 --octree-cells 0

It runs the script's list at the script's sizes through the kernels of
``csrc/probes_decide18.cu``: the int32 table read by a dependent chain at
32, 128, 256 and 512 KB, the gated second reduce at hit rates 0, 15 and
100%, the row store, and the iteration core at 1, 2 and 4 runs a step.
The probe's table scale (1e-6) fires no decision, so the iteration core
returns 0 there; each k also runs on the table at 2^18 x 1e-6, where
decisions fire and ``acc mod 3`` moves the next step's starts (so each
step's reads wait on the last step's word, as a traversal's do).
Beside each table read, gated reduce, the row store and each iteration
core stands its card-wide instance (``spread="card"``,
``tools/decide15.py``'s ``CARD_SLICES`` slices, one warp each, 8 warps a
block; the table read one thread a slice, one warp a block; timed as that
tool times its card-wide lines), and beside each table read, gated
reduce and iteration core the card-wide instance at one slice
(``P=1/1``): the probe's chain redesigned (the table read's modulo by n
formed a step ahead; the second reduce issued beside the first on every
step; the iteration core's reads off the dependent path), ns a read,
iteration or run beside the one-thread or one-warp kernel's.  With
``--octree-cells`` (by default the 1M galaxy's octree's, counted on a
card; 0 skips it, as on the CPU) the row store also runs 204,800 x 1 on
a table of that many rows, past the L2.  The row store's library call is
``index_put_`` under deterministic algorithms, which keeps the last of
duplicate indices.
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
    CARD_SLICES, PAST_L2_OPS, _chain_spread, _once, _spread, device_line,
    entry, octree_diagnostics, run_probes)

SMEM_SIZES = (8192, 32768, 65536, 131072)     # int32 entries: 32-512 KB
FIRE_SCALE = 1e-6 * 2 ** 18   # the iteration core's table where words fire


def _smem(label, n_i32, where, n_ops, reps, device, slices=None, *,
          serial=None):
    """6a's entry: the one-thread kernel, or with ``slices`` the card-wide
    instance at that many slices (a thread a slice, one warp a block).  The
    one-thread kernel and the card-wide one at one slice run the probe's
    chain, whose plain version is ``serial`` where given (a ``_once`` the
    two entries share)."""
    idx4 = tp.smem_inputs(device)
    suffix, kw, grid = _chain_spread(slices, threads=True)
    plain = ((lambda: tp.smem_table_card_reference(
        idx4.cpu(), n_i32, n_ops, reps, slices)) if slices and slices > 1
        else serial or (lambda: tp.smem_table_reference(
            idx4.cpu(), n_i32, n_ops, reps)))
    return entry(
        label + suffix, tp.smem_table,
        lambda: tp.smem_table(idx4, n_i32, n_ops, reps, where=where, **kw),
        plain, n_ops * reps, "read",
        # Per step: 1009 i, two adds, acc mod 7, mod n and the accumulate.
        6 * n_ops * reps, 16 + 4, grid=grid,
        # Over no steps: the launches, each block's table (or the one in
        # device memory) and the second pass over zero partials.
        idle=grid and (f"{label}{suffix}",
                       lambda: tp.smem_table(idx4, n_i32, 0, 1, where=where,
                                             **kw)))


def _gated(label, pct, n_ops, reps, device, slices=None, *, serial=None):
    """6b's entry: the one-warp kernel, or with ``slices`` the card-wide
    instance at that many slices.  The one-warp kernel and the card-wide
    one at one slice run the probe's chain, whose plain version is
    ``serial`` where given (a ``_once`` the two entries share)."""
    x = tp.lane_row(device)
    # The word: acc * 1e-20 never moves it, so the hits follow i alone.
    w = tp._f32_to_i32(x.sum())
    hits = sum(tp._i32(w + i) % 100 < pct for i in range(n_ops)) * reps
    suffix, kw, grid = _chain_spread(slices)
    plain = ((lambda: tp.gated_reduce_card_reference(
        x.cpu(), pct, n_ops, reps, slices)) if slices and slices > 1
        else serial or (lambda: tp.gated_reduce_reference(
            x.cpu(), pct, n_ops, reps)))
    return entry(
        label + suffix, tp.gated_reduce,
        lambda: tp.gated_reduce(x, pct, n_ops, reps, **kw), plain,
        n_ops * reps, "iter",
        # Per step the word reduce (128 adds, 127 sums, t: 2), the gate
        # (3); per hit the second reduce (128 multiplies, 128 adds, 127).
        260 * n_ops * reps + 383 * hits, 512 + 4, grid=grid,
        # Over no steps: the launch and the second pass over zero partials.
        idle=grid and (f"gated reduce{suffix}",
                       lambda: tp.gated_reduce(x, pct, 0, 1, **kw)))


def last_store_table(rows, vals, n_cells):
    """The row store's function in one PyTorch call: ``index_put_`` of
    every store's row (``rows``, int64, the stream) into a zeroed table,
    under deterministic algorithms, where it keeps the last of duplicate
    indices."""
    kept = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return torch.zeros((n_cells, tp.ROW), dtype=torch.float32,
                           device=rows.device).index_put_((rows,), vals)
    finally:
        torch.use_deterministic_algorithms(kept)


def _row_store(label, n_cells, n_ops, reps, device, *, card=False):
    idx = tp.indices(n_cells, n_ops, device)
    suffix, kw, grid = _spread(card)
    # The library call's inputs, formed outside it: each store's row and
    # values, iota + i.
    rows = idx.long().repeat(reps)
    vals = (torch.arange(tp.ROW, dtype=torch.float32, device=device)
            + torch.arange(n_ops, dtype=torch.float32,
                           device=device).repeat(reps)[:, None])
    plain = ((lambda: tp.row_store_card_reference(idx, n_cells, reps,
                                                  kw["slices"]))
             if card else lambda: tp.row_store_reference(idx, n_cells, reps))
    none = torch.zeros(0, dtype=torch.int32, device=device)
    return entry(
        label + suffix, tp.row_store,
        lambda: tp.row_store(idx, n_cells, reps, **kw), plain, n_ops * reps,
        "store", 128 * n_ops * reps,
        # The indices; the scratch table and scr[0] written.
        4 * n_ops + 512 * n_cells + 512,
        library=lambda: last_store_table(rows, vals, n_cells),
        library_exact=True, grid=grid,
        # Over no stores the call still zeroes its n_cells-row table.
        idle=grid and (f"row store card {n_cells} rows P={kw['slices']}/"
                       f"{kw['warps']}",
                       lambda: tp.row_store(none, n_cells, 1, **kw)))


def _iteration(label, k, n_iters, reps, device, scale=1e-6, slices=None):
    """6d's entry: the one-warp kernel, or with ``slices`` the card-wide
    instance at that many slices (``CARD_WARPS`` warps a block; one warp
    at one slice)."""
    tree, idx = tp.iteration_inputs(k, scale=scale, n_iters=n_iters,
                                    device=device)
    suffix, kw, grid = _chain_spread(slices, tp.ITER_WARPS)
    rows = tp.iteration_rows(tree.cpu(), idx.cpu(), k, n_iters, reps,
                             slices or 1)
    runs = n_iters * k * reps
    plain = ((lambda: tp.iteration_core_card_reference(
        tree.cpu(), idx.cpu(), k, n_iters, reps, slices)) if slices
        else lambda: tp.iteration_core_reference(tree.cpu(), idx.cpu(), k,
                                                 n_iters, reps))
    none = torch.zeros(0, dtype=torch.int32, device=device)
    return entry(
        label + suffix, tp.iteration_core,
        lambda: tp.iteration_core(tree, idx, k, n_iters, reps, **kw), plain,
        runs, "run",
        # Per run the opening test of the 8 weighted lanes (~12 each) and
        # the word; the other 120 lanes' results are dead in the probe.
        104 * runs, 512 * rows + 4 * idx.numel() + 4,
        expect_zero=scale == 1e-6, grid=grid,
        idle=grid and (f"iteration core k{k}{suffix}",
                       lambda: tp.iteration_core(tree, none, k, 0, 1, **kw)))


def probes(device, quick=False, out=print, octree_cells=0):
    """The script's probes in its order, the table reads, gated reduce, row
    store and iteration core with their card-wide instances beside them;
    the tables that shared memory cannot hold go to device memory, with a
    printed line saying so (the card-wide instance's 16 B of offsets
    counted); with ``octree_cells``, the row store at 204,800 x 1 on a
    table of that many rows."""
    r = (lambda n: 1) if quick else (lambda n: n)
    limit = tp.smem_optin_bytes(device) if device.type == "cuda" else None
    res = []
    for n in SMEM_SIZES:
        kb = n * 4 // 1024
        where = "shared"
        if limit is not None and 4 * n + tp.SMEM_CARD_BYTES > limit:
            out(f"  smem {kb}KB: {4 * n} B exceeds the {limit} B of shared "
                f"memory one block can opt in to: read from device memory")
            where = "global"
        serial = _once(lambda n=n: tp.smem_table_reference(
            tp.smem_inputs("cpu"), n, 4096, r(20)))
        res += [_smem(f"smem {kb}KB ({where})", n, where, 4096, r(20),
                      device, slices, serial=serial)
                for slices in (None, CARD_SLICES, 1)]
    for p in (0, 15, 100):
        serial = _once(lambda p=p: tp.gated_reduce_reference(
            tp.lane_row("cpu"), p, 4096, r(20)))
        res += [_gated(f"gated {p}%", p, 4096, r(20), device, slices,
                       serial=serial) for slices in (None, CARD_SLICES, 1)]
    both = (False, True)
    res += [_row_store("row-store", 8192, 4096, r(20), device, card=card)
            for card in both]
    if octree_cells:
        res += [_row_store(f"row-store {octree_cells} cells {PAST_L2_OPS}x1",
                           octree_cells, PAST_L2_OPS, 1, device, card=card)
                for card in both]
    for scale, at in ((1e-6, ""), (FIRE_SCALE, " at 2^18 x 1e-6")):
        for k in tp.K_RUNS:
            res += [_iteration(f"iter-core k{k}{at}", k, 2048, r(10),
                               device, scale, slices)
                    for slices in (None, CARD_SLICES, 1)]
    return res


def run(device="cuda", quick=False, out=print, octree_cells=0):
    """The probes of ``scripts/decide18.py``; returns the timed entries."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("decide18: device cuda requested but "
                           "torch.cuda.is_available() is False")
    out(device_line(device))
    return run_probes(probes(device, quick, out, octree_cells), device, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="one in-kernel repetition (a CPU rehearsal)")
    ap.add_argument("--octree-cells", type=int, default=None,
                    help="rows of the row store's past-L2 table (default: "
                         "the 1M galaxy's octree on a card; 0 skips it)")
    a = ap.parse_args(argv)
    cells = a.octree_cells
    if cells is None:
        dev = torch.device(a.device)
        cells = (sum(octree_diagnostics(dev)["cells_per_level"])
                 if dev.type == "cuda" else 0)
    run(a.device, a.quick, octree_cells=cells)
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
