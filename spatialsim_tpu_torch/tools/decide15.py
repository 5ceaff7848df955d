"""The traversal-primitive probes of ``scripts/decide15.py`` on this card
(port of that script's ``main()``).

    python -m spatialsim_tpu_torch.tools.decide15 --device cuda
    python -m spatialsim_tpu_torch.tools.decide15 --device cpu --quick

It runs the script's list of probes at the script's sizes through the
hand-written kernels of ``csrc/probes_decide15.cu`` and adds the Hopper
readings of the same functions: the ``chained`` form of every read probe
(each read waits on the last add, as a traversal's next cell waits on the
row it read), row reads from a table staged in shared memory (448 rows,
the most 227 KB hold), and row reads from a table of ``--octree-cells``
rows (the occupied cells of the port's 1M-galaxy octree, past the 50 MB
L2: by default counted on the card by ``build_diagnostics``; 0 skips
them, as on the CPU).

Beside each row-read, block-read, reduce-roundtrip, row-write,
scalar-load and extract8 line stands the card-wide instance of the same
function (``spread="card"``: the reads, steps, writes or visits cut into
``CARD_SLICES`` slices, one warp each, ``CARD_WARPS`` warps a block; the
shared-memory table one block of ``SHARED_WARPS`` an SM; the scalar
loads and extract8's one-hot variant one thread a slice,
``THREAD_WARPS`` warp a block): its ns per read, reduce, op or visit is
the card's rate over that many chains at once, where the one-warp or
one-thread line is one chain's latency.  Beside each reduce round trip
also stands the card-wide instance at one slice (``P=1/1``): the probe's
chain, ns a reduce beside the one-warp kernel's.  With
``--octree-cells``, row reads, row writes, scalar loads and extract8
visits also run at 204,800 x 1 on that table (extract8 on the same cells
packed 16 a row).  ``--sweep`` adds the card-wide row reads over
``SWEEP_SLICES`` x ``SWEEP_WARPS`` and the card-wide 5f over
``SWEEP_SLICES`` x ``SCALAR_SWEEP_WARPS``, both also on the octree's
table, each output held to the plain version of its slice count.

The first line is ``nvidia-smi``'s name and power limit; then one line a
probe: milliseconds a call by CUDA events after a warm-up (mean of
``REPS``), and nanoseconds per read, reduce or visit as the script
computes them.  A card-wide call's device work is shorter than its
wrapper's host time, so its ``CARD_REPS`` calls are queued behind a
sleep kernel first and the events time the card running them back to
back (:func:`queued_ms`); the line adds the time at the host's pace.
Then, for each card-wide grid, the launch floor (an empty launch, queued
the same way), and for each card-wide kernel and grid the call over no
reads (its launches, the second pass over zero partials, and for the row
write the zeroing of its scratch table).  ``--device cpu`` runs the plain
versions on a host clock, a rehearsal only (``--quick`` cuts the
in-kernel repetitions to 1).
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from spatialsim_tpu_torch.ops import traversal_probes as tp

REPS = 3                  # timed calls a probe, after one warm-up
CARD_REPS = 20            # timed calls a card-wide probe or launch floor
CARD_SLICES = 132 * 32    # P of the card-wide instances
CARD_WARPS = 8            # their warps a block
SHARED_WARPS = 32         # a block an SM where each stages 229,376 B
THREAD_WARPS = 1          # extract8 one-hot: a thread a slice, 132 blocks
PAST_L2_OPS = 204_800     # reads, writes or visits of the past-L2 tables
SWEEP_SLICES = (132 * 8, 132 * 16, 132 * 32, 132 * 64)
SWEEP_WARPS = (2, 4, 8, 16, 32)
SCALAR_SWEEP_WARPS = (1, 8)  # the card-wide 5f's sweep: warps a block
GATE_CYCLES = 20_000_000  # the sleep queued calls wait behind (~10 ms)

def device_line(device) -> str:
    """``nvidia-smi``'s name and power limit of the card (its own line)."""
    if device.type != "cuda":
        return "device cpu (plain versions, host clock: no device times)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def time_ms(fn, reps, device):
    """Mean milliseconds a call after one warm-up: CUDA events on a card,
    the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def queued_ms(fn, reps, device):
    """Mean milliseconds a call of ``fn`` with its calls queued on the card
    first: a sleep kernel holds the stream while the host enqueues
    ``reps`` calls, so the CUDA events time the card running them back to
    back, not the host's pace (a card-wide call's device work takes tens
    of microseconds, less than its wrapper's host time).  Raises if the
    host had not finished enqueuing when the sleep ended.  The host clock
    on the CPU."""
    if device.type != "cuda":
        return time_ms(fn, reps, device)
    fn()
    torch.cuda.synchronize(device)
    gate, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    gate.record()
    torch.cuda._sleep(GATE_CYCLES)
    start.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    end.record()
    torch.cuda.synchronize(device)
    if host_ms >= 0.9 * gate.elapsed_time(start):
        raise RuntimeError(f"queued_ms: {reps} calls took {host_ms:.3f} ms "
                           f"to enqueue, past the "
                           f"{gate.elapsed_time(start):.3f} ms sleep")
    return start.elapsed_time(end) / reps


def distinct_rows(idx) -> int:
    """Distinct indices: the rows a probe's function needs, read once."""
    return int(torch.unique(idx).numel())


def entry(label, kernel, call, plain, count, unit, ops, nbytes, *,
          library=None, library_exact=False, expect_zero=False, grid=None,
          idle=None):
    """One probe of a run: ``call()`` launches the kernel on prepared
    inputs, ``plain()`` runs the plain version (on CPU copies for the
    serial chains), ``count`` of ``unit`` per call (the script's divisor),
    ``ops``/``nbytes`` the work the function needs (distinct rows touched
    and the indices read once, outputs written once), ``library()`` one
    PyTorch call computing the same function, where there is one
    (``library_exact``: it stands only where it gives the plain version's
    last output bit for bit); ``expect_zero`` where the probe's own inputs
    give 0 (a check of such an entry is no check of the arithmetic, so an
    entry with inputs where it is not 0 must stand beside it).  ``grid``
    (blocks, threads) marks a card-wide instance: its ``key`` is the
    kernel's name with ``_card``, its launch floor is an empty launch of
    that grid, and ``idle`` is ``(name, fn)``: ``fn()`` the call over no
    reads, timed once a name."""
    return dict(label=label, kernel=kernel, call=call, plain=plain,
                count=count, unit=unit, ops=float(ops), nbytes=float(nbytes),
                library=library, library_exact=library_exact,
                expect_zero=expect_zero, grid=grid, idle=idle,
                key=kernel.__name__ + ("_card" if grid else ""))


def _spread(card, shared=False, threads=False):
    """(label suffix, wrapper keywords, grid) of the one-warp instance or
    of the card-wide one at ``CARD_SLICES``: one warp a slice, or one
    thread a slice (``threads``, extract8's one-hot variant)."""
    if not card:
        return "", dict(spread="warp"), None
    warps = (THREAD_WARPS if threads else SHARED_WARPS if shared
             else CARD_WARPS)
    per_block = 32 * warps if threads else warps
    return (f" card P={CARD_SLICES}/{warps}",
            dict(spread="card", slices=CARD_SLICES, warps=warps),
            (-(-CARD_SLICES // per_block), 32 * warps))


def _idle(name, kernel, tree, kw, **extra):
    """An entry's ``idle``: ``kernel`` on ``tree`` over no indices at the
    card-wide ``kw`` -- its launches, its second pass over zero partials
    and whatever the call does beside them."""
    none = torch.zeros(0, dtype=torch.int32, device=tree.device)
    return (f"{name} P={kw['slices']}/{kw['warps']}",
            lambda: kernel(tree, none, 1, **extra, **kw))


def _row_reads_idle(kw, device):
    """5a's card-wide call over no reads on a one-row table; 5b's entries
    of the same grid share it."""
    return _idle("row reads card", tp.row_reads, tp.table(1, device), kw)


def _row_reads(label, n_cells, n_reads, reps, width, device, *,
               chained=False, where="global", card=False):
    tree, idx = tp.row_inputs(n_cells, n_reads, device)
    used = (n_reads // width) * width
    bag = idx[:used].long().repeat(reps)[None, :]
    suffix, kw, grid = _spread(card, where == "shared")
    plain = ((lambda: tp.row_reads_card_reference(tree, idx, reps, width,
                                                  kw["slices"]))
             if card else lambda: tp.row_reads_reference(tree, idx, reps,
                                                          width))
    return entry(
        label + suffix, tp.row_reads,
        lambda: tp.row_reads(tree, idx, reps, width, chained=chained,
                             where=where, **kw),
        plain, used * reps, "read", 128 * used * reps,
        512 * distinct_rows(idx[:used]) + 4 * n_reads + 512,
        library=lambda: F.embedding_bag(bag, tree, mode="sum"), grid=grid,
        idle=grid and _row_reads_idle(kw, device))


def _block_read(label, n_cells, n_reads, reps, device, *, chained=False,
                card=False):
    tree, idx = tp.block_read_inputs(n_cells, n_reads, device)
    both = torch.stack([idx, idx + 1], 1).reshape(-1)
    bag = both.long().repeat(reps)[None, :]
    suffix, kw, grid = _spread(card)
    plain = ((lambda: tp.block_read_card_reference(tree, idx, reps,
                                                   kw["slices"]))
             if card else lambda: tp.block_read_reference(tree, idx, reps))
    return entry(
        label + suffix, tp.block_read,
        lambda: tp.block_read(tree, idx, reps, chained=chained, **kw),
        plain, n_reads * reps, "block", 256 * n_reads * reps,
        512 * distinct_rows(both) + 4 * n_reads + 512,
        library=lambda: F.embedding_bag(bag, tree, mode="sum"), grid=grid,
        idle=grid and _row_reads_idle(kw, device))


def _once(fn):
    """``fn`` computed at the first call and kept: a plain chain that the
    one-warp entry and the card-wide one at one slice share (one slice is
    the probe's chain)."""
    kept = []

    def call():
        if not kept:
            kept.append(fn())
        return kept[0]
    return call


def _chain_spread(slices, most=CARD_WARPS, threads=False):
    """(label suffix, wrapper keywords, grid) of a dependent chain's
    instance: the one-warp kernel (``slices`` None), or the card-wide one
    at ``slices`` (``CARD_WARPS`` warps a block, at most ``most``; one
    warp at one slice).  ``threads``: a thread a slice, one warp a block
    (``THREAD_WARPS``), the last block masked."""
    if not slices:
        return "", dict(spread="warp"), None
    warps = (THREAD_WARPS if threads else min(CARD_WARPS, most)
             if slices > 1 else 1)
    per_block = 32 * warps if threads else warps
    return (f" card P={slices}/{warps}",
            dict(spread="card", slices=slices, warps=warps),
            (-(-slices // per_block), 32 * warps))


def _reduce_roundtrip(label, n_ops, reps, batch, device, slices=None, *,
                      serial=None):
    """5c's entry: the one-warp kernel, or with ``slices`` the card-wide
    instance at that many slices.  The one-warp kernel and the card-wide
    one at one slice run the probe's chain, whose plain version is
    ``serial`` where given (a :func:`_once` the two entries share)."""
    x = tp.lane_row(device)
    steps = n_ops * reps
    suffix, kw, grid = _chain_spread(slices)
    plain = ((lambda: tp.reduce_roundtrip_card_reference(
        x.cpu(), n_ops, reps, batch, slices)) if slices and slices > 1
        else serial or (lambda: tp.reduce_roundtrip_reference(
            x.cpu(), n_ops, reps, batch)))
    return entry(
        label + suffix, tp.reduce_roundtrip,
        lambda: tp.reduce_roundtrip(x, n_ops, reps, batch, **kw), plain,
        steps * batch, "reduce",
        # f (2), per reduce 128 multiplies, 128 adds and 127 sums, the
        # batch's sum and the accumulate.
        steps * (2 + 383 * batch + batch), 512 + 4, grid=grid,
        # Over no steps: the launch and the second pass over zero partials.
        idle=grid and (f"reduce roundtrip b{batch}{suffix}",
                       lambda: tp.reduce_roundtrip(x, 0, 1, batch, **kw)))


def _row_write(label, n_cells, n_ops, reps, device, *, card=False):
    tree, idx = tp.row_write_inputs(n_cells, n_ops, device)
    suffix, kw, grid = _spread(card)
    plain = ((lambda: tp.row_write_card_reference(tree, idx, reps,
                                                  kw["slices"]))
             if card else lambda: tp.row_write_reference(tree, idx, reps))
    return entry(
        label + suffix, tp.row_write,
        lambda: tp.row_write(tree, idx, reps, **kw), plain,
        n_ops * reps, "op", 128 * n_ops * reps,
        # The rows read, the indices, the scratch table and scr[0] written.
        512 * distinct_rows(idx) + 4 * n_ops + 512 * n_cells + 512,
        grid=grid,
        # Over no writes the call still zeroes its n_cells-row table.
        idle=grid and _idle(f"row write card {n_cells} rows",
                            tp.row_write, tree, kw))


def _roll(label, shift, device):
    x = tp.lane_row(device)
    return entry(label, tp.roll, lambda: tp.roll(x, shift),
                 lambda: tp.roll_reference(x, shift), 1, "roll", 0, 1024,
                 library=lambda: torch.roll(x, shift, 1))


def _scalar(label, kernel, reference, n_cells, n_reads, reps, device, *,
            chained=False, card=False):
    tree, idx = tp.row_inputs(n_cells, n_reads, device)
    dyn_lane = kernel is tp.scalar_load_dyn_dyn
    c = idx.long()
    if dyn_lane:
        # The flat indices c 128 + (7 c mod 128), formed outside the call,
        # into the table as a (n_cells 128, 1) view: one bag.
        bag = (c * tp.ROW + (c * 7) % tp.ROW).repeat(reps)[None, :]

        def library():
            return F.embedding_bag(bag, tree.reshape(-1, 1), mode="sum")
    else:
        bag = c.repeat(reps)[None, :]

        def library():
            # Column 5 of the table as a (n_cells, 1) view: one bag.
            return F.embedding_bag(bag, tree[:, 5:6], mode="sum")
    suffix, kw, grid = _spread(card, threads=True)
    plain = ((lambda: tp.scalar_load_card_reference(tree, idx, reps,
                                                   kw["slices"], dyn_lane))
             if card else lambda: reference(tree, idx, reps))
    return entry(
        label + suffix, kernel,
        lambda: kernel(tree, idx, reps, chained=chained, **kw), plain,
        n_reads * reps, "read", n_reads * reps,
        4 * distinct_rows(idx) + 4 * n_reads + 4, library=library,
        grid=grid,
        idle=grid and _idle(
            f"scalar load ({'dyn lane' if dyn_lane else 'static lane'}) "
            "card", kernel, tp.table(1, device), kw))


def _extract8(label, n_cells, n_visits, reps, use_roll, device, *,
              chained=False, card=False):
    tree, idx = tp.extract8_inputs(n_cells, n_visits, device)
    suffix, kw, grid = _spread(card, threads=not use_roll)
    plain = ((lambda: tp.extract8_card_reference(tree, idx, reps,
                                                 kw["slices"]))
             if card else lambda: tp.extract8_reference(tree, idx, reps))
    return entry(
        label + suffix, tp.extract8,
        lambda: tp.extract8(tree, idx, reps, use_roll=use_roll,
                            chained=chained, **kw),
        plain, n_visits * reps, "visit", 8 * n_visits * reps,
        32 * distinct_rows(idx) + 4 * n_visits + 4, grid=grid,
        idle=grid and _idle(
            f"extract8 ({'roll' if use_roll else 'onehot'}) card",
            tp.extract8, tp.table(1, device), kw, use_roll=use_roll))


SCALARS = (("scalar load (dyn sub, static lane)", tp.scalar_load_dynsub,
            tp.scalar_load_dynsub_reference),
           ("scalar load (dyn sub, dyn lane) retry", tp.scalar_load_dyn_dyn,
            tp.scalar_load_dyn_dyn_reference))


def probes(device, quick=False, octree_cells=0):
    """The script's probes in its order, each with its chained form and,
    but for the roll, its card-wide instance beside it (the reduce round
    trip also at one slice); then the Hopper placements of the row reads
    and, with ``octree_cells``, the row reads, row writes, scalar loads
    and extract8 visits on the octree's table."""
    r = (lambda n: 1) if quick else (lambda n: n)
    both = (False, True)
    spreads = [(card, c) for card in both for c in both]
    out = []
    for label, n_cells, reps, width in (("row-read w1 8K", 8192, 50, 1),
                                        ("row-read w1 24K", 24576, 50, 1),
                                        ("row-read w2", 8192, 50, 2),
                                        ("row-read w4", 8192, 50, 4),
                                        ("row-read w8", 8192, 25, 8)):
        out += [_row_reads(label + (" chained" if c else ""), n_cells, 4096,
                           r(reps), width, device, chained=c, card=card)
                for card, c in spreads]
    out += [_block_read("block-read" + (" chained" if c else ""), 8192,
                        4096, r(50), device, chained=c, card=card)
            for card, c in spreads]
    out += [_row_write("row-write", 8192, 4096, r(50), device, card=card)
            for card in both]
    out.append(_roll("roll", 5, device))
    for b, reps in ((1, 50), (4, 50), (8, 25)):
        serial = _once(lambda b=b, reps=r(reps): tp.reduce_roundtrip_reference(
            tp.lane_row("cpu"), 4096, reps, b))
        out += [_reduce_roundtrip(f"reduce-roundtrip b{b}", 4096, r(reps), b,
                                  device, slices, serial=serial)
                for slices in (None, CARD_SLICES, 1)]
    for name, kernel, plain in SCALARS:
        out += [_scalar(name + (" chained" if c else ""), kernel, plain,
                        8192, 4096, r(20), device, chained=c, card=card)
                for card, c in spreads]
    for use_roll in (True, False):
        out += [_extract8(f"extract8 ({'roll' if use_roll else 'onehot'})"
                          + (" chained" if c else ""), 8192, 4096, r(10),
                          use_roll, device, chained=c, card=card)
                for card, c in spreads]
    # Hopper placements of 5a: shared memory, and past the L2 (the same
    # 4096 x 50 reads, then 204,800 reads once each).
    out += [_row_reads(f"row-read w1 shared {tp.SHARED_ROWS}" +
                       (" chained" if c else ""), tp.SHARED_ROWS, 4096,
                       r(50), 1, device, chained=c, where="shared",
                       card=card) for card, c in spreads]
    if octree_cells:
        for n_reads, reps in ((4096, r(50)), (PAST_L2_OPS, 1)):
            out += [_row_reads(
                f"row-read w1 {octree_cells} cells {n_reads}x{reps}" +
                (" chained" if c else ""), octree_cells, n_reads, reps, 1,
                device, chained=c, card=card) for card, c in spreads]
        # The append and the visit decode on the octree's cells: its
        # table's rows, and the same cells packed 16 a row.
        out += [_row_write(f"row-write {octree_cells} cells "
                           f"{PAST_L2_OPS}x1", octree_cells, PAST_L2_OPS, 1,
                           device, card=card) for card in both]
        rows = -(-octree_cells // 16)
        for use_roll in (True, False):
            out += [_extract8(
                f"extract8 ({'roll' if use_roll else 'onehot'}) {rows} rows "
                f"{PAST_L2_OPS}x1" + (" chained" if c else ""), rows,
                PAST_L2_OPS, 1, use_roll, device, chained=c, card=card)
                for card, c in spreads]
        # A traversal that reads one 4 B attribute a visit: the scalar
        # loads on the octree's table.
        for name, kernel, plain in SCALARS:
            out += [_scalar(
                f"{name} {octree_cells} cells {PAST_L2_OPS}x1"
                + (" chained" if c else ""), kernel, plain, octree_cells,
                PAST_L2_OPS, 1, device, chained=c, card=card)
                for card, c in spreads]
    return out


def launch_floor_ms(grid, device, reps=CARD_REPS):
    """Milliseconds a call of an empty launch of ``grid`` (blocks,
    threads) by CUDA events; None off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    like = torch.empty(1, device=device)
    return queued_ms(lambda: tp.empty_launch(*grid, like), reps, device)


def no_reads_ms(slices, warps, device, reps=CARD_REPS):
    """Milliseconds a card-wide row-read call over no reads: its launches
    and the second pass over ``slices`` zero partials."""
    device = torch.device(device)
    _, fn = _row_reads_idle(dict(spread="card", slices=slices, warps=warps),
                            device)
    return queued_ms(fn, reps, device)


def sweep(device, octree_cells=0, quick=False, out=print):
    """The card-wide row reads (w1, plain and chained) at every
    ``SWEEP_SLICES`` x ``SWEEP_WARPS`` on the 8K table (4,096 x 50 reads)
    and, given ``octree_cells``, on that table (204,800 x 1); each output
    held to the plain version of its slice count.  Prints a line a table,
    form and slice count, with the call over no reads at that count
    (:func:`no_reads_ms`); returns ``[{table, chained, slices, warps,
    ms, ns, equal}]``."""
    device = torch.device(device)
    tables = [("8K 4096x50", 8192, 4096, 1 if quick else 50)]
    if octree_cells:
        tables.append((f"{octree_cells} cells 204800x1", octree_cells,
                       204_800, 1))
    res = []
    for name, n_cells, n_reads, reps in tables:
        tree, idx = tp.row_inputs(n_cells, n_reads, device)
        for slices in SWEEP_SLICES:
            want = tp.row_reads_card_reference(tree, idx, reps, 1,
                                               slices).cpu()
            no_reads = no_reads_ms(
                slices, math.gcd(slices, CARD_WARPS), device)
            for chained in (False, True):
                cells = []
                for warps in SWEEP_WARPS:
                    def fn(slices=slices, warps=warps, chained=chained):
                        return tp.row_reads(tree, idx, reps, 1,
                                            chained=chained, spread="card",
                                            slices=slices, warps=warps)
                    equal = torch.equal(fn().cpu(), want)
                    ms = queued_ms(fn, CARD_REPS, device)
                    res.append(dict(table=name, chained=chained,
                                    slices=slices, warps=warps, ms=ms,
                                    ns=ms * 1e6 / (n_reads * reps),
                                    equal=equal))
                    cells.append(f"{warps} warps {ms:.4f} ms"
                                 + ("" if equal else " MISMATCH"))
                out(f"  sweep row-read w1 {name}"
                    f"{' chained' if chained else ''} P={slices} (over no "
                    f"reads {no_reads:.4f} ms): " + ", ".join(cells))
    return res


def scalar_sweep(device, octree_cells=0, quick=False, out=print):
    """The card-wide 5f (plain and chained) at every ``SWEEP_SLICES`` x
    ``SCALAR_SWEEP_WARPS`` on the 8K table (4,096 x 20 reads) and, given
    ``octree_cells``, on that table (204,800 x 1); each output held to the
    plain version of its slice count.  Prints a line a table, form and
    slice count, with the call over no reads at that count; returns
    ``[{table, chained, slices, warps, ms, ns, equal}]``."""
    device = torch.device(device)
    tables = [("8K 4096x20", 8192, 4096, 1 if quick else 20)]
    if octree_cells:
        tables.append((f"{octree_cells} cells {PAST_L2_OPS}x1", octree_cells,
                       PAST_L2_OPS, 1))
    res = []
    for name, n_cells, n_reads, reps in tables:
        tree, idx = tp.row_inputs(n_cells, n_reads, device)
        for slices in SWEEP_SLICES:
            want = tp.scalar_load_card_reference(tree, idx, reps,
                                                 slices).cpu()
            no_reads = queued_ms(_idle(
                "", tp.scalar_load_dynsub, tp.table(1, device),
                dict(spread="card", slices=slices, warps=1))[1],
                CARD_REPS, device)
            for chained in (False, True):
                cells = []
                for warps in SCALAR_SWEEP_WARPS:
                    def fn(slices=slices, warps=warps, chained=chained):
                        return tp.scalar_load_dynsub(
                            tree, idx, reps, chained=chained, spread="card",
                            slices=slices, warps=warps)
                    equal = torch.equal(fn().cpu(), want)
                    ms = queued_ms(fn, CARD_REPS, device)
                    res.append(dict(table=name, chained=chained,
                                    slices=slices, warps=warps, ms=ms,
                                    ns=ms * 1e6 / (n_reads * reps),
                                    equal=equal))
                    cells.append(f"{warps} warps {ms:.4f} ms"
                                 + ("" if equal else " MISMATCH"))
                out(f"  sweep scalar load (dyn sub) {name}"
                    f"{' chained' if chained else ''} P={slices} (over no "
                    f"reads {no_reads:.4f} ms): " + ", ".join(cells))
    return res


def octree_diagnostics(device, n=1_000_000) -> dict:
    """``build_diagnostics`` of the port's octree of the ``n``-body galaxy
    (seed 0) at the default config: its ``cells_per_level`` summed are the
    rows of the past-L2 table."""
    import numpy as np
    from spatialsim_tpu_torch import distributions
    from spatialsim_tpu_torch.config.nbody import NBODY
    from spatialsim_tpu_torch.ops import bh_window as bw
    p, v, m = distributions.generate_distribution(
        "galaxy", n, NBODY.spawn_radius, NBODY.G, seed=0)
    pos, vel, mass = (torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                      device=device) for a in (p.T, v.T, m))
    return bw.build_diagnostics(pos, vel, mass, NBODY.replace(num_bodies=n))


def run_probes(entries, device, out=print):
    """Time each probe (``REPS`` calls after a warm-up; a card-wide one
    ``CARD_REPS`` calls queued behind a sleep, :func:`queued_ms`, and at
    the host's pace); print one line each, then the launch floor of each
    card-wide grid; return the entries with ``ms``, ``ns`` and, on the
    card-wide ones, ``host_paced_ms``, ``floor_ms`` and ``no_reads_ms``
    added."""
    for e in entries:
        paced = ""
        if e["grid"]:
            e["ms"] = queued_ms(e["call"], CARD_REPS, device)
            e["host_paced_ms"] = time_ms(e["call"], CARD_REPS, device)
            paced = (f" (calls queued; {e['host_paced_ms']:.4f} ms at the "
                     f"host's pace)")
        else:
            e["ms"] = time_ms(e["call"], REPS, device)
        e["ns"] = e["ms"] * 1e6 / e["count"]
        out(f"  {e['label']}: {e['ms']:.4f} ms, {e['ns']:.2f} "
            f"ns/{e['unit']}{paced}")
    floors, idles = {}, {}
    for e in entries:
        grid = e["grid"]
        if not grid:
            continue
        if grid not in floors:
            floors[grid] = launch_floor_ms(grid, device)
            out(f"  launch floor, an empty <<<{grid[0]}, {grid[1]}>>>: "
                + ("not measured (no card)" if floors[grid] is None
                   else f"{floors[grid]:.4f} ms"))
        name, fn = e["idle"]
        if name not in idles:
            idles[name] = queued_ms(fn, CARD_REPS, device)
            out(f"  the call over no reads, {name} (launches, second "
                f"pass, zeroing): {idles[name]:.4f} ms")
        e["floor_ms"], e["no_reads_ms"] = floors[grid], idles[name]
    return entries


def run(device="cuda", quick=False, octree_cells=0, out=print):
    """The probes of ``scripts/decide15.py``; returns the timed entries."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("decide15: device cuda requested but "
                           "torch.cuda.is_available() is False")
    out(device_line(device))
    return run_probes(probes(device, quick, octree_cells), device, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="one in-kernel repetition (a CPU rehearsal)")
    ap.add_argument("--octree-cells", type=int, default=None,
                    help="rows of the past-L2 table (default: the 1M "
                         "galaxy's octree on a card; 0 skips it)")
    ap.add_argument("--sweep", action="store_true",
                    help="the card-wide row reads and 5f over slices x "
                         "warps")
    a = ap.parse_args(argv)
    cells = a.octree_cells
    if cells is None:
        dev = torch.device(a.device)
        cells = (sum(octree_diagnostics(dev)["cells_per_level"])
                 if dev.type == "cuda" else 0)
    run(a.device, a.quick, cells)
    if a.sweep and not all(r["equal"] for r in (
            sweep(a.device, cells, a.quick)
            + scalar_sweep(a.device, cells, a.quick))):
        print("FAILED: a card-wide output differs from its plain version")
        return 1
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
