#!/usr/bin/env python3
"""Smoke run of the PyTorch port's N-body and boids main paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA card and raises
without one: there is no CPU fallback, no phase's error is caught, and any
failure exits non-zero.  Phases, each printed with its seconds:

Kernels are numbered as in ``PERF.md``: 1 all-pairs (with its
targets-and-sources mode, the direct-sum oracle of every accuracy check
below: ``tools/oracle.py``), 2 pooled window eval, 3 dense window eval
(3b, 3c its column and matrix forms), 4 boids Morton window, 5a-6d the
traversal probes.

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   a fresh nvcc build of every kernel in ``spatialsim_tpu_torch/csrc``
   (registers and spills of kernels 1-4, 3b and 3c by instance), and the
   SASS instructions a pair of every instance of kernels 1-4, 3b and 3c
   (3c's tensor-core instances also HMMA a pair;
   ``tools/eval_tiles.py``), and of their previous versions when those
   sources lie in ``spatialsim_tpu_torch/_build/parent/`` (git-ignored;
   without them the previous kernels' lines say "not measured");
2. kernel 1 (all-pairs) against its plain version at N = 32,768, 30,001
   (ragged), 20,000, 15,000 and 10,000, galaxy ICs: the plan's instance
   (``allpairs_plan``) and every (threads, T, S) instance, each within
   1e-5 of max|a|, CUDA-event times beside the previous kernel's, the
   bound and its share, SASS instructions a pair, the issue-limited time,
   blocks per SM and waves;
3. kernel 2 (pooled window eval) against its plain version on the lists
   the port builds for the 1M galaxy, at steps_since 0 and 23; a second
   build of the same state equal to the first bit for bit, its eval too
   (no deterministic algorithms: the octree's sums and the residual fold
   are fixed-order segment sums), and one build under ``torch.profiler``
   (the segment sums' device time beside ``index_add_``'s); then every
   T (targets a thread) and the heavy-first launch order, each held to the
   plain version, beside the previous kernel, with the bound, SASS
   instructions a pair, the issue-limited time, blocks per SM and waves;
4. the main path with every kernel launch counted from zero: the
   all-pairs engine (``NBodySimulation(num_bodies=32_768)`` and
   ``num_bodies=10_000``, ``tiny_galaxy``'s count, 10 steps each, their
   median step beside the same steps through the previous kernel) and
   the window engine (``NBodySimulation(num_bodies=1_000_000,
   device="cuda")`` with the default config, 48 steps at dt 0.02: one
   rebuild at step 25 on top of the initial build);
5. force accuracy against a direct sum on 4,096 sampled bodies: the rms
   of the per-body relative error |da|/|a| (the statistic of the JAX
   package's accuracy table), under that table's protocol (5 warm-up
   steps, then lists frozen to tau = 23; limits 5% fresh, 8% at tau=23),
   and for the main path's own last interval (reported); once, the fresh
   lists' rms through the plain chunked oracle and through the kernel
   (at most 1e-4 apart);
6. the recorder: the bar_galaxy preset at 1M in this process (a frame's
   steps timed, then a plain frame and a rebuild frame, steps and capture,
   under ``torch.cuda.set_sync_debug_mode("warn")``: a plain frame may not
   synchronise), the capture's kernels launched once each a frame and
   held to their plain versions bit for bit on that state
   (``check_capture``), then the CLI at 1M (10 frames; its frame time beside the
   steps of a frame) and 8K (tiny_galaxy, 30 frames, the all-pairs
   engine), last frames decoded; then the port's headless playback of the
   8K session (``python -m spatialsim_tpu_torch.tools.playback``, every
   frame decoded, motion finite) and one ``render_points`` image of its
   last frame;
7. kernel 4 (boids Morton window) against its plain version on the 500K
   ``Flock``'s initial state and again after 48 steps: pass 1 (no dedup)
   and pass 2 (dedup against pass 1's window), max|d|/max|ref| per
   accumulator group (limit 2e-4) and the share of boids whose counts
   differ (limit 1e-4), CUDA-event times; then every T with the box cull
   on and off, each equal bit for bit to the previous kernel's same
   instance (the kernel before the modes; or, without its sources, to the
   wrapper's instance), with the share of window
   pairs the cull skips, the bound over the window's pairs and over the
   pairs tested, SASS counts, the issue-limited time, blocks per SM and
   waves;
8. the boids main path with every kernel launch counted from zero:
   ``Flock(num_boids=500_000)`` and ``Flock(num_boids=100_000)`` at the
   default config, 96 steps each at dt 1/30 (2 launches a step, 15
   re-sorts), each step synchronised (labelled "Flock rate": the
   ``bench.py`` names are phase 21's, from the port bench), then the same runs
   through the previous kernel (when its sources are there), and the 20K
   grid mode (no kernel, 10 steps);
9. the 500K flock after those 96 steps: window forces against the exact
   grid (``cell_capacity`` at the largest cell occupancy), the share of
   boids whose force agrees at atol 1e-4 and the share of neighbour pairs
   the window captures (both >= 0.99);
10. where the device time goes, under ``torch.profiler``: the 500K flock
    over 12 more steps (2 re-sorts; then 12 through the previous kernel
    when its sources are there), and the 1M N-body window engine over
    the 3 steps around a rebuild and 20 steps between rebuilds: wall and
    device-busy milliseconds, the idle share, the kernels by device time
    (the profiler adds host time, so the idle share is an upper bound);
11. kernel 3 (dense window eval) against its plain version (limit 1e-4
    of max|a|): the 1M quadrupole lists (R = 16) at steps_since 0 and 23,
    the 1M galaxy's dense lists from ranges emission (R = 10), the same
    with a seeded near table (K = 4), and the 50M ``extreme_50m_galaxy``
    lists (R = 8) on 512 seeded groups; CUDA-event times, pairs a second
    and the bound, and at steps_since 23 phase 3's T and previous-kernel
    report.  The 50M ``NBodySimulation`` is built here and stepped in
    phase 13;
12. the dense path at 1M: dense and pooled lists of one calibrated
    config (equal ``far_n`` in every group, evals within 1e-4 of
    max|a|); the quadrupole main path (``NBodySimulation(num_bodies=
    1_000_000, config=NBODY.replace(use_quadrupole=True))``, 48 steps at
    dt 0.02, launches counted from zero); and phase 5's protocol with
    fresh quadrupole and monopole lists of one state (median error ratio
    <= 0.55, quadrupole rms <= 5%);
13. the 50M preset through ``NBodySimulation``: set-up seconds, 26 steps
    at the preset's dt (one rebuild, launches counted from zero), peak
    memory, per-group mass conservation after both builds (1e-4), force
    error on 4,096 bodies against a direct sum (the run's lists and fresh
    ones), the eval kernel on the run's lists beside the previous one, a
    ``torch.profiler`` breakdown of the next rebuild step and 4 plain
    steps, and the recorder CLI for 3 frames (its frame time beside the
    median step; last frame decoded).

14. near groups: ``NBodySimulation(num_bodies=1_000_000,
    config=NBODY.replace(near_groups=8))``, 48 steps (dense R = 10 lists,
    kernel 3 with K = 8), per-group mass (window + near + far + residual)
    after both builds (1e-4), and phase 5's protocol: fresh K = 8 and K = 0
    lists of one state (median ratio <= 1.05, ``tests/test_bh_window.py:
    359``), then each configuration's lists aged to tau = 23 (reported);
15. moment refresh: the pooled 1M with ``refresh_interval=12``, 48 steps
    (2 refreshes, 1 rebuild; refresh, rebuild and plain step times), and
    phase 5's protocol at tau = 23 with and without refreshes (median with
    them no worse, ``tests/test_bh_window.py:452``);
16. the pooled finishes at 1M from one state and one set of
    accelerations: cell-id, ranges, values + ``build_pool`` (rebuild times,
    equal far_n, pooled evals within 1e-4 of max|a|);
17. the dense eval's row, column and matrix kernels through
    ``tools/eval_ab.py`` at 1M (launches counted from zero over its run;
    its CUDA-event times are the kernels' times), then each against its
    own plain version on the K = 0 and K = 8 lists (1e-4 of max|a|),
    pairs a second and the bound over the live far entries; the matrix
    form's distance from the row form (report, fails above 1e-3); then
    every instance of kernel 3b (T 1, 2, 4, in group order and
    heavy-first, equal bit for bit) held to its plain version, beside the
    previous kernel, with its share of the bound, the plan's instance
    beside the fastest, SASS instructions a pair, the issue-limited time,
    registers and spills, blocks per SM and waves; then every instance of
    kernel 3c (the register tile at T 1, 2, 4 and the split-TF32
    tensor-core contraction at M 2, 4, in both orders, equal bit for bit)
    held to its plain version at steps_since 0 and 23, beside the previous
    kernel (and its distance from it), the same readings as 3b's plus
    pairs a second over the whole-tile pairs, the share of the MUFU floor
    and HMMA a pair;
18. the exact engine: ``NBodySimulation(num_bodies=1_000_000,
    config=NBODY.replace(engine="exact"))``, 5 steps, and its force error
    on 4,096 bodies against the oracle's direct sum, beside the window
    engine's on the same state;
19. the traversal-primitive probes of ``scripts/decide15.py`` and
    ``decide18.py`` through ``tools/decide15.py`` and ``tools/decide18.py``
    (launches counted from zero over their runs; their CUDA-event times
    are the kernels' times), plus the Hopper placements (chained reads,
    a shared-memory table, a table of the 1M octree's occupied cells,
    counted by the tool's ``octree_diagnostics``) and the iteration core
    where decisions fire, and beside each row read, block read, reduce
    round trip, row write, scalar load, extract8, table read, gated
    reduce, row store and iteration core its card-wide instance
    (``spread="card"``: the reads, writes or visits cut into slices, one
    warp each, or one thread each for the scalar loads, the table reads
    and extract8's one-hot variant, over
    every SM; the row write, the scalar loads, the extract8 visits and the
    row reads also 204,800 x 1 on the octree's cells), then the tool's
    sweeps of the card-wide row reads over slices x warps a block and of
    the card-wide 5f over slices x warps, both also on the octree's cells
    (each output equal bit for bit to the plain version of its slice
    count);
    ``where="shared"`` at 256 KB
    raises before any launch, in both instances; then each probe against
    its plain version on the same inputs, bit for bit (the row write's and
    row store's whole scratch tables too; each card-wide instance also to
    a second call of itself; each card-wide instance of a dependent chain
    at one slice, 5c's, 6a's, 6b's and 6d's, also to the one-warp or
    one-thread kernel on the same inputs; 6a also on offsets near +-2^31,
    where ``s + acc mod 7`` wraps in int32, at its four sizes and two that
    do not divide 2^32; 6b also where its words saturate, at ``arange x
    2^24``), every output
    not 0 but where the probe's own inputs give 0,
    with its bound, the card-wide instances' share of it and their launch
    floor (an empty launch of the same grid), and the time of one PyTorch
    call that computes the same function where there is one
    (``embedding_bag`` for the row, block and both scalar reads,
    ``torch.roll``); the traversal estimate (``traversal_estimate``:
    fetch, the card-wide chained ns a read on the octree's table times the
    worklist slots of a 1M build, and beside it, outside the sums, the
    card-wide chained 5f's ns a 4 B read times the same slots; decode, the
    chained extract8 ns a visit,
    each variant, times the same slots; emission, the row write's ns an op
    times the build's far-list entries, an upper bound; each also less its
    call over no reads, and their sums); then the roll probe,
    ``torch.roll`` and the roll probe through the previous launch path
    (``PreviousRollPath``) on equal terms, in 8 rounds of alternating
    order (medians compared): CUDA events over 100 back-to-back calls and
    the host's enqueue time a call; their kernels' device time under the
    profiler; the launch path's pieces,
    previous and new, over 10,000 calls each; and the host enqueue time a
    call of every kernel wrapper at its main-path shape (measured in
    phases 2, 3, 7, 11, 17 and here);
20. ``parallel/`` at 1,048,576 bodies (the 1M galaxy rounded to a
    multiple of 8 x 256; the default config calibrated, ``pool_tile=0``):
    (a) kernel 3's ``haloed`` and ``local_slice`` modes through the row,
    column and matrix kernels on every shard of D = 2, 4 and 8, each shard
    within 1e-4 of max|a| of its plain version and the concatenation of the
    unsharded kernel's output (bit-equality reported), CUDA-event ms a
    shard beside the unsharded launch; (b) ``build_lists_sorted`` over each
    quarter of the groups against the full build (far_n equal where
    neither folds, evals within 1e-4 of max|a|); (c) the sharded window
    step through NCCL at world size 1: 4 steps across a rebuild against the
    unsharded dense step (2e-4), the replicated fallback forced once, then
    48 steps timed beside the unsharded dense step (kernel 3's launches
    counted from zero: the sharded main path), the drift max-reduction's
    cost, and 20 steps of each under the profiler; (d) the ring at 32,768
    against the all-pairs kernel (each hop one launch of kernel 1's
    targets-and-sources mode), the exact engine against itself (equal
    bit for bit, required) and sharded Barnes-Hut at 1,048,576 against it,
    all without deterministic algorithms; (e) the sharded boids step
    through NCCL at world size 1, 500,224 boids, the default config:
    kernel 4's haloed mode on the step's inputs against its plain version
    (2e-4 of max|ref|) and the unsharded kernel (bit-equality reported),
    13 steps across two re-sorts against ``Flock``'s window step (rtol and
    atol 2e-4; bit-equality reported), then 96 steps timed beside
    ``Flock``'s with kernel 4's launches counted from zero;
21. (a) compact emission at 1M (the default config calibrated, one
    state): the ranges, compact and compact-mm pools equal bit for bit
    (compact-mm is the compact path on the port), kernel 2 equal on the
    three pools, 3 CUDA-synchronised builds of each mode
    beside the cell-id finish, then ``NBodySimulation(num_bodies=
    1_000_000, config=NBODY.replace(traversal_emit="compact"))`` for 48
    steps, launches counted from zero; (b) the port bench
    (``python -m spatialsim_tpu_torch.tools.bench``, the full suite in its
    own processes): the card line and four JSON lines under ``bench.py``'s
    names, values finite and positive, no metric failed, each metric's
    kernel launches; (c) 10M bodies at the bench's 10m config through
    ``NBodySimulation`` (the Plummer cluster, depth 9, group 1024, list
    cap 8192, pooled): set-up seconds, peak memory, per-group mass (1e-4),
    phase 5's protocol on 4,096 bodies (fresh <= 5%, tau = 23 reported)
    and kernel 2 on the run's lists (T = 4) against its plain version,
    the capture's kernels against theirs (``check_capture``);
    for this config and ``scripts/extreme_run.py``'s (reported): the list
    line, worklist demand against caps and the fresh-list error on 1,024
    and 4,096 bodies;
    (d) the readings behind ``tools/record.py``'s estimate anchors beside
    its constants (the 1M bench line, the bench at 10,000 bodies with the
    all-pairs engine, kernel 1 at 32,768), then ``record --estimate`` for
    ``tiny_galaxy`` at 8K, ``bar_galaxy`` at 1M and the 50M preset beside
    the times this run measured there (printed, not gated);
22. (a) kernel 1's targets-and-sources mode (``allpairs_accel_at``)
    against its plain version at the main path's shapes, 4,096 targets
    x 1,048,576, 10M and 5e7 sources (float32 plain on every target up
    to 2M sources, on 64 above; float64 plain on 64; within 1e-5 of
    max|a|), two calls equal
    bit for bit, CUDA-event ms beside the plain chunked oracle's and the
    bound, and the ring's hop sums at 32,768 bodies on one card (D 1 and
    2, plain chunks against the mode); (b) a short call of every
    measurement tool on the card: ``tools/staleness_scan.py`` at 262,144
    bodies (taus 0 and 32; at tau 0 the stale rms within 5% of the
    fresh), ``nbody_error``, ``nbody_error_scan`` and ``quad_scan`` at
    65,536, ``extreme_run`` at 1M (10 steps), ``prof_parts`` at 262,144,
    and ``verify_drive`` (the recorder CLI at 8K ``tiny_galaxy``: 30
    frames, SIGINT at 10 frames on disk when it comes in time, status,
    resume, extend by 10, frame 39 decoded); the mode's main-path
    launches are the ring's (phase 20 (d)) and the tools' (22 (b)), each
    counted from zero just before its run and required above 0; the
    oracle's in the accuracy checks of phases 5-21 and 22 (a)'s
    comparisons are printed apart as reference launches;
23. (a) kernel 3's stage-ablation instances (``window_eval(...,
    dbg=...)``) on phase 11's 1M dense R=10 lists at steps_since 23: every
    row of ``tools/decide7.py`` (the far lists kept or zeroed; ``nowin``,
    ``nostage``, ``notgt``, ``nouttr``) at every T (1, 2, 4) in the
    heavy-first order, each within 1e-4 of max|a| of its plain version
    (for ``nouttr`` of the largest block sum), CUDA-event ms and the
    bound of each row at the plan's T; the default instance equal bit for
    bit to phase 11's output; (b) a short call of every rebuild and eval
    tool's ``main`` on the card: ``decide7`` at 1M (the ablation
    instances' main path: their launches counted from zero over it and
    required above 0), ``prof_rebuild``, ``eval_bench`` (its first
    variant), ``diag10m``, ``decide29``, ``decide_1m`` and
    ``quick_metrics`` at 262,144 bodies;
24. (a) the rebuild's phase ablations on phase 3's 1M state: the default
    build again, equal bit for bit to phase 3's lists; the ranges
    traversal (``_traverse_global``) with each of "gather_cell",
    "gather_group", "emit", "sliver", "expand" and ("emit", "sliver"),
    and the calibrated build (``build_lists``) with each of them and with
    "finish", on the card and on the CPU: every integer output (far_n,
    sl_n, the worklist fills and demands, the ranges; order, inv_order,
    pstart and the pool's range rows) equal bit for bit; (b) a short call
    of every decomposition tool's ``main`` on the card: ``decide21``,
    ``decide27``, ``decide25``, ``decide26`` and ``decide23`` at 262,144
    bodies, ``decide24``, ``decide22`` and ``gather_bench`` at reduced
    shapes, ``decide16``, ``decide12`` and ``boids_capture`` at 100,000
    boids, with each tool's seconds and its launches of kernels 1 (the
    targets-and-sources mode), 2, 3 and 4, counted from zero, as in phase
    25 (``decide13`` runs there); (c) kernel 4's launches in decide12's
    run, required above 0;
25. the last tools of ``scripts/`` on the card, each ``main`` run short:
    ``decide20``, ``decide14``, ``seam_analysis``, ``nbody_scan2``,
    ``decide2``-``decide6``, ``decide8``-``decide11`` and the repaired
    ``decide13`` (its fold counts and dense line) at 262,144 bodies,
    the boids rows of ``decide5`` and ``decide6`` at 100,000 boids,
    ``decide19`` at reduced widths and ``distsort_bench`` at world size 1
    (NCCL); a tool's nonzero exit or a ``FAILED`` line in its output fails
    the run; each tool's seconds and its launches of kernels 1 (the
    targets-and-sources mode), 2, 3 (its default and ablation instances)
    and 4, counted from zero just before its run.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
N_MAIN = 1_000_000
DT = 0.02
STEPS = 48
N_SAMPLE = 4096
AP_STEPS = 10
# Kernel 1's sizes: 32,768 (the all-pairs engine's threshold), a ragged
# 30,001, and the presets' 20,000 (demo_cluster), 15,000 (tiny_collision)
# and 10,000 (tiny_galaxy).
AP_SIZES = (32_768, 30_001, 20_000, 15_000, 10_000)
AP_ENGINE_SIZES = (32_768, 10_000)
TOL_ALLPAIRS = 1e-5    # rsqrtf (~2 ulp) + FMA contraction vs plain rsqrt/div
TOL_WINDOW = 1e-4      # same, summed over ~4K sources in another order
N_BOIDS = 500_000
BOIDS_DT = 1.0 / 30.0
BOIDS_STEPS = 96
TOL_BOIDS = 2e-4       # the JAX package's bar for its kernel vs XLA form
TOL_BOIDS_COUNTS = 1e-4   # share of boids whose counts may differ
ROLL_CALLS = 100       # back-to-back calls timing 5e beside torch.roll
ROLL_ROUNDS = 8        # rounds of those, in alternating order
SPLIT_CALLS = 10_000   # calls timing each piece of the launch path
# Kernel wrapper name -> host microseconds a call to enqueue, at its
# main-path shape (phases 2, 3, 7, 11, 17 and 19).
ENQUEUE_US = {}
PRESET_50M = "extreme_50m_galaxy"
STEPS_50M = 26         # at rebuild interval 24: one rebuild, at step 25
# H100 SXM peaks (NVIDIA data sheet, 700 W): FP32 outside the tensor
# cores, HBM3 bandwidth.  A bound is the larger of ops/peak, bytes/peak.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# 6a's tables at the offsets near +-2^31 (phase 19): the probe's four sizes
# and two that do not divide 2^32.
SMEM_EDGE_TABLES = ((8192, "shared"), (32768, "shared"), (65536, "global"),
                    (131072, "global"), (8191, "shared"), (131071, "global"))
# The probe kernels of phase 19: wrapper name -> the script and the line of
# the TPU kernel's pallas_call it replaces.
PROBE_KERNELS = {
    "row_reads": ("decide15", 64), "block_read": ("decide15", 101),
    "row_reads_card": ("decide15", 64), "block_read_card": ("decide15", 101),
    "reduce_roundtrip": ("decide15", 143),
    "reduce_roundtrip_card": ("decide15", 143), "row_write": ("decide15", 177),
    "row_write_card": ("decide15", 177),
    "roll": ("decide15", 206), "scalar_load_dynsub": ("decide15", 239),
    "scalar_load_dyn_dyn": ("decide15", 272),
    "scalar_load_dynsub_card": ("decide15", 239),
    "scalar_load_dyn_dyn_card": ("decide15", 272),
    "extract8": ("decide15", 325),
    "extract8_card": ("decide15", 325),
    "smem_table": ("decide18", 60), "smem_table_card": ("decide18", 60),
    "gated_reduce": ("decide18", 99),
    "gated_reduce_card": ("decide18", 99),
    "row_store": ("decide18", 135), "iteration_core": ("decide18", 198),
    "row_store_card": ("decide18", 135),
    "iteration_core_card": ("decide18", 198),
}


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name):
    print(f"\n=== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"    phase seconds: {time.perf_counter() - t0:.3f}", flush=True)


def sm_clock():
    """``nvidia-smi``'s SM clock now and its maximum, as it prints them:
    beside a latency probe's ns, they read as cycles."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean milliseconds per call by CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_errors(got, want):
    """(max|da|, max|da| / max|a|) of a kernel against its plain version."""
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / float(want.abs().max())


def bound(ops, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``ops`` FP32 operations on ``nbytes`` read once and written once."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes
            else (t_bytes, "bytes"))


def record_kernel(kernels, name, abs_err, rel_err, ms, plain_ms, ops,
                  nbytes):
    """Keep the worst error over a kernel's checks, and its first timing
    with the bound of that call's work."""
    bound_ms, bound_by = bound(ops, nbytes)
    rec = kernels.setdefault(name, dict(
        max_abs_err=0.0, max_rel_err=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    rec["max_rel_err"] = max(rec["max_rel_err"], rel_err)


def boids_pass_inputs(state, cfg):
    """Pass-1 and pass-2 kernel inputs of a boids window state, built as
    the frozen window step builds them."""
    from spatialsim_tpu_torch.ops.boids_ops import pass1_inputs, pass2_inputs
    s1 = pass1_inputs(state.pos, state.vel, state.col, state.p21.numel())
    return ((*s1, None),
            pass2_inputs(*s1, state.p21, state.pos.shape[1], cfg.group_size))


def window_pairs(ng, gsz, wg):
    """Pairs one window pass evaluates: every group's in-range window
    groups, gsz x gsz pairs each."""
    import numpy as np
    g = np.arange(ng)
    groups = np.minimum(g + wg, ng - 1) - np.maximum(g - wg, 0) + 1
    return int(groups.sum()) * gsz * gsz


# Kernels whose device time the rebuild profiles sum: the fixed-order
# segment sums (torch.segment_reduce) and index_add_'s kernels (the integer
# counts; before the segment sums, the float fold too).
REBUILD_WATCH = ("segment_reduce", "indexFunc")


def profile_steps(label, step, steps, watch=()):
    """Run ``step`` ``steps`` times under torch.profiler; print the wall
    and device-busy milliseconds, the idle share, the kernels that took
    the most device time, and the summed time of the kernels whose names
    hold each string of ``watch``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):          # union of the device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3
    print(f"    {label}: wall {wall_ms:.3f} ms under the profiler, device "
          f"busy {busy_ms:.3f} ms ({1 - busy_ms / wall_ms:.1%} idle), "
          f"{len(spans)} device events")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    for name, (us, n) in top:
        print(f"      {us / 1e3:9.3f} ms  {n:5d}x  {name[:90]}")
    for w in watch:
        hits = [v for k, v in by_name.items() if w in k]
        print(f"      kernels named *{w}*: {sum(u for u, _ in hits) / 1e3:.3f}"
              f" ms in {sum(c for _, c in hits)} launches")


def galaxy(n, seed, device):
    import numpy as np
    import torch
    from spatialsim_tpu_torch import distributions
    from spatialsim_tpu_torch.config.nbody import NBODY
    p, v, m = distributions.generate_distribution(
        "galaxy", n, NBODY.spawn_radius, NBODY.G, seed=seed)
    return (torch.as_tensor(np.ascontiguousarray(p.T, np.float32),
                            device=device),
            torch.as_tensor(np.ascontiguousarray(v.T, np.float32),
                            device=device),
            torch.as_tensor(m.astype(np.float32), device=device))


def rebuilt_lists(bw, st, config, acc):
    """Lists rebuilt from a sorted window state with accelerations ``acc``
    (so the order-2 acc rows are live), ``order`` relative to the original
    body ids."""
    return bw._resort_state(st.pos, st.vel, st.mass, st.lists.order,
                            st.lists.inv_order, bw._build_kw(config),
                            acc=acc)[3]


def padded_sorted(st):
    """A window state's sorted (3, n)/(n,) -> the (3, npad)/(npad,) kernel
    input, padded as ``eval_accel_sorted`` pads it."""
    import torch
    n = st.pos.shape[1]
    pad = st.lists.order.shape[0] - n
    return (torch.cat([st.pos, st.pos[:, -1:].expand(3, pad)], 1)
            .contiguous(), torch.cat([st.mass, st.mass.new_zeros(pad)]))


def dense_work(lists, gsz, wg, near):
    """(window pairs, far pairs, bytes) of one dense eval over all groups:
    every in-range window group and valid near group is gsz x gsz pairs,
    every live far entry gsz pairs.  Bytes: the bodies, the live far
    entries, far_n and the near table read once, accelerations written
    once."""
    import torch
    far_n = lists.far_n.long()
    ng = far_n.shape[0]
    g = torch.arange(ng, device=far_n.device)
    n_src = torch.clamp(g + wg, max=ng - 1) - torch.clamp(g - wg, min=0) + 1
    if near is not None:
        n_src = n_src + ((near >= 0) & (near < ng)).sum(1)
    live = int(far_n.sum())
    nbytes = 4 * (ng * gsz * (4 + 3) + lists.far.shape[1] * live + ng
                  + (0 if near is None else near.numel()))
    return int(n_src.sum()) * gsz * gsz, live * gsz, nbytes


def check_dense(kernels, label, lists, s_pos, s_mass, near, steps_since,
                kw, groups=None, tiles=None):
    """The dense kernel against its plain version on one set of lists
    (only ``groups``' bodies, when given): error, CUDA-event times, pairs a
    second and the bound; the first call's timing is the one the summary
    keeps.  With ``tiles`` (the previous kernels' library and the SASS
    tables of phase 1), also :func:`report_tiles`."""
    import torch
    from spatialsim_tpu_torch.ops.bh_eval_kernel import (
        dense_launch, far_layout, heavy_first, occupancy, tile_targets,
        window_eval, window_eval_reference)
    from spatialsim_tpu_torch.tools import eval_tiles
    gsz = kw["group_size"]
    args = (s_pos, s_mass, lists.far, lists.far_n, near, steps_since, DT)
    got = window_eval(*args, **kw)
    want = window_eval_reference(*args, groups=groups, **kw)
    torch.cuda.synchronize()

    def pick(out):
        if groups is None:
            return out
        return out[:, (groups[:, None] * gsz + torch.arange(
            gsz, device=groups.device)).reshape(-1)]
    got = pick(got)
    abs_err, err = kernel_errors(got, want)
    ms = cuda_ms(lambda: window_eval(*args, **kw), 5)
    if "window_eval" not in ENQUEUE_US:
        ENQUEUE_US["window_eval"] = enqueue_us(
            lambda: window_eval(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: window_eval_reference(*args, groups=groups,
                                                     **kw), 1)
    win, far, nbytes = dense_work(lists, gsz, kw["window_groups"], near)
    # FP32 operations a pair, counted from the kernel's body (FMA as 2,
    # rsqrt and the gate not counted): 18 for the monopole law, 49 for the
    # quadrupole law.
    ops = 18.0 * win + (49.0 if far_layout(lists.far.shape[1])[0]
                        else 18.0) * far
    b_ms, b_by = bound(ops, nbytes)
    plain_of = "all groups" if groups is None else f"{len(groups)} groups"
    print(f"    {label}: max|da| = {abs_err:.3e}, max|da|/max|a| = "
          f"{err:.3e} (tol {TOL_WINDOW})  kernel {ms:.4f} ms for "
          f"{win + far:.4e} pairs ({win:.4e} window, {far:.4e} far) = "
          f"{(win + far) / ms / 1e6:.1f} Gpairs/s; bound {b_ms:.4f} ms "
          f"({b_by}); plain {plain_ms:.4f} ms ({plain_of})")
    require(err <= TOL_WINDOW, f"{label}: dense window eval error {err}")
    record_kernel(kernels, "window_eval", abs_err, err, ms, plain_ms, ops,
                  nbytes)
    if tiles is None:
        return
    R = lists.far.shape[1]
    quad = far_layout(R)[0]
    t = tile_targets(gsz, R)
    K = 0 if near is None else near.shape[1]
    plib = tiles["plib"]
    report_tiles(
        label, lambda T, order: pick(dense_launch(*args, targets=T,
                                                  order=order, **kw)),
        None if not eval_tiles.has_parent(plib, "window_eval")
        else lambda: pick(eval_tiles.parent_dense(plib, *args, **kw)),
        want, (1, 2, 4), t, win + far, b_ms,
        lists.far_n.shape[0],
        lambda T: occupancy(gsz, T, R, kw["window_groups"], K),
        tiles["sass"].get(f"dense R={R} T={t}"),
        tiles["sass_old"].get(f"dense R={R} (previous, "
                              f"<={256 if gsz <= 256 else 1024} threads)"),
        order=heavy_first(lists.far_n, near, gsz),
        quad_pairs=far if quad else 0)


def report_tiles(label, launch, previous, want, ts, chosen, pairs, b_ms,
                 ng, occ, sass_new, sass_old, order=None, quad_pairs=0,
                 sass_of=None, regs_of=None, chosen_order=True,
                 key=lambda T: f"T={T}", floor_ms=None, hmma_of=None):
    """The redesigned kernel at every instance T in ``ts`` (``launch(T,
    order)``; ``chosen`` is the table's, heavy-first when
    ``chosen_order``; ``key(T)`` its name), in group order and, with
    ``order``, heavy groups first (equal bit for bit), each held to the
    plain version's ``want`` (None: held in another phase), with its share
    of the bound ``b_ms``; the table's instance beside the fastest; the
    previous kernel (``previous()``, None without its sources) timed before
    and after them; resident blocks per SM and waves (``occ(T)``), SASS
    instructions a pair (``sass_new``/``sass_old``: the tool's entries or
    None) and the issue-limited time of ``pairs`` at those counts
    (``quad_pairs`` of them at the quadrupole loop's, the costliest); with
    ``sass_of(T)`` and ``regs_of(T)`` (the tool's SASS entry, and
    (registers, spill store, spill load bytes) from ptxas), every T's.
    With ``floor_ms`` (the MUFU floor of ``pairs``), also every instance's
    pairs a second, its share of that floor, HMMA a pair (``hmma_of(T)``)
    and its distance from the previous kernel.  Returns ``{instance:
    ms}``."""
    import torch
    from spatialsim_tpu_torch.tools.eval_tiles import ISSUE_RATE
    res, prev, dprev = {}, [], {}
    prev_out = None
    if previous is not None:
        prev_out = previous()
        torch.cuda.synchronize()
        prev_err = None if want is None else kernel_errors(prev_out, want)[1]
        prev.append(cuda_ms(previous, 5))
    for T in ts:
        got = launch(T, None)
        torch.cuda.synchronize()
        if want is not None:
            err = kernel_errors(got, want)[1]
            require(err <= TOL_WINDOW, f"{label} {key(T)}: {err}")
        if prev_out is not None:
            dprev[key(T)] = kernel_errors(got, prev_out)[1]
        res[key(T)] = cuda_ms(lambda: launch(T, None), 5)
        if order is not None:
            ordered = launch(T, order)
            torch.cuda.synchronize()
            require(torch.equal(ordered, got),
                    f"{label} {key(T)}: heavy-first differs")
            res[f"{key(T)} heavy-first"] = cuda_ms(lambda: launch(T, order),
                                                   5)
    table = key(chosen) + (" heavy-first" if order is not None
                           and chosen_order else "")
    print(f"    {label}: ms by instance: "
          + ", ".join(f"{k} {v:.4f} ({b_ms / v:.1%})" for k, v in res.items())
          + f" (the table: {table}); bound {b_ms:.4f} ms (share in "
            f"brackets)")
    if floor_ms is not None:
        print(f"    {label}: Gpairs/s over {pairs:.4e} pairs and share of "
              f"the MUFU floor {floor_ms:.4f} ms: "
              + ", ".join(f"{k} {pairs / v / 1e6:.1f} ({floor_ms / v:.1%})"
                          for k, v in res.items()))
        if dprev:
            print(f"    {label}: max|da|/max|a| from the previous kernel: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in dprev.items()))
    best = min(res, key=res.get)
    print(f"    {label}: the table's {table} {res[table]:.4f} ms, the fastest "
          f"{best} {res[best]:.4f} ms: {res[table] / res[best] - 1:+.2%}")
    if previous is not None:
        prev.append(cuda_ms(previous, 5))
        err = "" if prev_err is None else f" (max|da|/max|a| {prev_err:.3e})"
        print(f"    {label}: previous kernel (one thread a target) "
              f"{prev[0]:.4f} and {prev[1]:.4f} ms, before and after{err}; "
              f"the table's takes {2 * res[table] / sum(prev):.3f}x its time")
    else:
        print(f"    {label}: previous kernel not measured (no sources in "
              f"spatialsim_tpu_torch/_build/parent/)")
    for who, rec in (("new", sass_new), ("previous", sass_old)):
        if rec is not None:
            quad = max(n / r for n, r in rec[1])
            instr = rec[0] * (pairs - quad_pairs) + quad * quad_pairs
            kind = (f", {quad:.3f} a quadrupole pair" if quad_pairs
                    else "")
            print(f"    {label}: SASS ({who}) {rec[0]:.3f} instructions a "
                  f"pair{kind} (loops {rec[1]}); issue-limited "
                  f"{instr / ISSUE_RATE * 1e3:.4f} ms for {pairs:.4e} pairs")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for T in ts:
        blocks, regs, threads = occ(T)
        extra = ""
        rec = None if sass_of is None else sass_of(T)
        if rec is not None:
            extra += (f"; SASS {rec[0]:.3f} instructions a pair, "
                      f"issue-limited {rec[0] * pairs / ISSUE_RATE * 1e3:.4f}"
                      f" ms")
        if hmma_of is not None and hmma_of(T):
            extra += f", {hmma_of(T):.3f} HMMA a pair"
        if regs_of is not None and regs_of(T) is not None:
            extra += ("; ptxas {} registers, spills {} B stored, {} B "
                      "loaded").format(*regs_of(T))
        print(f"    {label}: {key(T)}: {threads} threads a block, {regs} "
              f"registers a thread, {blocks} blocks per SM resident, "
              f"{ng / (blocks * sms):.2f} waves over {ng} groups on {sms} "
              f"SMs{extra}")
    return res


def traversal_estimate(entries, diag, octree_cells):
    """Phase 19's estimate of a per-group traversal kernel at 1M from the
    card-wide probes on the octree's cells (204,800 x 1): fetch, the
    chained row read (5a) a worklist slot; decode, the chained extract8
    visit (5h) a slot, each variant; emission, the row write (5d) a
    far-list entry, an upper bound (512 B rows where the cell-id finish
    writes 4 B ids).  Each line at the probe's ns an op and less its call
    over no reads; then their sums, one a decode variant.  Beside the
    fetch and outside the sums, the chained scalar load (5f) a slot: one
    4 B attribute a slot where the fetch reads a 512 B row; beside the
    emission, the row store (6c) a far-list entry: a 512 B store with no
    read; and the iteration core (6d, one run a step, where decisions
    fire) a slot: the opening decision with its own two-row read."""
    from spatialsim_tpu_torch.tools.decide15 import CARD_SLICES
    slots = sum(diag["wl_sizes"])
    far = diag["far_n_mean"] * diag["ng"]
    rows = -(-octree_cells // 16)

    def card(key, label):
        (e,) = [e for e in entries if e["key"] == key
                and e["label"].startswith(label)]
        net = (e["ms"] - e["no_reads_ms"]) * 1e6 / e["count"]
        return e, net

    def line(name, e, net, n, unit, what, note):
        print(f"    traversal {name} estimate: {e['ns']:.3f} ns a {unit} "
              f"({e['label']}) x {n:,.0f} {what} = "
              f"{e['ns'] * n / 1e6:.3f} ms ({note}); less the call over no "
              f"reads ({e['no_reads_ms']:.4f} ms): {net:.3f} ns a {unit}, "
              f"{net * n / 1e6:.3f} ms")
        return e["ns"] * n / 1e6, net * n / 1e6
    build = "of a 1M build"
    fetch = line("fetch", *card(
        "row_reads_card",
        f"row-read w1 {octree_cells} cells 204800x1 chained"), slots,
        "read", f"worklist slots {build}", "512 B rows")
    # Beside the fetch, outside the sums: a traversal reads at least four
    # attributes a slot (centre and size), not one.
    line("4 B fetch", *card(
        "scalar_load_dynsub_card",
        f"scalar load (dyn sub, static lane) {octree_cells} cells 204800x1 "
        "chained"), slots, "read", f"worklist slots {build}",
        "one 4 B attribute a slot, beside the 512 B-row fetch; not in the "
        "sums")
    emit = line("emission", *card(
        "row_write_card", f"row-write {octree_cells} cells 204800x1"), far,
        "write", f"far-list entries {build} (far_n_mean "
        f"{diag['far_n_mean']:.1f} x {diag['ng']:,} groups)",
        "an upper bound: 512 B rows, where the cell-id finish writes 4 B "
        "ids")
    # Beside the emission and the fetch, outside the sums.
    line("store-only emission", *card(
        "row_store_card", f"row-store {octree_cells} cells 204800x1"), far,
        "store", f"far-list entries {build}",
        "512 B row stores with no read, beside the read-and-write emission "
        "line; not in the sums")
    line("opening decision", *card(
        "iteration_core_card",
        f"iter-core k1 at 2^18 x 1e-6 card P={CARD_SLICES}/"), slots,
        "run", f"worklist slots {build}",
        "the opening test and decision word with its own two-row read, "
        "8,192-row table; not in the sums")
    for variant in ("roll", "onehot"):
        decode = line(f"decode ({variant})", *card(
            "extract8_card",
            f"extract8 ({variant}) {rows} rows 204800x1 chained"), slots,
            "visit", f"worklist slots {build}", "8 floats of a packed cell")
        print(f"    traversal estimate, fetch + decode ({variant}) + "
              f"emission: {fetch[0] + decode[0] + emit[0]:.3f} ms; less "
              f"the calls over no reads: "
              f"{fetch[1] + decode[1] + emit[1]:.3f} ms")


def check_probes(entries, probes):
    """Each probe of phase 19 against its plain version on the same inputs,
    bit for bit: the plain versions keep the probes' order of float32 adds
    and int32 steps (the card-wide instances' plain versions their slices'
    order).  Those of the serial chains run on the host CPU; plain ms is
    one call on a host clock.  A probe that returns ``(out, scr)`` is held
    to it on both, the whole scratch table included.  A card-wide instance
    is also held to a second call of itself, bit for bit.  An output of
    zeros passes only where the entry expects it (the probe's own inputs
    give 0).  ``probes`` keeps, per kernel and instance (the entry's
    ``key``), the worst error and the first entry's times and bound."""
    import torch
    def tup(x):
        return x if isinstance(x, tuple) else (x,)
    for e in entries:
        got = e["call"]()
        if e["grid"]:
            again = e["call"]()
            require(all(torch.equal(a.cpu(), g.cpu())
                        for a, g in zip(tup(again), tup(got), strict=True)),
                    (e["label"], "two calls differ"))
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = e["plain"]()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        got = [g.cpu() for g in tup(got)]
        want = [w.cpu() for w in tup(want)]
        require([(g.shape, g.dtype) for g in got]
                == [(w.shape, w.dtype) for w in want],
                (e["label"], [g.shape for g in got],
                 [w.shape for w in want]))
        abs_err = max(float((g.double() - w.double()).abs().max())
                      for g, w in zip(got, want))
        # A library call held to the plain version's bits (the row
        # store's index_put_) stands only where it gives them.
        exact = not e["library_exact"] or (e["library"] and torch.equal(
            e["library"]().cpu(), want[-1]))
        library_ms = (cuda_ms(e["library"], 3) if e["library"] and exact
                      else None)
        b_ms, b_by = bound(e["ops"], e["nbytes"])
        lib = ("; library call: none, it differs from the plain version"
               if not exact else "" if library_ms is None
               else f"; library call {library_ms:.4f} ms")
        table = "".join(f"; table {tuple(g.shape)}: "
                        f"{int((g != 0).any(1).sum())} rows written"
                        for g in got[1:])
        floor = e.get("floor_ms")
        card = ("" if not e["grid"] else
                f" ({b_ms / e['ms']:.3%} of it; launch floor "
                + ("not measured" if floor is None else f"{floor:.4f} ms")
                + "; two calls equal)")
        print(f"    {e['label']}: out {float(got[0].double().ravel()[0]):.9g}"
              f"{table}, max|d| {abs_err:.3e} (limit 0); kernel "
              f"{e['ms']:.4f} ms ({e['ns']:.2f} ns/{e['unit']}); bound "
              f"{b_ms:.6f} ms ({b_by}){card}; plain {plain_ms:.3f} ms{lib}")
        require(all(torch.equal(g, w) and bool(torch.isfinite(
            g.double()).all()) for g, w in zip(got, want)),
            (e["label"], abs_err))
        zero = not any(bool(g.any()) for g in got)
        require(zero == e["expect_zero"],
                (e["label"], "zero output" if zero else "nonzero output",
                 "expected", e["expect_zero"]))
        rec = probes.setdefault(e["key"], dict(
            max_abs_err=0.0, ms=e["ms"], plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms, label=e["label"]))
        rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)


def device_ms(fn, reps):
    """Milliseconds a call of ``fn`` spends in device kernels, from
    ``torch.profiler`` over ``reps`` calls after one warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def enqueue_us(fn, calls):
    """Host microseconds a call of ``fn`` takes to return, over ``calls``
    back-to-back calls after a warm-up and a synchronise (the enqueue: no
    call synchronises)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def per_call_ns(fn, calls):
    """Host nanoseconds a call of ``fn`` over ``calls`` calls
    (``time.perf_counter_ns``), after a warm-up; synchronises after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    ns = (time.perf_counter_ns() - t) / calls
    torch.cuda.synchronize()
    return ns


class PreviousRollPath:
    """The roll probe's wrapper (5e) as it launched before the launch path's
    redesign, reproduced for phase 19's comparison, piece by piece: the
    device test and the checks through their former helpers, the library
    through a ``library()`` call, the stream through a ``torch.cuda.Stream``
    object, a ``ctypes.CDLL`` call (which lets go of the GIL) and a
    ``check`` call.  It launches the same kernel of the same library, and
    counts nothing (it is not a wrapper of the port)."""

    def __init__(self):
        import ctypes
        from spatialsim_tpu_torch import _kernels
        self._kernels = _kernels
        self.lib = _kernels.bind(ctypes.CDLL(_kernels.build_info["path"]))

    @staticmethod
    def on_card(fn_name, *tensors):
        dev = tensors[0].device
        if any(t.device != dev for t in tensors) or dev.type not in (
                "cpu", "cuda"):
            raise ValueError(f"{fn_name}: unsupported devices")
        return dev.type == "cuda"

    @staticmethod
    def check(name, t, dtype, shape=None):
        if t.dtype != dtype or (shape is not None
                                and tuple(t.shape) != tuple(shape)):
            raise ValueError(f"{name}: expected {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    def library(self):
        return self.lib

    @staticmethod
    def stream_ptr(device):
        import torch
        return torch.cuda.current_stream(device).cuda_stream

    def lib_stream(self, t):
        return self.library(), self.stream_ptr(t.device)

    def __call__(self, x, shift):
        import torch
        if not self.on_card("roll", x):
            raise ValueError("the previous path is timed on the card only")
        self.check("roll: x", x, torch.float32, (1, 128))
        out = torch.empty_like(x)
        lib, st = self.lib_stream(x)
        self._kernels.check(lib.spatialsim_probe_roll(
            x.data_ptr(), int(shift), out.data_ptr(), st), "probe_roll")
        return out


def launch_split(x, calls):
    """Host nanoseconds a call of each piece of the roll probe's launch
    path, previous and new, and of the whole calls, over ``calls`` calls
    each (``time.perf_counter_ns``).  A piece's time is less the loop's
    empty call; the whole calls are as measured.  Returns ``{piece: ns}``."""
    import ctypes
    import torch
    from spatialsim_tpu_torch import _kernels
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    prev = PreviousRollPath()
    out = torch.empty_like(x)
    xp, op = x.data_ptr(), out.data_ptr()
    st = _kernels.stream(x)
    old_fn, new_fn = prev.lib.spatialsim_probe_roll, (
        _kernels.entry.spatialsim_probe_roll)
    f32, shape = torch.float32, (1, tp.ROW)
    occ_fn = _kernels.entry.spatialsim_allpairs_occupancy
    pylib = _kernels.bind(ctypes.PyDLL(_kernels.build_info["path"]))
    py_occ = pylib.spatialsim_allpairs_occupancy
    raw_occ = pylib["spatialsim_allpairs_occupancy"]

    def new_entry():
        return _kernels.entry.spatialsim_probe_roll
    pieces = {
        "previous: _on_card": lambda: prev.on_card("roll", x),
        "previous: _check": lambda: prev.check("roll: x", x, f32, shape),
        "torch.empty_like": lambda: torch.empty_like(x),
        "previous: _kernels.library()": prev.library,
        "previous: stream_ptr (torch.cuda.current_stream(dev)"
        ".cuda_stream)": lambda: prev.stream_ptr(x.device),
        "x.data_ptr()": x.data_ptr,
        "previous: ctypes.CDLL call (the launch)":
            lambda: old_fn(xp, 5, op, st),
        "previous: _kernels.check": lambda: _kernels.check(0, "probe_roll"),
        "new: x.is_cuda (the device test)": lambda: x.is_cuda,
        "new: the inline checks": lambda: (
            x.dtype is not f32 or x.shape != shape
            or not x.is_contiguous()),
        "new: _on_card and _check (the other probes' helpers)": lambda: (
            tp._on_card("roll", x), tp._check("roll: x", x, f32, shape)),
        "new: _kernels.entry.<name>": new_entry,
        "new: _kernels.stream(x) (raw stream)": lambda: _kernels.stream(x),
        "new: the binding's call (METH_FASTCALL; the launch)":
            lambda: new_fn(xp, 5, op, st),
        # What a call costs without its launch: an entry point of the same
        # arity that returns at once (no instance T=0), through the binding,
        # through ctypes with argument types, previous (CDLL) and with the
        # GIL kept (PyDLL), and through ctypes without them (small ints
        # only: a pointer would be cut to 32 bits).
        "new: the binding's call, 4 arguments, no launch":
            lambda: occ_fn(0, 0, 0, None),
        "ctypes.CDLL call, 4 arguments, no launch":
            lambda: prev.lib.spatialsim_allpairs_occupancy(0, 0, 0, None),
        "ctypes.PyDLL call, 4 arguments, no launch":
            lambda: py_occ(0, 0, 0, None),
        "ctypes.PyDLL call, 4 ints without argument types, no launch":
            lambda: raw_occ(0, 0, 0, 0),
        "torch.empty(shape, device=x.device)":
            lambda: torch.empty(shape, device=x.device),
        "x.new_empty(shape)": lambda: x.new_empty(shape),
    }
    empty = per_call_ns(lambda: None, calls)
    res = {k: per_call_ns(fn, calls) - empty for k, fn in pieces.items()}
    for name, fn in (("whole previous path", lambda: prev(x, 5)),
                     ("whole new path (tp.roll)", lambda: tp.roll(x, 5)),
                     ("torch.roll", lambda: torch.roll(x, 5, 1))):
        res[name] = per_call_ns(fn, calls)
    res["empty call"] = empty
    return res


def indented(line, **kw):
    """``print`` for a tool's report lines inside a phase."""
    print("    " + line, **kw)


def timed_steps(step, steps, dt):
    """Host seconds of each of ``steps`` calls of ``step(dt)``, each ended
    by a device synchronise."""
    import torch
    out = []
    for _ in range(steps):
        t = time.perf_counter()
        step(dt)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def report_steps(label, step_s):
    """Print steps/s over the run, the median step and the rebuild step
    (the slowest); returns the median step's milliseconds."""
    total = sum(step_s)
    plain = sorted(step_s)[len(step_s) // 2]
    rebuild = max(step_s)
    print(f"    {label}: {len(step_s)} steps in {total:.3f} s = "
          f"{len(step_s) / total:.3f} steps/s (rebuild included); median "
          f"step {plain * 1e3:.3f} ms; rebuild step {rebuild * 1e3:.3f} ms "
          f"(step {step_s.index(rebuild) + 1})")
    return plain * 1e3


def require_mass_conserved(st, config, label):
    """Every group's window mass, plus its near groups' mass (when the
    lists carry a near table), plus its far entries' mass (row 6, up to
    far_n) equals the total mass within 1e-4 relative: each body lies in
    exactly one of window, near group, entry, sliver or residual."""
    import torch
    lists = st.lists
    gsz, wg = config.group_size, config.window_groups
    ng, L = lists.far_n.shape[0], lists.far.shape[2]
    n = st.mass.shape[0]
    gm = torch.zeros(ng * gsz, dtype=torch.float64, device=st.mass.device)
    gm[:n] = st.mass.double()
    gm = gm.reshape(ng, gsz).sum(1)
    c = torch.cat([gm.new_zeros(1), gm.cumsum(0)])
    g = torch.arange(ng, device=gm.device)
    window = (c[torch.clamp(g + wg, max=ng - 1) + 1]
              - c[torch.clamp(g - wg, min=0)])
    if lists.near is not None:
        nb = lists.near.long()
        window = window + torch.where((nb >= 0) & (nb < ng),
                                      gm[nb.clamp(0, ng - 1)], 0.0).sum(1)
    live = (torch.arange(L, device=gm.device)[None, :]
            < lists.far_n.long()[:, None])
    far_m = torch.where(live, lists.far[:, 6], 0.0)
    far = far_m.sum(1, dtype=torch.float64)
    total = float(gm.sum())
    rel = float(((window + far) - total).abs().max()) / total
    # Residual entries are the live slots without a body range.
    res = torch.where(lists.far_range[:, 1] <= lists.far_range[:, 0],
                      far_m, 0.0).amax(1)
    print(f"    mass conservation ({label}): max over {ng} groups of "
          f"|window + far - total| / total = {rel:.3e} (limit 1e-4); the "
          f"heaviest residual holds {float(res.max()) / total:.4f} of the "
          f"total mass, {int((res > 2 ** 24).sum())} residuals exceed "
          f"2^24")
    require(rel <= 1e-4, f"{label}: per-group mass off by {rel}")


def force_errors(approx, exact):
    """(rms, median) of the per-body relative error |da_i| / |a_i| -- the
    statistic of the JAX package's accuracy table -- and the ratio
    rms|da| / rms|a| over the sample."""
    exact = exact.double()
    err = (approx.double() - exact).norm(dim=0)
    mag = exact.norm(dim=0)
    rel = err / mag.clamp(min=1e-12)
    return (float(rel.pow(2).mean().sqrt()), float(rel.median()),
            float(err.pow(2).mean().sqrt() / mag.pow(2).mean().sqrt()))


def check_capture(sim, max_speed, label):
    """The capture's kernels on ``sim``'s window state (``csrc/capture.cu``)
    against their plain versions, bit for bit: ``capture_original`` of pos
    and vel against the plain gather, ``capture_colors`` on its velocity
    rows against the plain colours of the plain gather; each kernel's
    milliseconds by CUDA events."""
    import torch
    from spatialsim_tpu_torch.ops.capture import (capture_colors,
                                                  capture_original,
                                                  original_order_reference)
    from spatialsim_tpu_torch.ops.colors import colors_by_velocity_reference
    st = sim.state
    inv = st.lists.inv_order
    rows = capture_original(inv, st.pos, st.vel)
    want = original_order_reference(inv, st.pos, st.vel)
    col = capture_colors(rows[1], max_speed)
    want_c = colors_by_velocity_reference(want[1], max_speed)
    torch.cuda.synchronize()
    same = [torch.equal(g.contiguous().view(torch.int32),
                        w.view(torch.int32)) for g, w in zip(rows, want)]
    same_c = torch.equal(col.contiguous().view(torch.int32),
                         want_c.view(torch.int32))
    o_ms = cuda_ms(lambda: capture_original(inv, st.pos, st.vel), 5)
    c_ms = cuda_ms(lambda: capture_colors(rows[1], max_speed), 5)
    print(f"    {label} capture kernels against their plain versions, bit "
          f"for bit: positions {same[0]}, velocities {same[1]}, colours "
          f"{same_c}; capture_original {o_ms:.4f} ms, capture_colors "
          f"{c_ms:.4f} ms (CUDA events, mean of 5, warm L2)")
    require(all(same) and same_c, (label, same, same_c))
    del rows, want, col, want_c
    torch.cuda.empty_cache()


def original_order(st):
    """A window state's (pos, vel, mass) in original body order."""
    inv = st.lists.inv_order.long()
    return st.pos[:, inv], st.vel[:, inv], st.mass[inv]


def run_recorder(args, rec_root):
    """Run the port's recorder CLI on the card; returns its median frame
    milliseconds."""
    env = dict(os.environ, SPATIALSIM_RECORDINGS=str(rec_root),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    cmd = [sys.executable, "-m", "spatialsim_tpu_torch.tools.record",
           *args, "--device", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True)
    secs = time.perf_counter() - t0
    kept_raw, frame_ms = 0, None
    for line in proc.stdout.splitlines():
        if line.startswith("[Compress] frame"):
            kept_raw += "keeping staged npz" in line
        elif line.startswith(("[Record]", "[Compress]")):
            print("    " + line.strip())
        if line.startswith("[Record] Frame time: median "):
            frame_ms = float(line.split()[4])
    if kept_raw:
        print(f"    {kept_raw} frames kept as staged .npz (the compressor "
              f"could not pack them; the codec reads both forms)")
    if proc.returncode != 0:
        raise RuntimeError(f"recorder failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    print(f"    recorder wall seconds: {secs:.3f}")
    require(frame_ms is not None, "the recorder printed no frame time")
    return frame_ms


def sync_warnings(fn):
    """The first line of each warning ``torch.cuda.set_sync_debug_mode
    ("warn")`` raises while ``fn()`` runs: the host waits on the device."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message).splitlines()[0] for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def check_frame(rec_dir, frame, n):
    import numpy as np
    from spatialsim_tpu_torch.io import codec
    p, c = codec.load_frame(rec_dir, frame)
    require(p.shape == (n, 3) and c.shape == (n, 3), (p.shape, c.shape))
    require(np.isfinite(p).all(), "non-finite positions in recorded frame")
    require((c >= -1e-3).all() and (c <= 1 + 1e-3).all(),
            (float(c.min()), float(c.max())))
    print(f"    decoded frame {frame} of {rec_dir.name}: {p.shape} finite, "
          f"colours in [{c.min():.4f}, {c.max():.4f}]")


def play_back(rec_root, name, frames):
    """The port's headless playback of a recorded session (its module
    entry: every frame decoded, the mean motion a frame), then one image of
    the last frame from the software renderer (numpy only)."""
    import numpy as np
    from spatialsim_tpu_torch.io import codec, session
    from spatialsim_tpu_torch.render import ExportCamera, render_points
    env = dict(os.environ, SPATIALSIM_RECORDINGS=str(rec_root),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "spatialsim_tpu_torch.tools.playback", name,
         "--headless"], cwd=ROOT, env=env, capture_output=True, text=True)
    secs = time.perf_counter() - t
    require(proc.returncode == 0,
            f"playback failed ({proc.returncode}):\n"
            f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    line = [x for x in proc.stdout.splitlines() if " decoded " in x]
    require(line and f"decoded {frames} frames" in line[-1], proc.stdout)
    motion = float(line[-1].rsplit(" ", 1)[1])
    require(np.isfinite(motion) and motion > 0, f"motion {motion}")
    pos, col = codec.load_frame(rec_root / name, frames - 1)
    meta = session.load_metadata(rec_root / name)
    cam = ExportCamera(radius=meta.get("spawn_radius", 500.0) * 1.6,
                       mode="orbit", rotation_speed=0.5)
    cam.update(frames - 1, frames)
    img = render_points(pos, col, cam.get_position(), up=cam.get_up(),
                        width=640, height=360, point_size=2)
    lit = float((img.max(axis=2) > 20).mean())
    require(img.shape == (360, 640, 3) and lit > 0, (img.shape, lit))
    print(f"    playback of {name}: {line[-1].strip()} (wall {secs:.3f} s "
          f"with the interpreter's start); render_points of frame "
          f"{frames - 1}: {img.shape}, {lit:.4f} of the pixels lit")


N_SHARD = 1_048_576    # the 1M galaxy rounded to a multiple of D * 256
N_BOIDS_SHARD = 500_224   # 500K rounded up to a multiple of the group, 256
BOIDS_CMP_STEPS = 13   # across the re-sorts before steps 7 and 13
SHARD_DS = (2, 4, 8)   # shard counts of phase 20 (a)
N_RING = 32_768
SHARD_CMP_STEPS = 4    # sharded vs unsharded, across a rebuild at step 3


def mode_inputs(s_pos, s_mass, lists, D, r, mode, wg, gsz):
    """Rank r of D's eval inputs in ``mode``: the haloed source sliced as
    the sharded step slices it (``parallel/sharded.py``), or the whole
    sorted state with the rank's group range; the rank's far lists."""
    import torch
    ng = lists.far_n.shape[0]
    ngl, halo = ng // D, wg * gsz
    g = slice(r * ngl, (r + 1) * ngl)
    far, far_n = lists.far[g].contiguous(), lists.far_n[g].contiguous()
    if mode == "haloed":
        pm = torch.nn.functional.pad(torch.cat([s_pos, s_mass[None]]),
                                     (halo, halo))
        src = pm[:, r * ngl * gsz:(r + 1) * ngl * gsz + 2 * halo]
        return ((src[:3].contiguous(), src[3].contiguous(), far, far_n),
                dict(haloed=True))
    return (s_pos, s_mass, far, far_n), dict(local_slice=(r * ngl, ngl))


def residual_groups(lists):
    """Groups whose lists hold a residual (a live slot without a body
    range): the groups that folded entries."""
    import torch
    L = lists.far.shape[2]
    live = (torch.arange(L, device=lists.far.device)[None, :]
            < lists.far_n.long()[:, None])
    rangeless = lists.far_range[:, 1] <= lists.far_range[:, 0]
    return (live & rangeless & (lists.far[:, 6] > 0)).any(1)


def sharded_paths(dev, kernels):
    """Phase 20: kernel 3's modes against the unsharded kernel and the
    plain versions (a), the sorted build's shards (b), the sharded window
    step through NCCL at world size 1 against the unsharded step (c),
    make_sharded_step's ring and Barnes-Hut (d), and the sharded boids step
    (e, :func:`sharded_boids`).  Returns kernel 3's launches in (c)'s timed
    run and kernel 4's in (e)'s, the sharded main paths, the ring's
    launches of kernel 1's targets-and-sources mode in (d), counted from
    zero, and that mode's launches before them (the oracle's in the
    accuracy checks)."""
    import numpy as np
    import torch
    from spatialsim_tpu_torch.config.nbody import NBODY, resolve_config
    from spatialsim_tpu_torch.models.nbody import NBodyState, make_step_fn
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    from spatialsim_tpu_torch.ops import bh_window as bw
    from spatialsim_tpu_torch.ops.allpairs import (allpairs_accel,
                                                   allpairs_accel_at)
    from spatialsim_tpu_torch.ops.barnes_hut import barnes_hut_accel
    from spatialsim_tpu_torch.parallel import (
        make_mesh, make_sharded_step, make_sharded_window_step,
        ring_allpairs_accel, shard_state, sharded_barnes_hut_accel)
    from spatialsim_tpu_torch.parallel.collectives import pmax

    n = N_SHARD
    pos, vel, mass = galaxy(n, 0, dev)
    t = time.perf_counter()
    cfg = bw.calibrate_config(resolve_config(
        NBODY.replace(num_bodies=n, pool_tile=0, near_groups=0), n),
        pos, vel, mass)
    torch.cuda.synchronize()
    print(f"    calibrate_config at {n:,} bodies, pool_tile=0: "
          f"{time.perf_counter() - t:.3f} s; tree_caps={cfg.tree_caps} "
          f"wl_caps={cfg.wl_caps}")
    gsz, wg = cfg.group_size, cfg.window_groups
    ekw = bw._eval_kw(cfg)
    st = bw.init_window_state(pos, vel, mass, cfg)
    lists = st.lists
    s_pos, s_mass = st.pos.contiguous(), st.mass.contiguous()
    ng = lists.far_n.shape[0]
    print(f"    dense lists: far {tuple(lists.far.shape)}, far_n mean "
          f"{float(lists.far_n.float().mean()):.1f}, {ng} groups of {gsz}, "
          f"window_groups {wg}")

    # (a) the modes against the unsharded kernel and the plain versions.
    forms = {"row": ({}, ek.window_eval_reference),
             "cols": (dict(use_cols=True), ek.window_eval_cols_reference),
             "mxu": (dict(use_mxu=True), ek.window_eval_mxu_reference)}
    for form, (fkw, plain) in forms.items():
        kw = dict(ekw, **fkw)
        pkw = dict(ekw)
        if form != "row":
            kw["far_tile"] = pkw["far_tile"] = cfg.eval_far_tile
        args = (lists.far, lists.far_n, None, 23, DT)
        full = ek.window_eval(s_pos, s_mass, *args, **kw)
        full_ms = cuda_ms(lambda: ek.window_eval(s_pos, s_mass, *args,
                                                 **kw), 5)
        amax = float(full.abs().max())
        for D in SHARD_DS:
            for mode in ("haloed", "local_slice"):
                outs, ms, worst = [], [], 0.0
                for r in range(D):
                    a4, mkw = mode_inputs(s_pos, s_mass, lists, D, r, mode,
                                          wg, gsz)
                    margs = a4 + (None, 23, DT)
                    got = ek.window_eval(*margs, **mkw, **kw)
                    want = plain(*margs, **mkw, **pkw)
                    torch.cuda.synchronize()
                    worst = max(worst, kernel_errors(got, want)[1])
                    ms.append(cuda_ms(lambda: ek.window_eval(
                        *margs, **mkw, **kw), 3))
                    outs.append(got)
                cat = torch.cat(outs, 1)
                diff = float((cat - full).abs().max())
                equal = bool(torch.equal(cat, full))
                print(f"    (a) {form} D={D} {mode}: shards within "
                      f"{worst:.3e} of max|a| of the plain version (tol "
                      f"{TOL_WINDOW}); concatenation equal bit for bit to "
                      f"the unsharded kernel: {equal} (max|d| {diff:.3e}, "
                      f"{diff / amax:.3e} of max|a|); ms a shard "
                      + ", ".join(f"{m:.4f}" for m in ms)
                      + f", summed {sum(ms):.4f}, unsharded launch "
                        f"{full_ms:.4f}")
                require(worst <= TOL_WINDOW, (form, D, mode, worst))
                require(diff <= TOL_WINDOW * amax, (form, D, mode, diff))
        del full, outs, cat, got, want

    # (b) the sorted build's shards, D = 4.
    D = 4
    ngl = ng // D
    bkw = bw._build_kw(cfg)
    s_vel = st.vel.contiguous()
    s_acc = torch.zeros_like(s_pos)
    order = torch.arange(n, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    whole = bw.build_lists_sorted(s_pos, s_vel, s_mass, s_acc, order=order,
                                  **bkw)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t
    whole_acc = ek.window_eval(s_pos, s_mass, whole.far, whole.far_n, None,
                               0, DT, **ekw)
    folds_whole = residual_groups(whole)
    amax = float(whole_acc.abs().max())
    for r in range(D):
        torch.cuda.synchronize()
        t = time.perf_counter()
        part = bw.build_lists_sorted(s_pos, s_vel, s_mass, s_acc,
                                     order=order, group_offset=r * ngl,
                                     n_groups=ngl, **bkw)
        torch.cuda.synchronize()
        part_s = time.perf_counter() - t
        g = slice(r * ngl, (r + 1) * ngl)
        fold = residual_groups(part) | folds_whole[g]
        same = part.far_n == whole.far_n[g]
        a4, mkw = mode_inputs(s_pos, s_mass, whole, D, r, "haloed", wg, gsz)
        got = ek.window_eval(a4[0], a4[1], part.far, part.far_n, None, 0,
                             DT, **mkw, **ekw)
        torch.cuda.synchronize()
        err = float((got - whole_acc[:, g.start * gsz:g.stop * gsz]).abs()
                    .max()) / amax
        print(f"    (b) shard {r} of {D}: far_n equal in "
              f"{int(same.sum())} of {ngl} groups; folds: the shard's "
              f"build {int(residual_groups(part).sum())}, the full build's "
              f"slice {int(folds_whole[g].sum())}; far_n mean "
              f"{float(part.far_n.float().mean()):.1f} against "
              f"{float(whole.far_n[g].float().mean()):.1f}; eval of its "
              f"lists within {err:.3e} of max|a| of the full build's; "
              f"build {part_s * 1e3:.3f} ms (the full build "
              f"{whole_s * 1e3:.3f} ms)")
        require(bool(same[~fold].all()), f"shard {r}: far_n differs where "
                                         f"neither build folds")
        require(err <= TOL_WINDOW, f"shard {r}: eval of its lists {err}")
    del whole, whole_acc, part, st, lists

    # (c) the window step through the process group at world size 1.
    mesh = make_mesh()
    print(f"    (c) mesh: {torch.distributed.get_backend()} world size "
          f"{mesh.size}, rank {mesh.rank}, {mesh.device}")
    cmp_cfg = cfg.replace(rebuild_interval=2)
    ucfg = cmp_cfg.replace(pool_tile=0)
    ustep = bw.make_window_step(ucfg, n)
    ust = bw.init_window_state(pos, vel, mass, ucfg)
    results = {}
    for label, cap in (("sample sort", 2.0), ("replicated fallback", 1e-9)):
        sstep, sinit = make_sharded_window_step(cmp_cfg, n, mesh,
                                                cap_factor=cap)
        sst = sinit(pos, vel, mass)
        for _ in range(SHARD_CMP_STEPS):
            sst = sstep(sst, DT)
        results[label] = (sst, sstep)
    for _ in range(SHARD_CMP_STEPS):
        ust = ustep(ust, DT)
    torch.cuda.synchronize()
    for label, (sst, sstep) in results.items():
        dp = float((sst.pos - ust.pos).abs().max())
        dv = float((sst.vel - ust.vel).abs().max())
        same = (bool(torch.equal(sst.pos, ust.pos))
                and bool(torch.equal(sst.vel, ust.vel)))
        print(f"    (c) {label}: {SHARD_CMP_STEPS} steps (rebuilds "
              f"{sstep.rebuilds}, fallbacks {sstep.fallbacks}) against the "
              f"unsharded dense step (rebuilds {ustep.rebuilds}): max|dpos| "
              f"{dp:.3e}, max|dvel| {dv:.3e}; pos and vel equal bit for bit: "
              f"{same}")
        require(sstep.rebuilds == ustep.rebuilds == 1, label)
        require(sstep.fallbacks == int(label != "sample sort"), label)
        for a, b in ((sst.pos, ust.pos), (sst.vel, ust.vel)):
            require(bool(torch.allclose(a, b, rtol=2e-4, atol=2e-4)),
                    f"{label}: sharded vs unsharded")
    del results, sst, ust
    # 48 steps at the calibrated interval: the sharded main path.
    torch.cuda.synchronize()
    launches0 = ek.window_eval.launches
    ek.window_eval.launches = 0
    sstep, sinit = make_sharded_window_step(cfg, n, mesh)
    sst = sinit(pos, vel, mass)
    step_s = []
    for _ in range(STEPS):
        t = time.perf_counter()
        sst = sstep(sst, DT)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    sharded_launches = ek.window_eval.launches
    ek.window_eval.launches = launches0
    print(f"    (c) sharded window step: launches of kernel 3 "
          f"{sharded_launches} in {STEPS} steps, rebuilds {sstep.rebuilds}, "
          f"fallbacks {sstep.fallbacks}")
    require(sharded_launches == STEPS and sstep.rebuilds == 1,
            (sharded_launches, sstep.rebuilds))
    require(bool(torch.isfinite(sst.pos).all())
            and sst.pos.shape == (3, n), "sharded state")
    sharded_ms = report_steps("sharded window step, world size 1", step_s)
    ust = bw.init_window_state(pos, vel, mass, cfg)
    ustep = bw.make_window_step(cfg, n)
    ust_s = []
    for _ in range(STEPS):
        t = time.perf_counter()
        ust = ustep(ust, DT)
        torch.cuda.synchronize()
        ust_s.append(time.perf_counter() - t)
    dense_ms = report_steps("unsharded dense window step", ust_s)
    print(f"    (c) median step sharded / unsharded dense: "
          f"{sharded_ms / dense_ms:.4f}")
    # Where a plain step's time goes: 20 steps from a fresh state (the
    # first rebuild comes at step 25), each engine under the profiler.
    engines = {
        "sharded window step": make_sharded_window_step(cfg, n, mesh),
        "unsharded dense window step": (
            bw.make_window_step(cfg, n),
            functools.partial(bw.init_window_state, config=cfg)),
    }
    for label, (stepper, init) in engines.items():
        box = [init(pos, vel, mass)]

        def one():
            box[0] = stepper(box[0], DT)
        profile_steps(f"{label}, 20 steps between rebuilds", one, 20)
    del engines, box
    drift = (sst.pos - sst.lists.ref_pos).abs().amax()
    for label, fn in (("host drift read", lambda: float(drift)),
                      ("drift pmax + host read", lambda: float(
                          pmax(drift, mesh)))):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(100):
            fn()
        print(f"    (c) {label}: {(time.perf_counter() - t) * 1e4:.2f} us "
              f"a step (100 calls)")
    del sst, ust

    # (d) make_sharded_step: the ring and sharded Barnes-Hut.
    rpos, rvel, rmass = galaxy(N_RING, 0, dev)
    # The mode's launches so far are the oracle's in the accuracy checks
    # (reference launches); the ring's are counted from zero.
    reference_at = allpairs_accel_at.launches
    allpairs_accel_at.launches = 0
    ring = ring_allpairs_accel(rpos, rmass, mesh, NBODY.G, NBODY.softening)
    ring_launches = allpairs_accel_at.launches
    allpairs_accel_at.launches = 0
    ap = allpairs_accel(rpos, rmass, NBODY.G, NBODY.softening)
    torch.cuda.synchronize()
    d = float((ring - ap).abs().max())
    print(f"    (d) ring at {N_RING:,} against the all-pairs kernel: "
          f"max|da| {d:.3e}, {d / float(ap.abs().max()):.3e} of max|a|; "
          f"its hops launched kernel 1's targets-and-sources mode "
          f"{ring_launches} times")
    require(ring_launches == mesh.size, f"ring hops {ring_launches}")
    require(bool(torch.allclose(ring, ap, rtol=2e-4, atol=2e-5)), "ring")
    rcfg = resolve_config(NBODY.replace(num_bodies=N_RING), N_RING)
    a = make_sharded_step(rcfg, N_RING, mesh, engine="allpairs")(
        shard_state(NBodyState(rpos, rvel, rmass), mesh), DT)
    b = make_step_fn(rcfg, N_RING, engine="allpairs")(
        NBodyState(rpos, rvel, rmass), DT)
    require(bool(torch.allclose(a.pos, b.pos, rtol=2e-4, atol=2e-4)),
            "ring step")
    # The octree's moments are fixed-order segment sums: the exact engine
    # equals itself bit for bit, without deterministic algorithms; then
    # sharded Barnes-Hut against it.
    require(not torch.are_deterministic_algorithms_enabled(),
            "deterministic algorithms are on")
    bcfg = NBODY.replace(num_bodies=n)
    e1, e2 = (barnes_hut_accel(pos, mass, bcfg) for _ in range(2))
    d = float((e1 - e2).abs().max())
    print(f"    (d) the exact engine at {n:,} against itself: max|da| "
          f"{d:.3e}; equal bit for bit: {bool(torch.equal(e1, e2))}")
    require(bool(torch.equal(e1, e2)), "the exact engine differs from "
                                       "itself")
    del e1, e2
    t = time.perf_counter()
    sbh = sharded_barnes_hut_accel(pos, mass, mesh, bcfg)
    torch.cuda.synchronize()
    sbh_s = time.perf_counter() - t
    t = time.perf_counter()
    ebh = barnes_hut_accel(pos, mass, bcfg)
    torch.cuda.synchronize()
    ebh_s = time.perf_counter() - t
    d = float((sbh - ebh).abs().max())
    print(f"    (d) sharded Barnes-Hut at {n:,}: {sbh_s:.3f} s against the "
          f"exact engine's {ebh_s:.3f} s; max|da| {d:.3e}, "
          f"{d / float(ebh.abs().max()):.3e} of max|a|; equal bit for bit: "
          f"{bool(torch.equal(sbh, ebh))}")
    require(bool(torch.allclose(sbh, ebh, rtol=2e-4, atol=1e-5)),
            "sharded Barnes-Hut")
    del sbh, ebh, ring, ap, a, b, pos, vel, mass
    torch.cuda.empty_cache()
    boids_launches = sharded_boids(dev, mesh, kernels)
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    return sharded_launches, boids_launches, ring_launches, reference_at


def sharded_boids(dev, mesh, kernels):
    """Phase 20 (e): the sharded boids step through NCCL at world size 1,
    at N_BOIDS_SHARD boids, the default config: kernel 4's haloed mode on
    the step's own inputs against its plain version (and against the
    unsharded kernel's rows); the first BOIDS_CMP_STEPS steps against
    Flock's window step; then BOIDS_STEPS steps timed beside Flock's, with
    kernel 4's launches counted from zero.  Returns those launches."""
    import numpy as np
    import torch
    from spatialsim_tpu_torch.config.boids import BOIDS
    from spatialsim_tpu_torch.models.boids import Flock
    from spatialsim_tpu_torch.ops.boids_window_kernel import (
        boids_window_accumulate, boids_window_reference)
    from spatialsim_tpu_torch.parallel import make_sharded_boids_step

    nb = N_BOIDS_SHARD
    cfg = BOIDS.replace(num_boids=nb)
    gsz = cfg.group_size
    flock = Flock(config=cfg, device=dev)
    inv = flock.state.inv1
    orig = [a[:, inv].contiguous() for a in (flock.state.pos,
                                             flock.state.vel,
                                             flock.state.col)]
    step, init = make_sharded_boids_step(cfg, nb, mesh)
    sst = init(*orig)
    # The haloed kernel on the step's own inputs, each pass, against its
    # plain version and the unsharded kernel on Flock's (equal) state.
    ms = plain_ms = abs_err = rel_err = nb_pairs = 0.0
    pairs = nbytes = 0
    for ps, ((args, kw), uargs) in enumerate(zip(
            step.pass_inputs(sst), boids_pass_inputs(flock.state, cfg)), 1):
        got = boids_window_accumulate(*args, **kw)
        want = boids_window_reference(*args, **kw)
        ukw = {k: v for k, v in kw.items() if k != "haloed"}
        unsharded = boids_window_accumulate(*uargs, **ukw)
        torch.cuda.synchronize()
        for r in range(0, 12, 3):
            d = float((got[r:r + 3] - want[r:r + 3]).abs().max())
            ref = float(want[r:r + 3].abs().max())
            require(d <= TOL_BOIDS * ref, f"haloed pass {ps} rows {r}: {d}")
            rel_err = max(rel_err, d / ref if ref else d)
        abs_err = max(abs_err, float((got - want).abs().max()))
        differ = float((got[12:] != want[12:]).any(0).float().mean())
        require(differ <= TOL_BOIDS_COUNTS, f"haloed pass {ps}: counts")
        k_ms = cuda_ms(lambda: boids_window_accumulate(*args, **kw), 20)
        p_ms = cuda_ms(lambda: boids_window_reference(*args, **kw), 3)
        ms, plain_ms = ms + k_ms, plain_ms + p_ms
        ng_s = args[0].shape[1] // gsz
        pairs += window_pairs(nb // gsz, gsz, kw["wg"])
        nb_pairs += float(want[13].sum())
        nbytes += 4 * (args[0].shape[1] * (9 + (ps == 2)) + 14 * nb)
        print(f"    (e) haloed pass {ps} (g0 = {kw['wg']}, {ng_s} source "
              f"groups of {gsz}): within {rel_err:.3e} of max|ref| of the "
              f"plain version (tol {TOL_BOIDS}), counts differ for "
              f"{differ:.3e} of boids; equal bit for bit to the unsharded "
              f"kernel's rows: {bool(torch.equal(got, unsharded))}; kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms")
    ops = 10.0 * pairs + 30.0 * nb_pairs
    record_kernel(kernels, "boids_window_haloed", abs_err, rel_err, ms,
                  plain_ms, ops, nbytes)
    rec = kernels["boids_window_haloed"]
    print(f"    (e) haloed, both passes: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}; {pairs:.4e} window pairs, "
          f"{nb_pairs:.4e} neighbour pairs), {rec['bound_ms'] / ms:.1%} of it")
    # Trajectories: the sharded step against Flock's window step.
    for _ in range(BOIDS_CMP_STEPS):
        sst = step(sst, BOIDS_DT)
        flock.update(BOIDS_DT)
    torch.cuda.synchronize()
    worst, same = 0.0, True
    for f in ("pos", "vel", "col"):
        a = getattr(sst, f)[:, sst.inv1]
        b = getattr(flock.state, f)[:, flock.state.inv1]
        worst = max(worst, float((a - b).abs().max()))
        same = same and bool(torch.equal(a, b))
        require(bool(torch.allclose(a, b, rtol=2e-4, atol=2e-4)),
                f"sharded boids {f} vs Flock")
    print(f"    (e) sharded boids step, {nb:,} boids, {BOIDS_CMP_STEPS} "
          f"steps (re-sorts {step.resorts}, Flock's {flock.resorts}) "
          f"against Flock's window step: max|d| {worst:.3e} (rtol/atol "
          f"2e-4); pos, vel and col equal bit for bit: {same}")
    require(step.resorts == flock.resorts == 2, (step.resorts,
                                                 flock.resorts))
    del sst, flock
    # Timed: BOIDS_STEPS steps of each, from the same state.
    torch.cuda.synchronize()
    launches0 = boids_window_accumulate.launches
    boids_window_accumulate.launches = 0
    step, init = make_sharded_boids_step(cfg, nb, mesh)
    sst = init(*orig)
    box = [sst]

    def one(dt):
        box[0] = step(box[0], dt)
    sh_s = timed_steps(one, BOIDS_STEPS, BOIDS_DT)
    launched = boids_window_accumulate.launches
    boids_window_accumulate.launches = launches0
    sst = box[0]
    require(launched == 2 * BOIDS_STEPS, f"haloed launches {launched}")
    require(all(bool(torch.isfinite(getattr(sst, f)).all())
                for f in ("pos", "vel", "col")), "sharded boids state")
    flock = Flock(config=cfg, device=dev)
    fl_s = timed_steps(flock.update, BOIDS_STEPS, BOIDS_DT)
    print(f"    (e) launches of kernel 4 (haloed) in {BOIDS_STEPS} sharded "
          f"steps: {launched}; re-sorts {step.resorts}")
    print(f"    (e) sharded boids step: {BOIDS_STEPS / sum(sh_s):.3f} "
          f"steps/s, median {float(np.median(sh_s)) * 1e3:.4f} ms; Flock: "
          f"{BOIDS_STEPS / sum(fl_s):.3f} steps/s, median "
          f"{float(np.median(fl_s)) * 1e3:.4f} ms; median ratio "
          f"{float(np.median(sh_s)) / float(np.median(fl_s)):.4f}")
    # Where each step's time goes: 12 steps each (two re-sorts).
    profile_steps("(e) sharded boids step, 12 steps", lambda: one(BOIDS_DT),
                  12)
    profile_steps("(e) Flock's window step, 12 steps",
                  lambda: flock.update(BOIDS_DT), 12)
    del sst, box, flock
    torch.cuda.empty_cache()
    return launched


# Phase 21.
N_10M = 10_000_000
BUILD_REPS = 3         # timed builds of each emission mode
BENCH_METRICS = ("boids_steps_per_sec_100k", "boids_steps_per_sec_500k",
                 "nbody_steps_per_sec_1000k_theta0.8",
                 "nbody_frame_time_ms_10000k")
# record --estimate: preset, body-count override, frames.
ESTIMATES = (("tiny_galaxy", "8k"), ("bar_galaxy", "1m"),
             (PRESET_50M, None))


def pool_far_mass(lists):
    """(ng,) float64 mass of each group's far entries in the pool (row 6,
    the first far_n slots from its first tile)."""
    import torch
    ct, _, tile = lists.pool.shape
    ng = lists.far_n.shape[0]
    pstart, far_n = lists.pstart.long(), lists.far_n.long()
    t_idx = torch.arange(ct, device=pstart.device)
    g = (torch.searchsorted(pstart, t_idx, right=True) - 1).clamp(0, ng - 1)
    ent = ((t_idx - pstart[g])[:, None] * tile
           + torch.arange(tile, device=pstart.device)[None])
    live = (ent < far_n[g][:, None]) & (t_idx < pstart[-1] + (
        far_n[-1] + tile - 1) // tile)[:, None]
    m = lists.pool[:, 6, :].double()
    return torch.zeros(ng, dtype=torch.float64, device=m.device).index_add_(
        0, g[:, None].expand(ct, tile)[live], m[live])


def require_pool_mass_conserved(st, config, label):
    """Pooled lists: every group's window mass plus its far entries' mass
    (slivers and residual included) equals the total within 1e-4."""
    import torch
    lists = st.lists
    gsz, wg = config.group_size, config.window_groups
    ng = lists.far_n.shape[0]
    n = st.mass.shape[0]
    gm = torch.zeros(ng * gsz, dtype=torch.float64, device=st.mass.device)
    gm[:n] = st.mass.double()
    gm = gm.reshape(ng, gsz).sum(1)
    c = torch.cat([gm.new_zeros(1), gm.cumsum(0)])
    g = torch.arange(ng, device=gm.device)
    window = (c[torch.clamp(g + wg, max=ng - 1) + 1]
              - c[torch.clamp(g - wg, min=0)])
    total = float(gm.sum())
    rel = float(((window + pool_far_mass(lists)) - total).abs().max()) / total
    print(f"    mass conservation ({label}): max over {ng} groups of "
          f"|window + far - total| / total = {rel:.3e} (limit 1e-4)")
    require(rel <= 1e-4, f"{label}: per-group mass off by {rel}")


def compact_on_card(dev, kernels):
    """Phase 21 (a): the three range emissions of one 1M state, equal bit
    for bit ("compact-mm" runs the compact path); kernel 2 on the pools;
    the build times beside the default cell-id finish; then the 1M window step
    with compact emission, launches counted from zero.  Returns kernel
    2's launches in that run."""
    import torch
    from spatialsim_tpu_torch.config.nbody import NBODY, resolve_config
    from spatialsim_tpu_torch.models.nbody import NBodySimulation
    from spatialsim_tpu_torch.ops import bh_window as bw
    from spatialsim_tpu_torch.ops.bh_eval_kernel import (
        window_eval, window_eval_pool)
    cfg = resolve_config(NBODY.replace(num_bodies=N_MAIN), N_MAIN)
    pos, vel, mass = galaxy(N_MAIN, 0, dev)
    cal = bw.calibrate_config(cfg, pos, vel, mass)
    st = bw.init_window_state(pos, vel, mass, cal)
    acc = bw.eval_accel_sorted(st.lists, st.pos, st.mass, DT,
                               **bw._eval_kw(cal))

    def build(mode):
        return rebuilt_lists(bw, st, cal.replace(traversal_emit=mode), acc)

    lists = {mode: build(mode) for mode in ("ranges", "compact", "compact-mm")}
    ref = lists["ranges"]
    fields = ("order", "inv_order", "far_n", "pstart", "pool")
    for mode in ("compact", "compact-mm"):
        differ = [f for f in fields
                  if not torch.equal(getattr(ref, f), getattr(lists[mode], f))]
        print(f"    {mode} against ranges: far_n, pstart and the whole pool "
              f"{tuple(ref.pool.shape)} equal bit for bit: {not differ} "
              f"{differ}")
        require(not differ, f"{mode} pool differs from ranges in {differ}")

    s_pos, s_mass = padded_sorted(st)
    kw = bw._eval_kw(cal)
    evals = {m: window_eval_pool(s_pos, s_mass, l.pool, l.pstart, l.far_n,
                                 0, DT, **kw) for m, l in lists.items()}
    same = all(torch.equal(evals["ranges"], e) for e in evals.values())
    print(f"    kernel 2 on the ranges, compact and compact-mm pools: equal "
          f"bit for bit: {same}")
    require(same, "kernel 2 differs between the equal pools")
    del evals, lists, ref

    # Build times, CUDA-synchronised: the default cell-id finish first.
    times = {}
    for mode in ("auto", "ranges", "compact", "compact-mm"):
        out = []
        for _ in range(BUILD_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            build(mode)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        times[mode] = out
        print(f"    1M build ({'cell-id' if mode == 'auto' else mode}): "
              f"{', '.join(f'{x:.3f}' for x in out)} ms (median "
              f"{statistics.median(out):.3f})")
    del st, acc, pos, vel, mass
    torch.cuda.empty_cache()

    for fn in (window_eval_pool, window_eval):
        fn.launches = 0
    t = time.perf_counter()
    sim = NBodySimulation(num_bodies=N_MAIN,
                          config=NBODY.replace(traversal_emit="compact"),
                          device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    step_s = timed_steps(sim.update, STEPS, DT)
    launched = window_eval_pool.launches
    print(f"    compact main path: init {init_s:.3f} s; launches "
          f"window_eval_pool {launched}, window_eval {window_eval.launches}")
    report_steps("1M window step, traversal_emit='compact'", step_s)
    require(launched == STEPS and window_eval.launches == 0,
            (launched, window_eval.launches))
    require(sim.rebuilds == 1, f"rebuilds {sim.rebuilds}")
    for name, t_ in (("pos", sim.state.pos), ("vel", sim.state.vel)):
        require(t_.shape == (3, N_MAIN) and bool(torch.isfinite(t_).all()),
                f"compact {name} finite, shape {tuple(t_.shape)}")
    require_pool_mass_conserved(sim.state, sim.config, "compact, step 48")
    del sim
    torch.cuda.empty_cache()
    return launched


def bench_proc(extra=()):
    """``python -m spatialsim_tpu_torch.tools.bench`` with ``extra``
    arguments, as a user runs it; its card line, JSON lines and launch
    lines printed.  Returns ({metric: value}, {job: kernel launches},
    the process, its wall seconds)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "spatialsim_tpu_torch.tools.bench", *extra],
        cwd=ROOT, env=env, capture_output=True, text=True)
    secs = time.perf_counter() - t
    for line in proc.stdout.splitlines() + proc.stderr.splitlines():
        if line.startswith(("{", "[bench]")) or " W, " in line or \
                line.endswith(" W"):
            print("    " + line)
    values, launches = {}, {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            require(set(rec) == {"metric", "value", "unit", "vs_baseline"},
                    rec)
            values[rec["metric"]] = rec["value"]
    for line in proc.stderr.splitlines():
        if " kernel launches: " in line:
            job, _, counts = line[len("[bench] "):].partition(
                " kernel launches: ")
            launches[job] = json.loads(counts)
    require(proc.returncode == 0 and "FAILED" not in proc.stderr,
            f"bench {list(extra)} rc {proc.returncode}:\n"
            f"{proc.stderr[-4000:]}")
    return values, launches, proc, secs


def run_bench():
    """Phase 21 (b): the port bench's full suite.  Every metric's line
    under bench.py's name, its value finite and positive, no metric
    failed; returns ({metric: value}, {job: kernel launches})."""
    import math
    values, launches, _, secs = bench_proc()
    print(f"    bench wall seconds: {secs:.3f} (four metrics, a process "
          f"each)")
    require(tuple(sorted(values)) == tuple(sorted(BENCH_METRICS)), values)
    require(all(math.isfinite(v) and v > 0 for v in values.values()),
            values)
    require(launches.get("1m", {}).get("window_eval_pool", 0) > 0
            and launches.get("10m", {}).get("window_eval_pool", 0) > 0
            and launches.get("boids", {}).get("boids_window", 0) > 0
            and launches.get("boids500k", {}).get("boids_window", 0) > 0,
            launches)
    return values, launches


def ten_million(dev, kernels):
    """Phase 21 (c): the bench's 10m config through NBodySimulation in this
    process: set-up, peak memory, per-group mass, phase 5's protocol on
    4,096 bodies (fresh <= 5%; tau = 23 reported), and kernel 2 on the
    run's lists (group 1024, T = 4) against its plain version.  Beside
    them, for this config and for ``scripts/extreme_run.py``'s (the JAX
    package's 10M error log): the list line, each level's worklist
    demand against its cap, and the fresh-list error on 1,024 and 4,096
    bodies (reported).  Returns kernel 2's launches in the run."""
    import numpy as np
    import torch
    from spatialsim_tpu_torch.ops import bh_window as bw
    from spatialsim_tpu_torch.ops.bh_eval_kernel import (
        tile_targets, window_eval_pool, window_eval_pool_reference)
    from spatialsim_tpu_torch.models.nbody import NBodySimulation
    from spatialsim_tpu_torch.tools import bench
    from spatialsim_tpu_torch.tools.extreme_run import (
        demand_against_caps, extreme_run_config, fresh_sample_errors,
        list_health)
    from spatialsim_tpu_torch.tools.oracle import exact_accel_at
    from spatialsim_tpu_torch.tools.staleness_scan import warmed_state
    args = bench.parser().parse_args(["--only", "10m"])
    kw = bench.job_kwargs("10m", args)
    cfg = bench.nbody_config(**{k: kw[k] for k in (
        "n", "theta", "distribution", "engine", "group_size", "depth",
        "list_cap", "skin", "rebuild_interval", "drift_mode")})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    window_eval_pool.launches = 0
    t = time.perf_counter()
    sim = NBodySimulation(num_bodies=N_10M, config=cfg, device="cuda")
    torch.cuda.synchronize()
    c = sim.config
    print(f"    10M cluster: set-up {time.perf_counter() - t:.3f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in sim.setup_seconds.items())
          + f"); depth {c.max_depth}, group {c.group_size}, list cap "
          f"{c.list_capacity}, advance order {c.advance_order}, pool tile "
          f"{c.pool_tile}, pool_cap {c.pool_cap} tiles, wl_caps "
          f"{c.wl_caps}, tree_caps {c.tree_caps}")
    lists = sim.state.lists
    print(f"    10M lists: pool {tuple(lists.pool.shape)} "
          f"({lists.pool.numel() * 4 / 1e9:.3f} GB), far_n mean "
          f"{float(lists.far_n.float().mean()):.1f} max "
          f"{int(lists.far_n.max())}; peak device memory GB "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    require(c.max_depth == 9 and c.group_size == 1024
            and c.list_capacity == 8192 and c.pool_tile > 0, c)
    require_pool_mass_conserved(sim.state, c, "10M first build")
    list_health(sim.state, c, "10M (bench config)", indented)
    demand_against_caps(sim.state, c, "10M (bench config)", indented)
    fresh_sample_errors(sim.state, c, "10M (bench config)", out=indented)
    check_capture(sim, c.max_speed_color, "10M")

    # Phase 5's protocol: 5 warm-up steps at interval 4, then the lists
    # frozen to tau = 23; a sample of 4,096 against a direct sum.
    idx = torch.as_tensor(np.sort(np.random.default_rng(1).choice(
        N_10M, N_SAMPLE, replace=False)), device=dev)
    ekw = bw._eval_kw(c)

    def errors(st, tag, fresh):
        pos_o, vel_o, mass_o = original_order(st)
        exact = exact_accel_at(pos_o[:, idx], pos_o, mass_o, c.G,
                               c.softening)
        got = force_errors(bw.eval_accel(st.lists, pos_o, mass_o, DT,
                                         **ekw)[:, idx], exact)
        print(f"    10M {tag}, lists {st.lists.steps_since} steps old: rms "
              f"of |da|/|a| {got[0]:.4%}  median {got[1]:.4%}  "
              f"rms|da|/rms|a| {got[2]:.4%}")
        if fresh:
            fl = bw.build_lists(pos_o, vel_o, mass_o, **bw._build_kw(c))
            fr = force_errors(bw.eval_accel(fl, pos_o, mass_o, 0.0,
                                            **ekw)[:, idx], exact)
            print(f"    10M {tag}, rebuilt: rms of |da|/|a| {fr[0]:.4%}  "
                  f"median {fr[1]:.4%}  rms|da|/rms|a| {fr[2]:.4%}")
        return got[0]

    pos0 = sim.state.pos[:, sim.state.lists.inv_order.long()]
    vel0 = sim.state.vel[:, sim.state.lists.inv_order.long()]
    mass0 = sim.state.mass[sim.state.lists.inv_order.long()]
    del sim, lists
    torch.cuda.empty_cache()
    t = time.perf_counter()
    st = warmed_state(pos0, vel0, mass0, c)
    del pos0, vel0, mass0
    e_fresh = errors(st, "protocol", True)
    frozen = bw.make_window_step(c.replace(rebuild_interval=10 ** 6), N_10M,
                                 substeps=1)
    step_s = []
    for _ in range(22):
        tt = time.perf_counter()
        st = frozen(st, DT)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - tt)
    require(st.lists.steps_since == 23, st.lists.steps_since)
    e_stale = errors(st, "protocol", False)
    print(f"    10M: protocol wall {time.perf_counter() - t:.3f} s; plain "
          f"steps (frozen lists) median "
          f"{statistics.median(step_s) * 1e3:.3f} ms; peak device memory "
          f"GB {torch.cuda.max_memory_allocated() / 1e9:.3f}")
    print(f"    limit on the fresh rms of |da|/|a|: 5% (tau = 23 reported: "
          f"{e_stale:.4%})")
    require(e_fresh <= 0.05, f"10M fresh rms {e_fresh}")
    require_pool_mass_conserved(st, c, "10M after the protocol's builds")
    launched = window_eval_pool.launches
    builds = []
    for _ in range(BUILD_REPS):
        torch.cuda.synchronize()
        tt = time.perf_counter()
        rebuilt_lists(bw, st, c, st.acc)
        torch.cuda.synchronize()
        builds.append((time.perf_counter() - tt) * 1e3)
    print(f"    10M list builds (the rebuild, cell-id): "
          f"{', '.join(f'{x:.3f}' for x in builds)} ms")

    # Kernel 2 at the 10M shape: group 1024, T = tile_targets(1024).
    s_pos, s_mass = padded_sorted(st)
    lists = st.lists
    args = (s_pos, s_mass, lists.pool, lists.pstart, lists.far_n,
            lists.steps_since, DT)
    got = window_eval_pool(*args, **ekw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = window_eval_pool_reference(*args, **ekw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    abs_err, err = kernel_errors(got, want)
    ms = cuda_ms(lambda: window_eval_pool(*args, **ekw), 5)
    gsz, wg = c.group_size, c.window_groups
    ng = lists.far_n.shape[0]
    live = int(lists.far_n.long().sum())
    pairs = window_pairs(ng, gsz, wg) + live * gsz
    nbytes = 4 * (s_pos.numel() + s_mass.numel() + 10 * live
                  + lists.pstart.numel() + lists.far_n.numel() + got.numel())
    b_ms, b_by = bound(18.0 * pairs, nbytes)
    print(f"    kernel 2 on the 10M lists (group {gsz}, T="
          f"{tile_targets(gsz)}, tau {lists.steps_since}): max|da| = "
          f"{abs_err:.3e}, max|da|/max|a| = {err:.3e} (tol {TOL_WINDOW}); "
          f"kernel {ms:.4f} ms = {pairs / ms / 1e6:.1f} Gpairs/s over "
          f"{pairs:.4e} pairs; plain {plain_ms:.4f} ms; bound {b_ms:.4f} "
          f"ms ({b_by}), {b_ms / ms:.1%} of it")
    require(err <= TOL_WINDOW, f"10M window eval error {err}")
    record_kernel(kernels, "window_eval_pool_10m", abs_err, err, ms,
                  plain_ms, 18.0 * pairs, nbytes)
    del st, lists, args, got, want, s_pos, s_mass
    torch.cuda.empty_cache()

    # The JAX package's own 10M error protocol (scripts/extreme_run.py
    # 10000000 10 0.8: its softer, wider cluster, fresh lists, 1,024
    # samples), on the port.
    xc = extreme_run_config(N_10M)
    t = time.perf_counter()
    sim = NBodySimulation(num_bodies=N_10M, config=xc, device="cuda")
    torch.cuda.synchronize()
    print(f"    10M (extreme_run config: G {xc.G}, softening "
          f"{xc.softening}, spawn radius {xc.spawn_radius}): set-up "
          f"{time.perf_counter() - t:.3f} s; wl_caps {sim.config.wl_caps}")
    list_health(sim.state, sim.config, "10M (extreme_run config)",
                indented)
    demand_against_caps(sim.state, sim.config,
                        "10M (extreme_run config)", indented)
    fresh_sample_errors(sim.state, sim.config,
                        "10M (extreme_run config)", out=indented)
    del sim
    torch.cuda.empty_cache()
    return launched


# Phase 22: kernel 1's targets-and-sources mode at reduced sizes (source
# counts and their sampled targets; the ring's bodies and shard counts),
# then a short call of every tool.
AT_SHAPES = ((1_048_576, 4096), (10_000_000, 4096), (50_000_000, 4096))
AT_RING, AT_RING_SHARDS = 32_768, (1, 2)
N_STALE = 262_144
N_TOOLS = 65_536


def tools_on_card(dev, kernels):
    """Phase 22: (a) the targets-and-sources mode against its plain
    version at the main path's shapes (4,096 targets x 1M, 10M and 5e7
    sources; float32 on every target up to 2M sources and on 64 above,
    float64 on 64),
    two calls bit for bit, ms beside the plain oracle's and the bound;
    the ring's hop sums at 32,768 bodies on one card (D 1 and 2); then
    the tools on the card: ``staleness_scan`` at 262,144 bodies (taus 0
    and 32), ``nbody_error``, ``nbody_error_scan``, ``quad_scan`` (65,536
    bodies), ``extreme_run`` (1M, 10 steps), ``prof_parts`` (262,144) and
    ``verify_drive`` (8K ``tiny_galaxy``, 30 frames + 10).  Returns the
    mode's launches in (a) and in the tools' run, each counted from
    zero."""
    import math
    import torch
    from spatialsim_tpu_torch.ops.allpairs import allpairs_accel_at
    from spatialsim_tpu_torch.tools import (
        extreme_run, nbody_error, nbody_error_scan, oracle, prof_parts,
        quad_scan, staleness_scan, verify_drive)
    print("  (a) the targets-and-sources mode against its plain version")
    allpairs_accel_at.launches = 0
    for n, k in AT_SHAPES:
        r = oracle.measure_mode(n, k, dev, plain_max=2e6, out=indented)
        require(r["bit_equal"] and r["rel_err"] <= TOL_ALLPAIRS
                and r["rel_err_f64"] <= TOL_ALLPAIRS, r)
        record_kernel(kernels, "allpairs_at", r["max_abs_err"], r["rel_err"],
                      r["ms"], r["plain_ms"], oracle.OPS_PER_PAIR * k * n,
                      4 * (6 * k + 4 * n))
    for r in oracle.ring_hops(AT_RING, dev, AT_RING_SHARDS, out=indented):
        require(r["rel_err"] <= TOL_ALLPAIRS, r)
    compared = allpairs_accel_at.launches

    print("  (b) the tools on the card")
    allpairs_accel_at.launches = 0
    t = time.perf_counter()
    recs = staleness_scan.scan(N_STALE, taus=[0, 32], device=dev,
                               out=indented)
    s0 = recs[0]
    require(all(math.isfinite(r[k]["rms"]) for r in recs
                for k in ("stale", "fresh")), recs)
    require(abs(s0["stale"]["rms"] - s0["fresh"]["rms"])
            <= 0.05 * s0["fresh"]["rms"] + 1e-4, s0)
    timed = [("staleness_scan", time.perf_counter() - t)]
    t = time.perf_counter()
    rec = nbody_error.run(nbody_error.parser().parse_args(
        [str(N_TOOLS), "--sample", "512"]), dev, out=indented)
    require(math.isfinite(rec["err_rms"]), rec)
    timed.append(("nbody_error", time.perf_counter() - t))
    t = time.perf_counter()
    recs = nbody_error_scan.scan(N_TOOLS, dev, out=indented)
    require(len(recs) == 1 + len(nbody_error_scan.VARIANTS)
            and all(math.isfinite(r["rms"]) for r in recs), recs)
    timed.append(("nbody_error_scan", time.perf_counter() - t))
    t = time.perf_counter()
    recs = quad_scan.scan(N_TOOLS, dev, out=indented)
    require(len(recs) == len(quad_scan.FRONTIER)
            and all(math.isfinite(r["rms"]) for r in recs), recs)
    timed.append(("quad_scan", time.perf_counter() - t))
    t = time.perf_counter()
    res = extreme_run.run(N_MAIN, steps=10, device=dev, out=indented)
    require(all(math.isfinite(e[2]) for e in res["errors"].values()), res)
    timed.append(("extreme_run", time.perf_counter() - t))
    t = time.perf_counter()
    ms = prof_parts.parts(N_STALE, dev, out=indented)
    require(all(math.isfinite(v) for v in ms.values()), ms)
    timed.append(("prof_parts", time.perf_counter() - t))
    tools = allpairs_accel_at.launches
    t = time.perf_counter()
    drive = verify_drive.drive("tiny_galaxy", "8k", 30, 10, 10, dev.type,
                               timeout=300, out=indented)
    require(drive["total_frames"] == 40, drive)
    timed.append(("verify_drive", time.perf_counter() - t))
    print("    tool seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in timed)
          + f"; the mode launched {tools} times in the tools' run")
    require(tools > 0, "the tools launched no direct sum on the card")
    torch.cuda.empty_cache()
    return compared, tools


# Phase 23: the rebuild and eval tools' bodies (decide7 runs at N_MAIN).
N_REBUILD_TOOLS = 262_144
# Phase 23 (a)'s rows beyond decide7's: notgt and nowin with the far lists
# kept, so that each flag meets a plain answer that is not zero (decide7
# sets notgt only where nothing is summed).
ABLATION_CHECK_ROWS = (("far_notgt", True, "notgt"),
                       ("far_now", True, "nowin"))


def ablation_on_card(dev, kernels, kept):
    """Phase 23 (a): the ablation instances against their plain version on
    phase 11's 1M dense R=10 lists (``kept``: its inputs and output on the
    host), every ``tools/decide7.py`` row and ``ABLATION_CHECK_ROWS`` at
    every T in the heavy-first order, each row that sums pairs against a
    plain answer that is not zero; the default instance against phase
    11's output bit for bit.
    Returns the launches made here (comparisons: not main-path)."""
    import torch
    from spatialsim_tpu_torch.ops.bh_eval_kernel import (
        dense_launch, heavy_first, tile_targets, window_eval,
        window_eval_reference)
    from spatialsim_tpu_torch.tools import decide7
    kw = kept["ekw"]
    s_pos, s_mass, far, far_n = (kept[k].to(dev) for k in (
        "s_pos", "s_mass", "far", "far_n"))
    ss = kept["steps_since"]
    gsz, wg = kw["group_size"], kw["window_groups"]
    got = window_eval(s_pos, s_mass, far, far_n, None, ss, DT, **kw)
    require(torch.equal(got.cpu(), kept["out"]),
            "the default instance differs from phase 11's output")
    print(f"    default instance: equal bit for bit to phase 11's output "
          f"({tuple(got.shape)})")
    window_eval.dbg_launches = 0
    plan = tile_targets(gsz, far.shape[1])
    order = heavy_first(far_n, None, gsz)
    zero = torch.zeros_like(far_n)
    rows = []
    for tag, keep, dbg in decide7.ROWS + ABLATION_CHECK_ROWS:
        args = (s_pos, s_mass, far, far_n if keep else zero, None, ss, DT)
        want = window_eval_reference(*args, dbg=dbg, **kw)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        require(scale > 0 or not keep and "nowin" in dbg,
                f"ablation {tag} ({dbg!r}): sums pairs, but the plain "
                f"answer is all zero")
        errs = {}
        for T in (1, 2, 4):
            out = dense_launch(*args, targets=T, order=order, dbg=dbg, **kw)
            torch.cuda.synchronize()
            errs[T] = float((out - want).abs().max())
            require(errs[T] <= TOL_WINDOW * scale if scale
                    else errs[T] == 0,
                    f"ablation {tag} ({dbg!r}) T={T}: {errs[T]} of {scale}")
        ms = cuda_ms(lambda: window_eval(*args, dbg=dbg, **kw), 5)
        plain_ms = cuda_ms(lambda: window_eval_reference(*args, dbg=dbg,
                                                         **kw), 1)
        pairs, ops, nbytes = decide7.row_work(far_n, far.shape[1], gsz, wg,
                                              keep, dbg)
        b_ms, b_by = bound(ops, nbytes)
        print(f"    {tag:10s} dbg={dbg!r}: max|da| " + ", ".join(
            f"T={T} {e:.3e}" for T, e in errs.items())
            + f" of max|a| {scale:.4e} (tol {TOL_WINDOW}); plan T={plan} "
            f"{ms:.4f} ms, {pairs:.4e} pairs, bound {b_ms:.4f} ms "
            f"({b_by}, {b_ms / ms:.1%}); plain {plain_ms:.4f} ms")
        if dbg:
            rows.append((tag, max(errs.values()),
                         max(errs.values()) / scale if scale else 0.0, ms,
                         plain_ms, ops, nbytes))
    # The summary's timing is base_uttr's (the whole work, the block sums
    # in place of the output's layout); the errors are every row's.
    for row in sorted(rows, key=lambda r: r[0] != "base_uttr"):
        record_kernel(kernels, "window_eval_dbg", *row[1:])
    del s_pos, s_mass, far, far_n, zero
    torch.cuda.empty_cache()
    return window_eval.dbg_launches


def rebuild_tools_on_card():
    """Phase 23 (b): each rebuild and eval tool's ``main`` on the card, run
    short; decide7 first, with the ablation instances' launches counted
    from zero over its run.  Returns those launches."""
    import torch
    from spatialsim_tpu_torch.ops.bh_eval_kernel import window_eval
    from spatialsim_tpu_torch.tools import (
        decide7, decide29, decide_1m, diag10m, eval_bench, prof_rebuild,
        quick_metrics)
    n = str(N_REBUILD_TOOLS)
    timed = []
    window_eval.dbg_launches = 0
    for name, main, argv in (
            ("decide7", decide7.main, [str(N_MAIN)]),
            ("prof_rebuild", prof_rebuild.main, [n]),
            ("eval_bench", eval_bench.main, [n]),
            ("diag10m", diag10m.main, [n]),
            ("decide29", decide29.main, [n]),
            ("decide_1m", decide_1m.main, [n]),
            ("quick_metrics", quick_metrics.main, [n])):
        t = time.perf_counter()
        require(main(argv + ["--device", "cuda"]) == 0, name)
        timed.append((name, time.perf_counter() - t))
        if name == "decide7":
            launches = window_eval.dbg_launches
        torch.cuda.empty_cache()
    print("    tool seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in timed)
          + f"; the ablation instances launched {launches} times in "
          f"decide7's run")
    require(launches > 0, "decide7 launched no ablation instance")
    return launches


# Phase 24: the ablation sets of (a), the N-body tools' bodies and the
# boids tools' flock of (b).
ABLATION_SETS = (("gather_cell",), ("gather_group",), ("emit",),
                 ("sliver",), ("expand",), ("emit", "sliver"))
N_BOIDS_TOOLS = 100_000


def _host_ints(out):
    """The integer tensors of an output tuple, on the host."""
    return [t.cpu() for t in out
            if t is not None and not t.dtype.is_floating_point]


def ablations_on_card(dev, kept):
    """Phase 24 (a): on phase 3's 1M lists inputs (``kept``, on the host),
    the default build equal to phase 3's lists bit for bit; then the
    ranges traversal (``_traverse_global``) with each set of
    ``ABLATION_SETS`` and the calibrated build (``build_lists``) with each
    and with "finish", on the card and on the CPU: their integer outputs
    (far_n, sl_n, the worklist fills and demands, the ranges or the
    pool's range rows, order, inv_order, pstart) equal bit for bit."""
    import torch
    from spatialsim_tpu_torch.ops import bh_window as bw
    from spatialsim_tpu_torch.tools.chain import presort, traversal_inputs
    kw = kept["kw"]
    host = kept["state"]
    card = [t.to(dev) for t in host]
    again = bw._resort_state(*card[:3], kept["order"].to(dev),
                             kept["inv"].to(dev), kw, acc=card[3])[3]
    differ = [f for f, t in kept["lists"].items()
              if not torch.equal(getattr(again, f).cpu(), t)]
    print(f"    the default build of phase 3's state: every field equal "
          f"bit for bit to phase 3's lists: {not differ} {differ}")
    require(not differ, f"the default build differs in {differ}")
    del again

    trav = {}
    for where, tensors in (("card", card), ("cpu", host)):
        t = time.perf_counter()
        tree, bmin, bmax, ng, tkw, _ = traversal_inputs(
            kw, presort(*tensors, kw), kw["tree_caps"])
        for abl in ABLATION_SETS:
            # far, far_range, far_n, sl_start, sl_end, sl_n, res, wl
            out = bw._traverse_global(tree, bmin, bmax, ng, **tkw,
                                      ablate=abl)
            trav[where, abl] = _host_ints(out[1:6] + out[7:])
        del tree
        print(f"    traversals on the {where}: "
              f"{time.perf_counter() - t:.3f} s")
    for abl in ABLATION_SETS:
        same = all(torch.equal(a, b) for a, b in
                   zip(trav["card", abl], trav["cpu", abl]))
        print(f"    _traverse_global ablate={abl}: integer outputs equal "
              f"to the CPU's: {same}; far_n sum "
              f"{int(trav['card', abl][1].sum())}, fills and demands "
              f"{trav['card', abl][-1].tolist()}")
        require(same, f"ablate={abl}: the card's traversal differs")
    del trav

    def ints(lists):
        return [lists.order.cpu(), lists.inv_order.cpu(), lists.far_n.cpu(),
                lists.pstart.cpu(), lists.pool[:, 10:14].cpu()]
    for abl in ABLATION_SETS + (("finish",),):
        t = time.perf_counter()
        a = ints(bw.build_lists(*card, **kw, ablate=abl))
        t_card = time.perf_counter() - t
        t = time.perf_counter()
        b = ints(bw.build_lists(*host, **kw, ablate=abl))
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"    build_lists ablate={abl}: order, inv_order, far_n, "
              f"pstart and the pool's range rows equal to the CPU's: "
              f"{same}; far_n sum {int(a[2].long().sum())}; card "
              f"{t_card:.3f} s, CPU {time.perf_counter() - t:.3f} s")
        require(same, f"ablate={abl}: the card's build differs")
    del card
    torch.cuda.empty_cache()


def _tool_counters():
    """The kernels the tools launch: ``{kernel: (wrapper, counter)}``."""
    from spatialsim_tpu_torch.ops.allpairs import allpairs_accel_at
    from spatialsim_tpu_torch.ops.bh_eval_kernel import (
        window_eval, window_eval_pool)
    from spatialsim_tpu_torch.ops.boids_window_kernel import (
        boids_window_accumulate)
    return {"allpairs_at": (allpairs_accel_at, "launches"),
            "window_eval_pool": (window_eval_pool, "launches"),
            "window_eval": (window_eval, "launches"),
            "window_eval_dbg": (window_eval, "dbg_launches"),
            "boids_window": (boids_window_accumulate, "launches")}


class _Tee:
    """A text stream that writes to every stream it was given."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def _run_tools(tools, check_failed):
    """Each ``(name, main, argv)`` of ``tools``: its ``main`` on the card
    (``--device cuda``), a nonzero exit failing the run (and, with
    ``check_failed``, a ``FAILED`` line), the launches of
    :func:`_tool_counters`' kernels counted from zero just before it; its
    seconds and launches printed.  Returns ``({kernel: launches over the
    tools}, {name: {kernel: launches}})``."""
    import contextlib
    import io
    import torch
    counters = _tool_counters()
    total = dict.fromkeys(counters, 0)
    per_tool, timed = {}, []
    for name, main, argv in tools:
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            rc = main(argv + ["--device", "cuda"])
        require(rc == 0, f"{name} exited {rc}")
        require(not check_failed or "FAILED" not in buf.getvalue(),
                f"{name} printed FAILED")
        got = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        per_tool[name] = got
        timed.append((name, time.perf_counter() - t,
                      {k: v for k, v in got.items() if v}))
        for k, v in got.items():
            total[k] += v
        torch.cuda.empty_cache()
    print("    tool seconds and kernel launches: " + "; ".join(
        f"{k} {v:.3f} s {c or ''}" for k, v, c in timed))
    return total, per_tool


def decomposition_tools_on_card():
    """Phase 24 (b) and (c): each decomposition tool's ``main`` on the
    card, run short (the N-body tools at ``N_REBUILD_TOOLS``, the boids
    tools at ``N_BOIDS_TOOLS``, the primitives at reduced shapes;
    ``decide13`` runs in phase 25), its seconds, and the launches of the
    tools' kernels in each tool's run, counted from zero; kernel 4's in
    decide12's run must be above 0.  Returns ``{kernel: launches}`` over
    the tools."""
    from spatialsim_tpu_torch.tools import (
        boids_capture, decide12, decide16, decide21, decide22, decide23,
        decide24, decide25, decide26, decide27, gather_bench)
    n, b = str(N_REBUILD_TOOLS), str(N_BOIDS_TOOLS)
    total, per_tool = _run_tools((
        ("decide21", decide21.main, [n]),
        ("decide27", decide27.main, [n]),
        ("decide25", decide25.main, [n]),
        ("decide26", decide26.main, [n]),
        ("decide23", decide23.main, [n]),
        ("decide24", decide24.main, ["--W", "1048576"]),
        ("decide22", decide22.main, [
            "--C", "65536", "--CP", "16384", "--G", "1024", "--L",
            "1024", "--emit", "1000000", "--pool-idx", "1000000",
            "--widths", "1048576", "--seg-width", "1048576",
            "--slices", "8192"]),
        ("gather_bench", gather_bench.main, ["--W", "1000000"]),
        ("decide16", decide16.main, ["--boids", b]),
        ("decide12", decide12.main, ["--boids", b]),
        ("boids_capture", boids_capture.main, ["--boids", b,
                                               "--sample", "1000"])),
        check_failed=False)
    boids_ab = per_tool["decide12"]["boids_window"]
    print(f"  (c) kernel 4 launched {boids_ab} times in decide12's run "
          f"(counted from zero)")
    require(boids_ab > 0, "decide12 launched no boids window kernel")
    return total


def final_tools_on_card():
    """Phase 25: each of the last tools' ``main`` on the card, run short
    (the N-body tools at ``N_REBUILD_TOOLS``, the boids rows at
    ``N_BOIDS_TOOLS``, ``decide19`` at reduced widths, ``distsort_bench``
    at world size 1); a tool's nonzero exit or a ``FAILED`` line fails the
    run.  Returns ``{kernel: launches}`` over the tools, each counted from
    zero just before its tool's run."""
    from spatialsim_tpu_torch.tools import (
        decide2, decide3, decide4, decide5, decide6, decide8, decide9,
        decide10, decide11, decide13, decide14, decide19, decide20,
        distsort_bench, nbody_scan2, seam_analysis)
    n, b = str(N_REBUILD_TOOLS), str(N_BOIDS_TOOLS)
    total, _ = _run_tools((
        ("decide13", decide13.main, [n]),
        ("decide20", decide20.main, [n]),
        ("decide14", decide14.main, [n]),
        ("distsort_bench", distsort_bench.main, [n]),
        ("seam_analysis", seam_analysis.main, [n]),
        ("nbody_scan2", nbody_scan2.main, [n]),
        ("decide2", decide2.main, [n]),
        ("decide3", decide3.main, [n]),
        ("decide4", decide4.main, [n]),
        ("decide5", decide5.main, [n, "--boids", b]),
        ("decide6", decide6.main, [n, "--boids", b]),
        ("decide19", decide19.main, ["--n", "200000", "--W", "400000"]),
        ("decide8", decide8.main, [n]),
        ("decide9", decide9.main, [n]),
        ("decide10", decide10.main, [n]),
        ("decide11", decide11.main, [n])), check_failed=True)
    require(all(total.values()),
            f"phase 25 launched no kernel of some kind: {total}")
    return total


def estimate_anchors(line_1m, allpairs_ms):
    """Phase 21 (d): the readings behind ``tools/record.py``'s estimate
    anchors, taken in this run beside the constants: the 1M bench line
    (phase 21 (b)), the port bench at 10,000 bodies with the all-pairs
    engine (measured here), kernel 1 at 32,768 (phase 2)."""
    import math
    from spatialsim_tpu_torch.tools import record
    values, launches, _, _ = bench_proc(
        ["--only", "1m", "--bodies", "10000", "--engine", "allpairs"])
    (metric, floor), = values.items()
    require(math.isfinite(floor) and floor > 0, values)
    require(launches.get("1m", {}).get("allpairs", 0) > 0, launches)
    pair_ms = 32_768 ** 2 / record._EST_ALLPAIRS_PAIRS_PER_S * 1e3
    print(f"    estimate anchors, tools/record.py beside this run: 1M "
          f"window {1 / record._EST_ANCHOR_STEP_S:.3f} steps/s beside "
          f"{line_1m} (21 (b)); step floor "
          f"{1 / record._EST_STEP_FLOOR_S:.3f} steps/s beside {floor} "
          f"({metric}, --bodies 10000 --engine allpairs); kernel 1 at "
          f"32,768 {pair_ms:.4f} ms beside {allpairs_ms:.4f} ms (phase 2)")


def estimates(measured, device="cuda"):
    """Phase 21 (d): ``record --estimate`` for three presets beside the
    step or frame time this run measured at that shape (printed, not
    gated)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for preset, bodies in ESTIMATES:
        cmd = [sys.executable, "-m", "spatialsim_tpu_torch.tools.record",
               "--preset", preset, "--estimate", "--device", device]
        if bodies:
            cmd += ["--bodies", bodies]
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True)
        require(proc.returncode == 0, f"{cmd}: {proc.stdout}{proc.stderr}")
        line = proc.stdout.strip().splitlines()[-1]
        est_s = float(line.split("; ")[1].split(" s on ")[0])
        from spatialsim_tpu_torch.presets import get_preset_config
        pc = get_preset_config(preset)
        frames, sub = int(pc["total_frames"]), int(pc.get("substeps", 1))
        print(f"    {line}")
        print(f"    {preset}: estimate {est_s / frames * 1e3:.3f} ms a frame "
              f"({sub} steps) beside {measured[preset]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False -- "
                         "this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from spatialsim_tpu_torch import _kernels
    from spatialsim_tpu_torch.ops.allpairs import (
        ALLPAIRS_TARGETS, ALLPAIRS_THREADS, ALLPAIRS_TILE, MAX_SLICES,
        allpairs_accel, allpairs_accel_at, allpairs_accel_reference,
        allpairs_at_reference, allpairs_launch, allpairs_occupancy,
        allpairs_plan)
    from spatialsim_tpu_torch.ops.bh_eval_kernel import (
        MXU_CONTRACTIONS, _tile_counts, cols_launch, cols_plan, dense_launch,
        heavy_first, mxu_launch, mxu_occupancy, mxu_plan, occupancy,
        pool_launch, tile_targets, window_eval, window_eval_cols,
        window_eval_mxu, window_eval_pool, window_eval_pool_reference)
    from spatialsim_tpu_torch.ops import bh_window as bw
    from spatialsim_tpu_torch.ops.barnes_hut import barnes_hut_accel
    from spatialsim_tpu_torch.tools import eval_ab, eval_tiles
    from spatialsim_tpu_torch.models.nbody import NBodySimulation
    from spatialsim_tpu_torch.config.nbody import NBODY, resolve_config
    from spatialsim_tpu_torch.presets import get_preset_config
    from spatialsim_tpu_torch.tools.record import (
        RECORD_MAX_SPEED_COLOR, FrameOverlap, config_from_preset)
    from spatialsim_tpu_torch.ops.capture import (capture_colors,
                                                  capture_original)
    from spatialsim_tpu_torch.config.boids import BOIDS
    from spatialsim_tpu_torch.models.boids import Flock
    from spatialsim_tpu_torch.ops import boids_ops as bo
    from spatialsim_tpu_torch.ops import boids_window_kernel as bo_kernel
    from spatialsim_tpu_torch.ops.boids_window_kernel import (
        BOIDS_TARGETS, DEFAULT_TARGETS, boids_occupancy,
        boids_window_accumulate, boids_window_launch)
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    from spatialsim_tpu_torch.tools import decide15, decide18
    from spatialsim_tpu_torch.tools.oracle import exact_accel_at
    from spatialsim_tpu_torch.tools.staleness_scan import warmed_state
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    wall0 = time.perf_counter()
    kernels = {}
    probes = {}

    # ---- 1. card, versions, kernel build --------------------------------
    t0 = phase("1. card and kernel build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    _kernels.library(force_build=True, verbose=True)
    print(f"    kernel build seconds (nvcc, sm_90a): "
          f"{_kernels.build_info['seconds']:.3f}")
    # Registers of the instances of kernels 1-4 and 3b; any kernel's
    # spills.
    ptxas = eval_tiles.ptxas_table(_kernels.build_info["log"])
    for label, (regs, st, ld) in ptxas.items():
        if label.startswith("_Z") and not st + ld:
            continue
        print(f"    ptxas [{label}]: {regs} registers, spills {st} B "
              f"stored, {ld} B loaded")
    # SASS instructions a pair of the window-eval kernels, and of the
    # previous ones (one thread a target) when their sources are in
    # spatialsim_tpu_torch/_build/parent/.
    plib = eval_tiles.parent_library()
    sass = eval_tiles.sass_table(_kernels.build_info["path"])
    sass_old = ({} if plib is None
                else eval_tiles.sass_table(plib.path, previous=True))
    hmma = eval_tiles.hmma_table(_kernels.build_info["path"])
    for label, (per_pair, loops, _) in sorted({**sass, **sass_old}.items()):
        extra = (f", {hmma[label]:.3f} HMMA a pair" if hmma.get(label)
                 else "")
        print(f"    SASS {label}: {per_pair:.3f} instructions a pair "
              f"(innermost loops, instructions / MUFU.RSQ: {loops}){extra}")
    bsass = {k: v[0] for k, v in eval_tiles.boids_sass(
        _kernels.build_info["path"]).items()}
    if eval_tiles.has_parent(plib, "boids_window"):
        bsass.update({k: v[0] for k, v in eval_tiles.boids_sass(
            plib.path, previous=True).items()})
    for label, rec in sorted(bsass.items()):
        print("    SASS " + eval_tiles.boids_line(label, rec))
    if not sass:
        print("    SASS: no cuobjdump found; instructions a pair not "
              "measured")
    print("    previous kernels: "
          + (f"{sorted(plib.entries)} built from {eval_tiles.PARENT_DIR}"
             if plib else "absent"))
    done(t0)

    # ---- 2. kernel 1 vs plain -------------------------------------------
    t0 = phase("2. all-pairs kernel vs plain: the plan and every instance")
    ap_kw = (NBODY.G, NBODY.softening)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ap_prev = eval_tiles.has_parent(plib, "allpairs")
    for T in ALLPAIRS_TARGETS:
        for threads in ALLPAIRS_THREADS:
            blocks, regs, _ = allpairs_occupancy(threads, T, MAX_SLICES)
            print(f"    T={T}, {threads} threads: {regs} registers a thread, "
                  f"{blocks} blocks per SM resident")
    for n in AP_SIZES:
        pos, _, mass = galaxy(n, 1, dev)
        want = allpairs_accel_reference(pos, mass, *ap_kw)
        got = allpairs_accel(pos, mass, *ap_kw)
        torch.cuda.synchronize()
        abs_err, err = kernel_errors(got, want)
        require(err <= TOL_ALLPAIRS, f"N={n}: allpairs error {err}")
        prev, prev_err = [], None

        def previous():
            return eval_tiles.parent_allpairs(plib, pos, mass, *ap_kw)
        if ap_prev:
            prev_err = kernel_errors(previous(), want)[1]
            prev.append(cuda_ms(previous, 20))
        ms = cuda_ms(lambda: allpairs_accel(pos, mass, *ap_kw), 20)
        if n == AP_SIZES[0]:
            ENQUEUE_US["allpairs"] = enqueue_us(
                lambda: allpairs_accel(pos, mass, *ap_kw), 20)
        plain_ms = cuda_ms(lambda: allpairs_accel_reference(pos, mass,
                                                            *ap_kw), 3)
        # 19 FP32 operations a pair (FMA as 2) and one rsqrt; pos and
        # mass read once, acc written once.
        ops, nbytes = 19.0 * n * n, 4 * n * (4 + 3)
        b_ms, b_by = bound(ops, nbytes)
        record_kernel(kernels, "allpairs", abs_err, err, ms, plain_ms, ops,
                      nbytes)
        tiles = -(-n // ALLPAIRS_TILE)
        res, worst = {}, 0.0
        for threads in ALLPAIRS_THREADS:
            for T in ALLPAIRS_TARGETS:
                for S in (1, 2, 4, 8):
                    if S > tiles:
                        continue

                    def launch(threads=threads, T=T, S=S):
                        return allpairs_launch(pos, mass, *ap_kw,
                                               threads=threads, targets=T,
                                               slices=S)
                    e = kernel_errors(launch(), want)[1]
                    require(e <= TOL_ALLPAIRS, f"N={n} {threads}/{T}/{S}: {e}")
                    worst = max(worst, e)
                    res[(threads, T, S)] = (cuda_ms(launch, 10), e)
        if ap_prev:
            prev.append(cuda_ms(previous, 20))
        def issue_ms(T):
            rec = sass.get(f"allpairs T={T}")
            return (None if rec is None
                    else n * n * rec[0] / eval_tiles.ISSUE_RATE * 1e3)

        def waves(threads, T, S):
            blocks = -(-n // (threads * T)) * S
            per_sm = allpairs_occupancy(threads, T, S)[0]
            return blocks, per_sm, blocks / (per_sm * sms)
        threads, T, S = allpairs_plan(n)
        blocks, per_sm, plan_waves = waves(threads, T, S)
        rec = sass.get(f"allpairs T={T}")
        issue = ("not measured" if rec is None else
                 f"SASS {rec[0]:.3f} instructions a pair, issue-limited "
                 f"{issue_ms(T):.4f} ms")
        rec_old = sass_old.get("allpairs (previous)")
        if rec_old is not None:
            issue += (f" (previous: {rec_old[0]:.3f}, "
                      f"{n * n * rec_old[0] / eval_tiles.ISSUE_RATE * 1e3:.4f}"
                      f" ms)")
        was = ("previous kernel not measured (no sources in "
               "spatialsim_tpu_torch/_build/parent/)" if not prev else
               f"previous kernel {prev[0]:.4f} and {prev[1]:.4f} ms, before "
               f"and after (max|da|/max|a| {prev_err:.3e}): the plan takes "
               f"{2 * ms / sum(prev):.3f}x its time")
        print(f"    N={n}: plan {threads} threads, T={T}, S={S}: max|da| = "
              f"{abs_err:.3e}, max|da|/max|a| = {err:.3e} (tol "
              f"{TOL_ALLPAIRS}); kernel {ms:.4f} ms = "
              f"{n * n / ms / 1e6:.1f} Gpairs/s; plain {plain_ms:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of it; {issue}; "
              f"{blocks} blocks, {per_sm} per SM resident = "
              f"{plan_waves:.2f} waves on {sms} SMs")
        print(f"    N={n}: {was}")
        best = min(res, key=lambda k: res[k][0])
        print(f"    N={n}: every instance, threads/T/S (worst max|da|/max|a| "
              f"{worst:.3e}; fastest {'/'.join(map(str, best))}):")
        for (threads, T, S), (i_ms, e) in res.items():
            blocks, per_sm, w = waves(threads, T, S)
            iss = issue_ms(T)
            iss = ("not measured" if iss is None
                   else f"issue-limited {iss:.4f} ms")
            prev_x = (f", {2 * i_ms / sum(prev):.3f}x the previous kernel"
                      if prev else "")
            print(f"      {threads}/{T}/{S}: {i_ms:.4f} ms, max|da|/max|a| "
                  f"{e:.3e}, {b_ms / i_ms:.1%} of the bound, {iss}, "
                  f"{blocks} blocks, {w:.2f} waves{prev_x}")
    del pos, mass, got, want
    done(t0)

    # ---- 3. kernel 2 vs plain on the 1M lists ---------------------------
    t0 = phase("3. pooled window-eval kernel vs plain, 1M galaxy lists")
    cfg = resolve_config(NBODY.replace(num_bodies=N_MAIN), N_MAIN)
    pos, vel, mass = galaxy(N_MAIN, 0, dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cal = bw.calibrate_config(cfg, pos, vel, mass)
    torch.cuda.synchronize()
    print(f"    calibrate_config seconds: {time.perf_counter() - t:.3f}"
          f"  tree_caps={cal.tree_caps} wl_caps={cal.wl_caps} "
          f"pool_cap={cal.pool_cap}")
    st = bw.init_window_state(pos, vel, mass, cal)
    ekw = bw._eval_kw(cal)
    acc = bw.eval_accel_sorted(st.lists, st.pos, st.mass, DT, **ekw)
    # Rebuild with real accelerations so the pool's acc rows are live.
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, _, _, lists = bw._resort_state(st.pos, st.vel, st.mass,
                                      st.lists.order, st.lists.inv_order,
                                      bw._build_kw(cal), acc=acc)
    torch.cuda.synchronize()
    print(f"    list build seconds: {time.perf_counter() - t:.3f}  "
          f"pool {tuple(lists.pool.shape)}  "
          f"far_n mean {float(lists.far_n.float().mean()):.1f} "
          f"max {int(lists.far_n.max())}")

    # The same build again, without deterministic algorithms: the octree's
    # sums and the residual fold add in one fixed order, so every field is
    # equal bit for bit.  Then one build under the profiler.
    def rebuild():
        return bw._resort_state(st.pos, st.vel, st.mass, st.lists.order,
                                st.lists.inv_order, bw._build_kw(cal),
                                acc=acc)[3]
    require(not torch.are_deterministic_algorithms_enabled(),
            "deterministic algorithms are on")
    again = rebuild()
    differ = [f for f, t_ in lists._asdict().items()
              if isinstance(t_, torch.Tensor)
              and not torch.equal(t_, getattr(again, f))]
    print(f"    a second build of the same state: every field equal bit "
          f"for bit: {not differ} {differ}")
    require(not differ, f"two builds of one state differ in {differ}")
    profile_steps("1M list build (the rebuild's lists, pooled cell-id)",
                  rebuild, 1, watch=REBUILD_WATCH)
    s_pos, s_mass = eval_ab.sorted_inputs(lists, pos, mass)
    # Pairs the function needs: every window group in range, plus every
    # live far entry.  The kernel reads whole pool tiles, but the slots
    # past far_n hold zero mass and add nothing.
    gsz, wg = cal.group_size, cal.window_groups
    ng = lists.far_n.shape[0]
    g = torch.arange(ng, device=dev)
    n_win = (torch.clamp(g + wg, max=ng - 1) - torch.clamp(g - wg, min=0)
             + 1)
    live = int(lists.far_n.long().sum())
    pairs = int(n_win.sum()) * gsz * gsz + live * gsz
    print(f"    pairs per eval: {pairs:.4e} (window + live far entries)")
    for ss in (0, 23):
        args = (s_pos, s_mass, lists.pool, lists.pstart, lists.far_n, ss, DT)
        kw = dict(G=cal.G, softening=cal.softening,
                  group_size=cal.group_size,
                  window_groups=cal.window_groups,
                  tau_clamp=float(cal.advance_tau_clamp))
        got = window_eval_pool(*args, **kw)
        want = window_eval_pool_reference(*args, **kw)
        torch.cuda.synchronize()
        abs_err, err = kernel_errors(got, want)
        ms = cuda_ms(lambda: window_eval_pool(*args, **kw), 10)
        if ss == 0:
            ENQUEUE_US["window_eval_pool"] = enqueue_us(
                lambda: window_eval_pool(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: window_eval_pool_reference(*args, **kw),
                           1)
        print(f"    steps_since={ss}: max|da| = {abs_err:.3e}, "
              f"max|da|/max|a| = {err:.3e} "
              f"(tol {TOL_WINDOW})  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  kernel {pairs / ms / 1e6:.1f} Gpairs/s")
        require(err <= TOL_WINDOW, f"window eval error {err}")
        if ss == 0:
            twice = window_eval_pool(s_pos, s_mass, again.pool,
                                     again.pstart, again.far_n, ss, DT,
                                     **kw)
            require(torch.equal(twice, got), "the two builds' evals differ")
            print(f"    the second build's eval equal bit for bit: True")
            del again, twice
        # 18 FP32 operations a pair; the sorted bodies, the 10 pool rows
        # the kernel reads of each live far entry and the per-group tables
        # read once, accelerations written once.
        nbytes = 4 * (s_pos.numel() + s_mass.numel() + 10 * live
                      + lists.pstart.numel() + lists.far_n.numel()
                      + got.numel())
        record_kernel(kernels, "window_eval_pool", abs_err, err, ms,
                      plain_ms, 18.0 * pairs, nbytes)
    t3 = tile_targets(gsz)
    report_tiles(
        "1M pooled, steps_since=23",
        lambda T, order: pool_launch(*args, targets=T, order=order, **kw),
        (None if not eval_tiles.has_parent(plib, "window_eval_pool")
         else lambda: eval_tiles.parent_pool(plib, *args, **kw)),
        want, (1, 2, 4), t3, pairs, bound(18.0 * pairs, nbytes)[0], ng,
        lambda T: occupancy(gsz, T), sass.get(f"pool T={t3}"),
        sass_old.get("pool (previous)"), order=heavy_first(lists.far_n))
    # Phase 24 (a) builds these lists again with each ablation: their
    # inputs, the previous order and the lists themselves on the host.
    kept_3 = dict(
        state=[t.cpu() for t in (st.pos, st.vel, st.mass, acc)],
        order=st.lists.order.cpu(), inv=st.lists.inv_order.cpu(),
        kw=bw._build_kw(cal),
        lists={f: t.cpu() for f, t in lists._asdict().items()
               if isinstance(t, torch.Tensor)})
    del st, lists, acc, s_pos, s_mass, got, want
    done(t0)

    # ---- 4. main path ----------------------------------------------------
    t0 = phase("4. main path: NBodySimulation, both engines, default config")
    torch.cuda.synchronize()
    allpairs_accel.launches = 0
    window_eval_pool.launches = 0
    window_eval.launches = 0
    boids_window_accumulate.launches = 0
    # The all-pairs engine at its threshold (N <= 32,768) and at
    # tiny_galaxy's 10,000 bodies...
    ap_step_ms = {}
    for n_ap in AP_ENGINE_SIZES:
        sim_ap = NBodySimulation(num_bodies=n_ap, device="cuda")
        step_s = timed_steps(sim_ap.update, AP_STEPS, DT)
        require(sim_ap.engine == "allpairs", sim_ap.engine)
        require(bool(torch.isfinite(sim_ap.state.pos).all()),
                "allpairs state")
        ap_step_ms[n_ap] = sorted(step_s)[AP_STEPS // 2] * 1e3
        del sim_ap
    # ...and the window engine at 1M bodies.
    t = time.perf_counter()
    sim = NBodySimulation(num_bodies=N_MAIN, device="cuda")
    torch.cuda.synchronize()
    print(f"    init seconds (calibrate_config + first build): "
          f"{time.perf_counter() - t:.3f}  engine={sim.engine}")
    step_s = []
    st47 = None
    for k in range(STEPS):
        t = time.perf_counter()
        sim.update(DT)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        if k == STEPS - 2:
            st47 = sim.state
    step_s_1m = step_s
    launches = {"allpairs": allpairs_accel.launches,
                "window_eval_pool": window_eval_pool.launches}
    require(window_eval.launches == 0,
            f"the pooled default launched the dense kernel "
            f"{window_eval.launches} times")
    total = sum(step_s)
    order = sorted(step_s)
    plain_step = order[len(order) // 2]
    rebuild_step = max(step_s)
    print(f"    launches in the main path: {launches}")
    print(f"    {STEPS} steps in {total:.3f} s = {STEPS / total:.3f} steps/s "
          f"(rebuild included); median step {plain_step * 1e3:.3f} ms = "
          f"{1.0 / plain_step:.3f} steps/s between rebuilds")
    print(f"    rebuild step {rebuild_step * 1e3:.3f} ms (step "
          f"{step_s.index(rebuild_step) + 1}); rebuild ~ "
          f"{(rebuild_step - plain_step) * 1e3:.3f} ms over a plain step")
    print(f"    list builds: 1 at init + {sim.rebuilds} in the run")
    require(sim.engine == "window", sim.engine)
    require(launches["window_eval_pool"] == STEPS, launches)
    require(launches["allpairs"] == len(AP_ENGINE_SIZES) * AP_STEPS,
            launches)
    require(sim.rebuilds + 1 == 2, f"list builds {sim.rebuilds + 1}")
    for name, t_ in (("pos", sim.state.pos), ("vel", sim.state.vel)):
        require(t_.shape == (3, N_MAIN) and bool(torch.isfinite(t_).all()),
                f"final {name} finite, shape {tuple(t_.shape)}")
    print(f"    peak device memory GB: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    # The all-pairs engine's steps, and the same steps through the previous
    # kernel (its launches are not counted).
    prev_ms = {}
    if eval_tiles.has_parent(plib, "allpairs"):
        import spatialsim_tpu_torch.models.nbody as nbody_mod
        kernel_fn = nbody_mod.allpairs_accel
        nbody_mod.allpairs_accel = functools.partial(
            eval_tiles.parent_allpairs, plib)
        try:
            for n_ap in AP_ENGINE_SIZES:
                sim_ap = NBodySimulation(num_bodies=n_ap, device="cuda")
                step_s = timed_steps(sim_ap.update, AP_STEPS, DT)
                prev_ms[n_ap] = sorted(step_s)[AP_STEPS // 2] * 1e3
                del sim_ap
        finally:
            nbody_mod.allpairs_accel = kernel_fn
    for n_ap, step_ms in ap_step_ms.items():
        was = (f"{prev_ms[n_ap]:.3f} ms through the previous kernel"
               if n_ap in prev_ms else "the previous kernel not measured")
        print(f"    all-pairs engine N={n_ap}: median step {step_ms:.3f} ms "
              f"({AP_STEPS} steps, plan {allpairs_plan(n_ap)}); {was}")
    done(t0)

    # ---- 5. accuracy against direct sum ---------------------------------
    t0 = phase("5. accuracy vs direct sum, 4096 sampled bodies")
    ekw = bw._eval_kw(sim.config)
    idx = torch.as_tensor(np.sort(np.random.default_rng(1).choice(
        N_MAIN, N_SAMPLE, replace=False)), device=dev)

    def errors(st, fresh_too):
        """Errors of the state's own (aged) lists, and of fresh lists
        built from the same state, at ``idx`` in original body order."""
        pos_o, vel_o, mass_o = original_order(st)
        exact = exact_accel_at(pos_o[:, idx], pos_o, mass_o, cal.G,
                               cal.softening)
        age = st.lists.steps_since
        out = {f"lists {age} steps old": force_errors(
            bw.eval_accel(st.lists, pos_o, mass_o, DT, **ekw)[:, idx],
            exact)}
        if fresh_too:
            # As the JAX scan's "fresh" column: new lists, no cell
            # accelerations, tau = 0.
            fl = bw.build_lists(pos_o, vel_o, mass_o,
                                **bw._build_kw(sim.config))
            out[f"rebuilt at age {age}"] = force_errors(
                bw.eval_accel(fl, pos_o, mass_o, 0.0, **ekw)[:, idx], exact)
        return out

    def show(tag, errs):
        for k, (rms, med, ratio) in errs.items():
            print(f"    {tag} {k}: rms of |da|/|a| {rms:.4%}  median "
                  f"{med:.4%}  rms|da|/rms|a| {ratio:.4%}")

    # (a) The JAX package's accuracy protocol (scripts/staleness_scan.py):
    # 5 warm-up steps at interval 4 so the lists carry real cell
    # accelerations, then frozen lists aged to the end of an interval.
    pos, vel, mass = galaxy(N_MAIN, 0, dev)
    st = warmed_state(pos, vel, mass, sim.config)
    # Once: the fresh lists' rms through the plain chunked oracle and
    # through the kernel (its targets-and-sources mode).
    pos_o, vel_o, mass_o = original_order(st)
    fl = bw.build_lists(pos_o, vel_o, mass_o, **bw._build_kw(sim.config))
    a_fresh = bw.eval_accel(fl, pos_o, mass_o, 0.0, **ekw)[:, idx]
    tgt = pos_o[:, idx].contiguous()
    oracle_s = {}
    for label, fn in (("plain", allpairs_at_reference),
                      ("kernel", exact_accel_at)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ex = fn(tgt, pos_o, mass_o, cal.G, cal.softening)
        torch.cuda.synchronize()
        oracle_s[label] = (time.perf_counter() - t,
                           force_errors(a_fresh, ex)[0])
    (p_s, p_rms), (k_s, k_rms) = oracle_s["plain"], oracle_s["kernel"]
    print(f"    fresh lists' rms of |da|/|a| through the plain oracle "
          f"{p_rms:.6%} ({p_s:.3f} s) and through the kernel {k_rms:.6%} "
          f"({k_s:.3f} s): {abs(p_rms - k_rms):.3e} apart (limit 1e-4)")
    require(abs(p_rms - k_rms) <= 1e-4, (p_rms, k_rms))
    del fl, a_fresh, tgt, ex, pos_o, vel_o, mass_o
    # The oracle's launches from here on are the accuracy checks'
    # reference launches (phase 22 prints them apart from the main path's).
    allpairs_accel_at.launches = 0
    frozen = bw.make_window_step(sim.config.replace(rebuild_interval=10 ** 6),
                                 N_MAIN, substeps=22)
    proto = errors(st, True)
    st = frozen(st, DT)
    require(st.lists.steps_since == 23, st.lists.steps_since)
    proto.update(errors(st, True))
    show("protocol", proto)
    # (b) The main path's own last interval (steps 25-47 from the ICs).
    require(st47.lists.steps_since == 23, st47.lists.steps_since)
    show("main path", errors(st47, False))
    e_fresh = proto["lists 1 steps old"][0]
    e_stale = proto["lists 23 steps old"][0]
    print(f"    limits on the protocol's rms of |da|/|a|: 5% for fresh lists "
          f"(1 step old), 8% at tau=23")
    require(e_fresh <= 0.05 and e_stale <= 0.08, (e_fresh, e_stale))
    del sim, st47, st
    torch.cuda.empty_cache()
    done(t0)

    # ---- 6. recorder drive ------------------------------------------------
    t0 = phase("6. recorder CLI")
    # The recorder's 1M preset in this process: the step time of a frame,
    # and a plain frame and a rebuild frame (step, then the recorder's
    # capture) under CUDA sync debug mode.
    rcfg = get_preset_config("bar_galaxy")
    rcfg["num_bodies"] = N_MAIN
    rsub = int(rcfg["substeps"])
    rdt = float(rcfg["dt_per_frame"]) / rsub
    rsim = NBodySimulation(config=config_from_preset(rcfg), substeps=rsub,
                           device="cuda")
    frame_step_ms = statistics.median(timed_steps(rsim.step_raw, 6, rdt)) * 1e3
    with tempfile.TemporaryDirectory(prefix=".smoke_rec_", dir=ROOT) as tmp:
        fo = FrameOverlap(rsim, Path(tmp), SimpleNamespace(
            check_and_queue=lambda k: None), [])
        capture_original.launches = capture_colors.launches = 0
        fo.capture(0)                     # allocates the pinned buffers
        plain_syncs = sync_warnings(
            lambda: (rsim.step_raw(rdt), fo.capture(1)))
        rsim.step_raw(rdt)
        rebuilds = rsim.rebuilds
        rebuild_syncs = sync_warnings(
            lambda: (rsim.step_raw(rdt), fo.capture(2)))
        rebuilt = rsim.rebuilds - rebuilds
        # Frames 3-8 written before the next step, 9-14 overlapped.
        serial, overlapped = [], []
        for k in range(3, 15):
            t = time.perf_counter()
            rsim.step_raw(rdt)
            fo.capture(k)
            if k < 9:
                fo.flush()
            (serial if k < 9 else overlapped).append(
                time.perf_counter() - t)
        fo.flush()
    capture_launches = (capture_original.launches, capture_colors.launches)
    print(f"    the capture's kernel launches over its 15 frames: "
          f"capture_original {capture_launches[0]}, capture_colors "
          f"{capture_launches[1]}")
    require(capture_launches == (15, 15), capture_launches)
    check_capture(rsim, RECORD_MAX_SPEED_COLOR, "1M bar_galaxy")
    print(f"    synchronising calls in a plain frame (3 steps and the "
          f"capture): {len(plain_syncs)} {plain_syncs[:3]}; in the frame of "
          f"a rebuild: {len(rebuild_syncs)} (the build sizes its outputs "
          f"on the host)")
    require(not plain_syncs and rebuilt == 1, (plain_syncs, rebuilt))
    print(f"    1M bar_galaxy in this process, median of 6 frames: "
          f"{statistics.median(serial) * 1e3:.3f} ms a frame written before "
          f"the next frame's steps, {statistics.median(overlapped) * 1e3:.3f}"
          f" ms overlapped with them (the recorder's way); the steps of a "
          f"frame alone {frame_step_ms:.3f} ms")
    del rsim, fo
    with tempfile.TemporaryDirectory(prefix=".smoke_rec_", dir=ROOT) as tmp:
        rec_root = Path(tmp)
        frame_ms = run_recorder(["--preset", "bar_galaxy", "--bodies", "1m",
                                 "--frames", "10", "--name", "smoke_1m"],
                                rec_root)
        check_frame(rec_root / "smoke_1m", 9, N_MAIN)
        print(f"    1M bar_galaxy, {rsub} steps a frame: recorder "
              f"{frame_ms:.3f} ms a frame (median of 10) beside "
              f"{frame_step_ms:.3f} ms for a frame's steps alone (median of "
              f"6, in this process)")
        frame8k_ms = run_recorder(["--preset", "tiny_galaxy", "--bodies",
                                   "8k", "--frames", "30", "--name",
                                   "smoke_8k"], rec_root)
        check_frame(rec_root / "smoke_8k", 29, 8_000)
        play_back(rec_root, "smoke_8k", 30)
    done(t0)

    # ---- 7. boids kernel vs plain ----------------------------------------
    t0 = phase("7. boids window kernel vs plain, 500K Flock state; every T "
               "with the cull on and off")
    bcfg = BOIDS
    gsz, wg1 = bcfg.group_size, bcfg.window_groups
    wg2 = bcfg.pass2_window_groups or wg1
    psq = bcfg.perception_radius ** 2
    kw1 = dict(gsz=gsz, wg=wg1, perception_sq=psq,
               separation_sq=bcfg.separation_radius ** 2)
    kw2 = dict(kw1, wg=wg2, prev_wg=wg1)
    flock = Flock(num_boids=N_BOIDS, device="cuda")
    npad = flock.state.p21.numel()
    ng = npad // gsz
    pairs_ps = (window_pairs(ng, gsz, wg1), window_pairs(ng, gsz, wg2))
    pairs = sum(pairs_ps)
    b_prev = eval_tiles.has_parent(plib, "boids_window")
    instances = [(T, cull) for T in BOIDS_TARGETS for cull in (False, True)]
    print(f"    npad {npad} ({ng} groups of {gsz}); pairs a step: "
          f"{pairs_ps[0]:.4e} (pass 1, wg {wg1}) + {pairs_ps[1]:.4e} "
          f"(pass 2, wg {wg2}) = {pairs:.4e}; the wrapper's instance: "
          f"T={DEFAULT_TARGETS}, cull on")
    for T, cull in instances:
        for ps in (1, 2):
            blocks, regs, threads = boids_occupancy(gsz, T, cull, ps == 2)
            print(f"    T={T} cull {'on' if cull else 'off'} pass {ps}: "
                  f"{threads} threads a block, {regs} registers a thread, "
                  f"{blocks} blocks per SM resident = "
                  f"{ng / (blocks * sms):.2f} waves over {ng} groups")
    for label, steps in (("initial state", 0), ("after 48 steps", 48)):
        for _ in range(steps):
            flock.update(BOIDS_DT)
        ms = plain_ms = nb_pairs = abs_err = rel_err = 0.0
        sweep = {k: [0.0, 0, 0.0] for k in instances}  # ms, tested, issue
        prev = [0.0, 0.0]
        for ps, args, kw in zip((1, 2), boids_pass_inputs(flock.state, bcfg),
                                (kw1, kw2)):
            full = boids_window_accumulate(*args, **kw)
            want = bo.window_accumulate_reference(*args, **kw)
            torch.cuda.synchronize()
            got, want = full[:, :N_BOIDS], want[:, :N_BOIDS]
            errs = []
            for r, nm in zip(range(0, 12, 3), ("sep", "align", "coh",
                                               "csum")):
                d = float((got[r:r + 3] - want[r:r + 3]).abs().max())
                ref = float(want[r:r + 3].abs().max())
                errs.append(f"{nm} {d / ref:.3e}")
                require(d <= TOL_BOIDS * ref,
                        f"boids pass {ps} {nm}: {d} vs max {ref}")
                rel_err = max(rel_err, d / ref)
            abs_err = max(abs_err, float((got - want).abs().max()))
            differ = float((got[12:] != want[12:]).any(0).float().mean())
            require(differ <= TOL_BOIDS_COUNTS,
                    f"boids pass {ps}: counts differ for {differ:.3e}")
            nb = float(want[13].sum())
            nb_pairs += nb
            k_ms = cuda_ms(lambda: boids_window_accumulate(*args, **kw), 20)
            if steps == 0 and ps == 1:
                ENQUEUE_US["boids_window"] = enqueue_us(
                    lambda: boids_window_accumulate(*args, **kw), 20)
            p_ms = cuda_ms(lambda: bo.window_accumulate_reference(
                *args, **kw), 10)
            ms, plain_ms = ms + k_ms, plain_ms + p_ms
            print(f"    {label}, pass {ps}: max|d|/max|ref| {', '.join(errs)}"
                  f" (tol {TOL_BOIDS}); counts differ for {differ:.3e} of "
                  f"boids (tol {TOL_BOIDS_COUNTS}); neighbour pairs "
                  f"{int(nb)}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
            # Every instance against the previous kernel (or, without its
            # sources, the wrapper's), bit for bit; the previous kernel
            # timed before and after them.
            ref_rows, who = full, "the wrapper's instance"
            if b_prev:
                def previous():
                    return eval_tiles.parent_boids(plib, *args, **kw)
                ref_rows, who = previous(), "the previous kernel"
                torch.cuda.synchronize()
                require(torch.equal(full, ref_rows),
                        f"{label} pass {ps}: the wrapper differs from the "
                        f"previous kernel")
                prev[ps - 1] += cuda_ms(previous, 20) / 2
            for T, cull in instances:
                def launch(T=T, cull=cull):
                    return boids_window_launch(*args, targets=T, cull=cull,
                                               **kw)
                out = launch()
                if b_prev:
                    # The previous kernel at the same instance (npad in
                    # place of the modes' (ng, g0, ngs)).
                    ref_rows = eval_tiles.parent_boids(
                        plib, *args, targets=T, cull=cull, **kw)
                torch.cuda.synchronize()
                require(torch.equal(out, ref_rows),
                        f"{label} pass {ps} T={T} cull={cull}: differs from "
                        f"{who}")
                tested = pairs_ps[ps - 1]
                if cull:
                    tested = bo_kernel.chunk_cull_reference(
                        args[0], gsz=gsz, wg=kw["wg"], perception_sq=psq,
                        targets=T)["tested"]
                rec = bsass.get(f"boids T={T} cull {'on' if cull else 'off'}"
                                f" pass {ps}")
                issue = (None if rec is None else
                         tested * rec["pair"] + (pairs_ps[ps - 1] - tested)
                         * (rec["skipped"] or 0) / (32 * T))
                acc = sweep[(T, cull)]
                acc[0] += cuda_ms(launch, 20)
                acc[1] += tested
                acc[2] = None if issue is None or acc[2] is None else (
                    acc[2] + issue)
            if b_prev:
                prev[ps - 1] += cuda_ms(previous, 20) / 2
        # One step's work: both passes.  ~10 FP32 operations for a pair's
        # distance test, ~30 more for a neighbour pair; each pass reads
        # its 9-10 input rows once and writes its 14 rows once.
        ops = 10.0 * pairs + 30.0 * nb_pairs
        nbytes = 4 * npad * ((9 + 14) + (10 + 14))
        b_ms, b_by = bound(ops, nbytes)
        print(f"    {label}, both passes: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / ms:.1%} of it; kernel {pairs / ms / 1e6:.1f} "
              f"Gpairs/s; by the TPU kernel's cost model (40 flops a pair) "
              f"the bound is {40.0 * pairs / PEAK_FP32 * 1e3:.4f} ms")
        if b_prev:
            print(f"    {label}: previous kernel {prev[0]:.4f} + "
                  f"{prev[1]:.4f} = {sum(prev):.4f} ms (mean of before and "
                  f"after the instances); the wrapper's instance takes "
                  f"{ms / sum(prev):.3f}x its time")
        else:
            print(f"    {label}: previous kernel not measured (no sources in "
                  f"spatialsim_tpu_torch/_build/parent/); every instance "
                  f"held to the wrapper's bit for bit")
        for (T, cull), (i_ms, tested, issue) in sweep.items():
            t_ms = bound(10.0 * tested + 30.0 * nb_pairs, nbytes)[0]
            iss = ("not measured" if issue is None else
                   f"{issue / eval_tiles.ISSUE_RATE * 1e3:.4f} ms")
            print(f"    {label}: T={T} cull {'on ' if cull else 'off'} "
                  f"{i_ms:.4f} ms; skips {1 - tested / pairs:.4f} of the "
                  f"window pairs; bound {b_ms:.4f} ms ({b_ms / i_ms:.1%}), "
                  f"over the {tested:.4e} tested pairs {t_ms:.4f} ms "
                  f"({t_ms / i_ms:.1%}); issue-limited {iss}; equal bit for "
                  f"bit to {'the previous kernel' if b_prev else 'the wrapper'}"
                  f" in both passes, so its errors against the plain version "
                  f"are the wrapper's above")
        record_kernel(kernels, "boids_window", abs_err, rel_err, ms,
                      plain_ms, ops, nbytes)
    del flock, got, want, full, out, ref_rows
    torch.cuda.empty_cache()
    done(t0)

    # ---- 8. boids main path ----------------------------------------------
    t0 = phase("8. boids main path: Flock at 500K and 100K, default config")
    torch.cuda.synchronize()
    allpairs_accel.launches = 0
    window_eval_pool.launches = 0
    boids_window_accumulate.launches = 0
    interval = bcfg.resort_interval
    want_resorts = (BOIDS_STEPS - 1) // interval
    for n in (N_BOIDS, 100_000):
        torch.cuda.reset_peak_memory_stats()
        before = boids_window_accumulate.launches
        t = time.perf_counter()
        flock = Flock(num_boids=n, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        step_s = []
        for _ in range(BOIDS_STEPS):
            t = time.perf_counter()
            flock.update(BOIDS_DT)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
        launched = boids_window_accumulate.launches - before
        # Re-sorts run before steps interval+1, 2*interval+1, ... (1-based).
        resort = [s_ for k, s_ in enumerate(step_s)
                  if k >= interval and k % interval == 0]
        plain = [s_ for k, s_ in enumerate(step_s)
                 if not (k >= interval and k % interval == 0)]
        print(f"    Flock rate, {n // 1000}K boids, synchronised steps: "
              f"{BOIDS_STEPS / sum(step_s):.3f} steps/s ({BOIDS_STEPS} steps "
              f"in {sum(step_s):.4f} s, re-sorts included)")
        print(f"    N={n}: init {init_s:.3f} s; median step "
              f"{float(np.median(step_s)) * 1e3:.4f} ms; median plain step "
              f"{float(np.median(plain)) * 1e3:.4f} ms; median re-sort step "
              f"{float(np.median(resort)) * 1e3:.4f} ms ({len(resort)} "
              f"re-sort steps); kernel launches {launched}; re-sorts "
              f"{flock.resorts}; peak device memory GB "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
        require(flock.neighbor_mode == "window", flock.neighbor_mode)
        require(launched == 2 * BOIDS_STEPS, f"launches {launched}")
        require(flock.resorts == want_resorts, f"re-sorts {flock.resorts}")
        for name in ("pos", "vel", "col"):
            t_ = getattr(flock.state, name)
            require(t_.shape == (3, n) and bool(torch.isfinite(t_).all()),
                    f"boids {name} finite, shape {tuple(t_.shape)}")
        if n == N_BOIDS:
            flock500 = flock
    grid = Flock(num_boids=20_000, device="cuda")
    before = boids_window_accumulate.launches
    for _ in range(10):
        grid.update(BOIDS_DT)
    torch.cuda.synchronize()
    require(grid.neighbor_mode == "grid", grid.neighbor_mode)
    require(boids_window_accumulate.launches == before, "grid launched")
    require(bool(torch.isfinite(grid.state.pos).all()), "grid state")
    print(f"    N=20000 grid mode: 10 steps, finite, no kernel launch")
    launches["boids_window"] = boids_window_accumulate.launches
    print(f"    launches in the boids main path: boids_window "
          f"{launches['boids_window']}, allpairs {allpairs_accel.launches},"
          f" window_eval_pool {window_eval_pool.launches}")
    require(launches["boids_window"] == 4 * BOIDS_STEPS, launches)
    del grid, flock
    # The same runs through the previous kernel (not counted).
    if eval_tiles.has_parent(plib, "boids_window"):
        kernel_fn = bo.boids_window_accumulate
        bo.boids_window_accumulate = functools.partial(
            eval_tiles.parent_boids, plib)
        try:
            for n in (N_BOIDS, 100_000):
                flock = Flock(num_boids=n, device="cuda")
                step_s = timed_steps(flock.update, BOIDS_STEPS, BOIDS_DT)
                print(f"    through the previous kernel: Flock rate, "
                      f"{n // 1000}K boids = {BOIDS_STEPS / sum(step_s):.3f} "
                      f"steps/s; median step "
                      f"{float(np.median(step_s)) * 1e3:.4f} ms")
                del flock
        finally:
            bo.boids_window_accumulate = kernel_fn
        require(boids_window_accumulate.launches == launches["boids_window"],
                "the previous kernel's runs launched the kernel")
    done(t0)

    # ---- 9. boids accuracy vs the exact grid ------------------------------
    t0 = phase("9. boids window vs exact grid, 500K after 96 steps")
    st = flock500.state
    gkw = dict(cell_size=bcfg.cell_size, grid_dim=bcfg.grid_dim,
               offset=bcfg.bounds + bcfg.cell_size)
    fkw = dict(perception_radius=bcfg.perception_radius,
               separation_radius=bcfg.separation_radius,
               separation_weight=bcfg.separation_weight,
               alignment_weight=bcfg.alignment_weight,
               cohesion_weight=bcfg.cohesion_weight,
               max_speed=bcfg.max_speed, max_force=bcfg.max_force)
    cell_cap = int(torch.bincount(bo.cell_index(st.pos, **gkw).long()).max())
    fw, cw, nw = bo.flocking_forces_window_frozen(
        st.pos, st.vel, st.col, st.p21, st.s21, group_size=gsz,
        window_groups=wg1, pass2_window_groups=bcfg.pass2_window_groups,
        second_pass=bcfg.second_pass, return_counts=True, **fkw)
    fe, ce, ne = bo.flocking_forces(
        st.pos, st.vel, st.col, cell_range=1, cell_capacity=cell_cap,
        return_counts=True, **gkw, **fkw)
    agree = float(torch.isclose(fw, fe, rtol=1e-5, atol=1e-4).all(0)
                  .float().mean())
    captured, exact = int(nw.sum()), int(ne.sum())
    # The same grid in float64 on the same float32 state: how far each
    # float32 path sits from the exact sums (reported, no limit).
    f64 = bo.flocking_forces(
        st.pos.double(), st.vel.double(), st.col.double(), cell_range=1,
        cell_capacity=cell_cap, **gkw, **fkw)[0]
    for name, f in (("window", fw), ("grid", fe)):
        share = float(torch.isclose(f.double(), f64, rtol=1e-5, atol=1e-4)
                      .all(0).float().mean())
        print(f"    {name} (float32) vs the float64 grid: forces agreeing "
              f"at atol 1e-4 for {share:.6f} of boids; max|d| "
              f"{float((f.double() - f64).abs().max()):.3e}")
    print(f"    steps since re-sort {st.steps_since}; largest cell occupancy "
          f"{cell_cap} (grid cell_capacity); forces agreeing at atol 1e-4: "
          f"{agree:.6f} of boids (limit 0.99); neighbour pairs window "
          f"{captured} / grid {exact} = {captured / exact:.6f} (limit 0.99)")
    require(bool((nw <= ne).all()), "window counted a pair twice")
    require(agree >= 0.99 and captured >= 0.99 * exact, (agree, captured))
    done(t0)

    # ---- 10. device profile ------------------------------------------------
    t0 = phase("10. where the device time goes (torch.profiler)")
    resorts = flock500.resorts
    profile_steps("boids 500K, 12 steps", lambda: flock500.update(BOIDS_DT),
                  12)
    print(f"      (re-sorts in the window: {flock500.resorts - resorts})")
    if eval_tiles.has_parent(plib, "boids_window"):
        kernel_fn = bo.boids_window_accumulate
        bo.boids_window_accumulate = functools.partial(
            eval_tiles.parent_boids, plib)
        try:
            profile_steps("boids 500K, 12 more steps through the previous "
                          "kernel", lambda: flock500.update(BOIDS_DT), 12)
        finally:
            bo.boids_window_accumulate = kernel_fn
    del flock500, st
    sim = NBodySimulation(num_bodies=N_MAIN, device="cuda")
    for _ in range(23):
        sim.update(DT)
    profile_steps("N-body 1M, steps 24-26 (one rebuild)",
                  lambda: sim.update(DT), 3, watch=REBUILD_WATCH)
    require(sim.rebuilds == 1, sim.rebuilds)
    profile_steps("N-body 1M, steps 27-46 (between rebuilds)",
                  lambda: sim.update(DT), 20)
    require(sim.rebuilds == 1, sim.rebuilds)
    del sim
    torch.cuda.empty_cache()
    done(t0)

    # ---- 11. dense kernel vs plain ------------------------------------------
    t0 = phase("11. dense window-eval kernel vs plain: 1M quadrupole, 1M "
               "dense, near table, 50M sampled groups")
    ekw = dict(G=cal.G, softening=cal.softening, group_size=cal.group_size,
               window_groups=cal.window_groups,
               tau_clamp=float(cal.advance_tau_clamp))
    pos, vel, mass = galaxy(N_MAIN, 0, dev)

    # (1) The quadrupole main path's lists (R = 16), rebuilt with real
    # accelerations so the acc rows are live, as phase 3 does.
    qcal = bw.calibrate_config(
        resolve_config(NBODY.replace(num_bodies=N_MAIN, use_quadrupole=True),
                       N_MAIN), pos, vel, mass)
    st = bw.init_window_state(pos, vel, mass, qcal)
    acc = bw.eval_accel_sorted(st.lists, st.pos, st.mass, DT, **ekw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    qlists = rebuilt_lists(bw, st, qcal, acc)
    torch.cuda.synchronize()
    print(f"    1M quadrupole: list build seconds "
          f"{time.perf_counter() - t:.3f}  far {tuple(qlists.far.shape)}  "
          f"far_n mean {float(qlists.far_n.float().mean()):.1f} max "
          f"{int(qlists.far_n.max())}")
    s_pos, s_mass = eval_ab.sorted_inputs(qlists, pos, mass)
    tiles = dict(plib=plib, sass=sass, sass_old=sass_old)
    for ss in (0, 23):
        check_dense(kernels, f"1M quadrupole R=16, steps_since={ss}",
                    qlists, s_pos, s_mass, None, ss, ekw,
                    tiles=tiles if ss else None)
    del st, acc, qlists

    # (2) The 1M galaxy's calibrated config with the pool off and ranges
    # emission (R = 10): the 50M path's build and eval code at 1M.  The
    # pooled lists from the same state and accelerations are kept for
    # phase 12 (a).
    dcal = cal.replace(pool_tile=0, traversal_emit="ranges")
    st = bw.init_window_state(pos, vel, mass, cal)
    acc = bw.eval_accel_sorted(st.lists, st.pos, st.mass, DT, **ekw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dlists = rebuilt_lists(bw, st, dcal, acc)
    torch.cuda.synchronize()
    print(f"    1M dense (ranges): list build seconds "
          f"{time.perf_counter() - t:.3f}  far {tuple(dlists.far.shape)}")
    plists = rebuilt_lists(bw, st, cal, acc)
    del st, acc
    s_pos, s_mass = eval_ab.sorted_inputs(dlists, pos, mass)
    check_dense(kernels, "1M dense R=10, steps_since=23", dlists, s_pos,
                s_mass, None, 23, ekw, tiles=tiles)
    # Phase 23 (a) holds the ablation instances to these lists and the
    # default instance to this output, kept on the host until then.
    kept_11 = dict(
        ekw=ekw, steps_since=23, s_pos=s_pos.cpu(), s_mass=s_mass.cpu(),
        far=dlists.far.cpu(), far_n=dlists.far_n.cpu(),
        out=window_eval(s_pos, s_mass, dlists.far, dlists.far_n, None, 23,
                        DT, **ekw).cpu())

    # (3) The same lists with a seeded near table: K = 4 ids outside each
    # window, ~10% of slots empty (-1).
    ng = dlists.far_n.shape[0]
    wg = cal.window_groups
    rng = np.random.default_rng(11)
    near = (np.arange(ng)[:, None]
            + rng.integers(wg + 1, ng - wg, (ng, 4))) % ng
    near[rng.random((ng, 4)) < 0.1] = -1
    near = torch.as_tensor(near, dtype=torch.int32, device=dev)
    check_dense(kernels, "1M dense R=10 + near K=4, steps_since=23",
                dlists, s_pos, s_mass, near, 23, ekw, tiles=tiles)
    del near

    # (4) The 50M EXTREME preset: its simulation is built here (phase 13
    # steps it) and the kernel is held to the plain version on 512 seeded
    # groups, the first and the last among them.
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # the 1M lists of (2)
    cfg50 = config_from_preset(get_preset_config(PRESET_50M))
    t = time.perf_counter()
    sim50 = NBodySimulation(config=cfg50, device="cuda")
    torch.cuda.synchronize()
    print(f"    {PRESET_50M}: NBodySimulation seconds "
          f"{time.perf_counter() - t:.3f}; "
          + ", ".join(f"{k} {v:.3f} s"
                      for k, v in sim50.setup_seconds.items()))
    print(f"    resolved: depth {sim50.config.max_depth}, group "
          f"{sim50.config.group_size}, list cap {sim50.config.list_capacity},"
          f" advance order {sim50.config.advance_order}, pool_tile "
          f"{sim50.config.pool_tile}, emit {sim50.config.traversal_emit!r}, "
          f"tree_caps {sim50.config.tree_caps}, wl_caps "
          f"{sim50.config.wl_caps}")
    l50 = sim50.state.lists
    require(sim50.engine == "window" and l50.pool is None
            and tuple(l50.far.shape) == (48_829, 8, 2048),
            f"50M dense lists {tuple(l50.far.shape)}")
    print(f"    far {tuple(l50.far.shape)}  far_n mean "
          f"{float(l50.far_n.float().mean()):.1f} max {int(l50.far_n.max())}"
          f"  groups at the list cap "
          f"{int((l50.far_n >= l50.far.shape[2]).sum())}"
          f"  peak device memory GB of the set-up "
          f"{(torch.cuda.max_memory_allocated() - held) / 1e9:.3f}")
    ng50 = l50.far_n.shape[0]
    groups = torch.as_tensor(np.sort(np.concatenate([
        [0, ng50 - 1], np.random.default_rng(5).choice(
            np.arange(1, ng50 - 1), 510, replace=False)])), device=dev)
    s_pos, s_mass = padded_sorted(sim50.state)
    kw50 = bw._eval_kw(sim50.config)
    for ss in (0, 23):
        check_dense(kernels, f"50M R=8 on 512 groups, steps_since={ss}",
                    l50, s_pos, s_mass, None, ss, kw50, groups=groups,
                    tiles=tiles if ss else None)
    del s_pos, s_mass, l50
    done(t0)

    # ---- 12. the dense path at 1M ------------------------------------------
    t0 = phase("12. the dense path at 1M: dense vs pooled lists, the "
               "quadrupole main path, quadrupole accuracy")
    # (a) Dense vs pooled lists of one calibrated config.
    require(torch.equal(plists.order, dlists.order), "orders differ")
    same = int((plists.far_n == dlists.far_n).sum())
    print(f"    far_n equal in {same} of {ng} groups")
    require(same == ng, f"far_n differs in {ng - same} groups")
    s_pos, s_mass = eval_ab.sorted_inputs(dlists, pos, mass)
    for ss in (0, 23):
        a_pool = window_eval_pool(s_pos, s_mass, plists.pool, plists.pstart,
                                  plists.far_n, ss, DT, **ekw)
        a_dense = window_eval(s_pos, s_mass, dlists.far, dlists.far_n, None,
                              ss, DT, **ekw)
        torch.cuda.synchronize()
        abs_err, err = kernel_errors(a_dense, a_pool)
        print(f"    steps_since={ss}: dense vs pooled max|da| = "
              f"{abs_err:.3e}, max|da|/max|a| = {err:.3e} "
              f"(tol {TOL_WINDOW})")
        require(err <= TOL_WINDOW, f"dense vs pooled {err}")
    del plists, dlists, s_pos, s_mass, a_pool, a_dense

    # (b) The quadrupole main path, every kernel launch counted from zero.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # the 50M simulation, mostly
    for fn in (allpairs_accel, window_eval_pool, window_eval,
               boids_window_accumulate):
        fn.launches = 0
    qsim = NBodySimulation(num_bodies=N_MAIN,
                           config=NBODY.replace(use_quadrupole=True),
                           device="cuda")
    torch.cuda.synchronize()
    print("    init: " + ", ".join(f"{k} {v:.3f} s"
                                   for k, v in qsim.setup_seconds.items()))
    step_s = timed_steps(qsim.update, STEPS, DT)
    quad_launches = window_eval.launches
    print(f"    launches in the quadrupole main path: window_eval "
          f"{quad_launches}, window_eval_pool {window_eval_pool.launches}")
    report_steps("1M quadrupole", step_s)
    require(qsim.engine == "window" and qsim.state.lists.pool is None
            and qsim.state.lists.far.shape[1] == 16, "quadrupole layout")
    require(quad_launches == STEPS and window_eval_pool.launches == 0,
            (quad_launches, window_eval_pool.launches))
    require(qsim.rebuilds == 1, f"rebuilds {qsim.rebuilds}")
    for name, t_ in (("pos", qsim.state.pos), ("vel", qsim.state.vel)):
        require(t_.shape == (3, N_MAIN) and bool(torch.isfinite(t_).all()),
                f"quadrupole {name} finite, shape {tuple(t_.shape)}")
    print(f"    peak device memory GB above the {held / 1e9:.3f} GB held "
          f"before: {(torch.cuda.max_memory_allocated() - held) / 1e9:.3f}")
    del qsim

    # (c) Phase 5's protocol (5 warm-up steps at interval 4 so the lists
    # carry real cell accelerations), then fresh quadrupole and monopole
    # lists of the same state against a direct sum.
    st = warmed_state(pos, vel, mass, qcal)
    pos_o, vel_o, mass_o = original_order(st)
    exact = exact_accel_at(pos_o[:, idx], pos_o, mass_o, cal.G, cal.softening)
    errs = {}
    for label, c in (("quadrupole", qcal), ("monopole", cal)):
        fl = bw.build_lists(pos_o, vel_o, mass_o, **bw._build_kw(c))
        errs[label] = force_errors(
            bw.eval_accel(fl, pos_o, mass_o, 0.0, **ekw)[:, idx], exact)
        rms, med, ratio = errs[label]
        layout = "pooled" if fl.pool is not None else "dense"
        print(f"    fresh {label} lists ({layout}): rms of |da|/|a| "
              f"{rms:.4%}  median {med:.4%}  rms|da|/rms|a| {ratio:.4%}")
        del fl
    q_rms, q_med, _ = errs["quadrupole"]
    m_med = errs["monopole"][1]
    print(f"    median ratio quadrupole / monopole {q_med / m_med:.4f} "
          f"(limit 0.55); quadrupole fresh rms limit 5%")
    require(q_med <= 0.55 * m_med and q_rms <= 0.05, errs)
    del st, pos_o, vel_o, mass_o, exact, pos, vel, mass
    torch.cuda.empty_cache()
    done(t0)

    # ---- 13. 50M, the EXTREME preset ---------------------------------------
    t0 = phase(f"13. 50M bodies: {PRESET_50M} through NBodySimulation")
    preset = get_preset_config(PRESET_50M)
    dt50 = float(preset["dt_per_frame"]) / int(preset["substeps"])
    n50 = sim50.num_bodies
    print(f"    set-up: " + ", ".join(f"{k} {v:.3f} s"
                                      for k, v in sim50.setup_seconds.items()))
    require_mass_conserved(sim50.state, sim50.config, "first build")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (allpairs_accel, window_eval_pool, window_eval,
               boids_window_accumulate):
        fn.launches = 0
    step_s = timed_steps(sim50.step_raw, STEPS_50M, dt50)
    launches_50m = window_eval.launches
    print(f"    launches in the 50M main path: window_eval {launches_50m}, "
          f"window_eval_pool {window_eval_pool.launches}")
    step50_ms = report_steps(f"50M at the preset's dt {dt50}", step_s)
    print(f"    peak device memory GB over the steps: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.3f}")
    require(launches_50m == STEPS_50M and window_eval_pool.launches == 0,
            (launches_50m, window_eval_pool.launches))
    require(sim50.rebuilds == 1, f"rebuilds {sim50.rebuilds}")
    for name, t_ in (("pos", sim50.state.pos), ("vel", sim50.state.vel)):
        require(t_.shape == (3, n50) and bool(torch.isfinite(t_).all()),
                f"50M {name} finite, shape {tuple(t_.shape)}")
    require_mass_conserved(sim50.state, sim50.config, "rebuild at step 25")
    # The eval kernel on the run's own lists: the table's T beside the
    # previous kernel (held to the plain version in phase 11).
    l50 = sim50.state.lists
    s_pos, s_mass = padded_sorted(sim50.state)
    args50 = (s_pos, s_mass, l50.far, l50.far_n, None, l50.steps_since,
              dt50)
    win, far, nbytes = dense_work(l50, sim50.config.group_size,
                                  kw50["window_groups"], None)
    gsz50, t50 = sim50.config.group_size, tile_targets(
        sim50.config.group_size, 8)
    report_tiles(
        f"50M R=8, the run's lists at steps_since={l50.steps_since}",
        lambda T, order: dense_launch(*args50, targets=T, order=order,
                                      **kw50),
        None if not eval_tiles.has_parent(plib, "window_eval")
        else lambda: eval_tiles.parent_dense(plib, *args50, **kw50),
        None, (t50,), t50, win + far, bound(18.0 * (win + far), nbytes)[0],
        l50.far_n.shape[0],
        lambda T: occupancy(gsz50, T, 8, kw50["window_groups"], 0),
        sass.get(f"dense R=8 T={t50}"),
        sass_old.get("dense R=8 (previous, <=1024 threads)"),
        order=heavy_first(l50.far_n))
    del l50, s_pos, s_mass, args50

    # Force error on 4,096 bodies: the run's own lists, and fresh lists of
    # the same state (no staleness: what theta 1.5 and list cap 2048 give).
    st = sim50.state
    pos_o, vel_o, mass_o = original_order(st)
    idx50 = torch.as_tensor(np.sort(np.random.default_rng(1).choice(
        n50, N_SAMPLE, replace=False)), device=dev)
    t = time.perf_counter()
    exact = exact_accel_at(pos_o[:, idx50], pos_o, mass_o, sim50.config.G,
                           sim50.config.softening)
    torch.cuda.synchronize()
    print(f"    direct sum on {N_SAMPLE} bodies (the oracle): "
          f"{time.perf_counter() - t:.3f} s")
    fresh = bw.build_lists(pos_o, vel_o, mass_o,
                           **bw._build_kw(sim50.config))
    for label, lists, dt_ in (
            (f"lists {st.lists.steps_since} steps old", st.lists, dt50),
            ("fresh lists", fresh, 0.0)):
        rms, med, ratio = force_errors(
            bw.eval_accel(lists, pos_o, mass_o, dt_, **kw50)[:, idx50],
            exact)
        print(f"    force error, {label}: rms of |da|/|a| {rms:.4%}  "
              f"median {med:.4%}  rms|da|/rms|a| {ratio:.4%}")
        require(np.isfinite([rms, med, ratio]).all(), (rms, med, ratio))
    del st, pos_o, vel_o, mass_o, exact, fresh

    # Where the device time goes: the next rebuild step, then 4 plain steps.
    for _ in range(sim50.config.rebuild_interval - 2):
        sim50.step_raw(dt50)
    require(sim50.state.lists.steps_build
            == sim50.config.rebuild_interval, sim50.state.lists.steps_build)
    profile_steps("N-body 50M, the rebuild step",
                  lambda: sim50.step_raw(dt50), 1, watch=REBUILD_WATCH)
    profile_steps("N-body 50M, 4 steps between rebuilds",
                  lambda: sim50.step_raw(dt50), 4)
    require(sim50.rebuilds == 2, sim50.rebuilds)
    del sim50
    torch.cuda.empty_cache()

    # The recorder CLI: 2 frames, staged in a directory removed after.
    with tempfile.TemporaryDirectory(prefix=".smoke_rec_", dir=ROOT) as tmp:
        rec_root = Path(tmp)
        frame_ms = run_recorder(["--preset", PRESET_50M, "--frames", "3",
                                 "--name", "smoke_50m"], rec_root)
        check_frame(rec_root / "smoke_50m", 2, n50)
        print(f"    50M: recorder {frame_ms:.3f} ms a frame (median of 3; one "
              f"step a frame) beside the median step {step50_ms:.3f} ms")
    done(t0)

    counted = (allpairs_accel, window_eval_pool, window_eval,
               window_eval_cols, window_eval_mxu, boids_window_accumulate)

    def zero_counts():
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0

    def counts():
        return {fn.__name__: fn.launches for fn in counted if fn.launches}

    pos, vel, mass = galaxy(N_MAIN, 0, dev)

    # ---- 14. near groups --------------------------------------------------
    t0 = phase("14. near groups: NBodySimulation at 1M with near_groups=8")
    zero_counts()
    t = time.perf_counter()
    nsim = NBodySimulation(num_bodies=N_MAIN,
                           config=NBODY.replace(near_groups=8),
                           device="cuda")
    torch.cuda.synchronize()
    print(f"    init seconds {time.perf_counter() - t:.3f}: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in nsim.setup_seconds.items()))
    nl = nsim.state.lists
    ng = nl.far_n.shape[0]
    require(nl.pool is None and nl.far.shape[1] == 10
            and tuple(nl.near.shape) == (ng, 8), "near-group layout")
    print(f"    far {tuple(nl.far.shape)}  near {tuple(nl.near.shape)}, "
          f"{float((nl.near >= 0).float().mean()):.4f} of the slots filled")
    require_mass_conserved(nsim.state, nsim.config, "K=8, first build")
    step_s = timed_steps(nsim.update, STEPS, DT)
    near_launches = window_eval.launches
    print(f"    launches in the near-group main path: {counts()}")
    report_steps("1M near groups K=8", step_s)
    print(f"    (the pooled K=0 main path, phase 4: median step "
          f"{plain_step * 1e3:.3f} ms, rebuild step "
          f"{rebuild_step * 1e3:.3f} ms)")
    require(near_launches == STEPS and window_eval_pool.launches == 0,
            counts())
    require(nsim.rebuilds == 1, f"rebuilds {nsim.rebuilds}")
    for name, t_ in (("pos", nsim.state.pos), ("vel", nsim.state.vel)):
        require(t_.shape == (3, N_MAIN) and bool(torch.isfinite(t_).all()),
                f"near-group {name} finite, shape {tuple(t_.shape)}")
    require_mass_conserved(nsim.state, nsim.config, "K=8, rebuild at step 25")
    del nsim, nl

    # Phase 5's protocol: fresh K=0 and K=8 lists of one warmed state (the
    # JAX bar, tests/test_bh_window.py:359), then each configuration's own
    # lists aged to tau=23 (reported).
    cal8 = cal.replace(near_groups=8)
    st = warmed_state(pos, vel, mass, cal)
    pos_o, vel_o, mass_o = original_order(st)
    exact = exact_accel_at(pos_o[:, idx], pos_o, mass_o, cal.G, cal.softening)
    fresh = {}
    for label, c in (("K=0", cal), ("K=8", cal8)):
        kw = dict(bw._build_kw(c), pool_tile=0)
        fl = bw.build_lists(pos_o, vel_o, mass_o, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fl = bw.build_lists(pos_o, vel_o, mass_o, **kw)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t) * 1e3
        fresh[label] = force_errors(
            bw.eval_accel(fl, pos_o, mass_o, 0.0, **ekw)[:, idx], exact)
        rms, med, ratio = fresh[label]
        print(f"    fresh {label} dense lists: build {build_ms:.3f} ms, far_n "
              f"mean {float(fl.far_n.float().mean()):.1f}; rms of |da|/|a| "
              f"{rms:.4%}  median {med:.4%}  rms|da|/rms|a| {ratio:.4%}")
        del fl
    for label, c in (("K=0", cal), ("K=8", cal8)):
        st = warmed_state(pos, vel, mass, c)
        st = bw.make_window_step(c.replace(rebuild_interval=10 ** 6), N_MAIN,
                                 substeps=22)(st, DT)
        require(st.lists.steps_since == 23, st.lists.steps_since)
        p_o, _, m_o = original_order(st)
        ex = exact_accel_at(p_o[:, idx], p_o, m_o, cal.G, cal.softening)
        rms, med, ratio = force_errors(
            bw.eval_accel(st.lists, p_o, m_o, DT, **ekw)[:, idx], ex)
        print(f"    {label} lists 23 steps old: rms of |da|/|a| {rms:.4%}  "
              f"median {med:.4%}  rms|da|/rms|a| {ratio:.4%}")
    m0, m8 = fresh["K=0"][1], fresh["K=8"][1]
    print(f"    median ratio K=8 / K=0 (fresh) {m8 / m0:.4f} (limit 1.05)")
    require(m8 <= 1.05 * m0 + 1e-5, fresh)
    del st, exact, ex
    done(t0)

    # ---- 15. moment refresh -----------------------------------------------
    t0 = phase("15. moment refresh: the pooled 1M with refresh_interval=12")
    zero_counts()
    rsim = NBodySimulation(num_bodies=N_MAIN,
                           config=NBODY.replace(refresh_interval=12),
                           device="cuda")
    step_s = timed_steps(rsim.update, STEPS, DT)
    refresh_launches = window_eval_pool.launches
    print(f"    launches: {counts()}; refreshes {rsim.refreshes}, rebuilds "
          f"{rsim.rebuilds}")
    # Refreshes run before steps 13 and 37, the rebuild before step 25.
    kinds = {12: "refresh", 36: "refresh", 24: "rebuild"}
    plain = sorted(s_ for k, s_ in enumerate(step_s) if k not in kinds)
    print(f"    median plain step {plain[len(plain) // 2] * 1e3:.3f} ms; "
          + "; ".join(f"{kinds[k]} step {k + 1} {step_s[k] * 1e3:.3f} ms"
                      for k in sorted(kinds))
          + f"; {STEPS} steps in {sum(step_s):.3f} s")
    require(rsim.refreshes == 2 and rsim.rebuilds == 1,
            (rsim.refreshes, rsim.rebuilds))
    require(refresh_launches == STEPS and window_eval.launches == 0,
            counts())
    require(bool(torch.isfinite(rsim.state.pos).all()), "refresh state")
    del rsim
    # Phase 5's protocol at tau=23, with and without refreshes between.
    aged = {}
    for riv in (0, 12):
        c = cal.replace(refresh_interval=riv)
        st = warmed_state(pos, vel, mass, c)
        step22 = bw.make_window_step(c.replace(rebuild_interval=10 ** 6),
                                     N_MAIN, substeps=22)
        st = step22(st, DT)
        p_o, _, m_o = original_order(st)
        ex = exact_accel_at(p_o[:, idx], p_o, m_o, cal.G, cal.softening)
        aged[riv] = force_errors(
            bw.eval_accel(st.lists, p_o, m_o, DT, **ekw)[:, idx], ex)
        rms, med, ratio = aged[riv]
        print(f"    refresh_interval={riv}: {step22.refreshes} refreshes, "
              f"lists {st.lists.steps_build} steps from their build, "
              f"{st.lists.steps_since} from the last refresh: rms of |da|/|a| "
              f"{rms:.4%}  median {med:.4%}  rms|da|/rms|a| {ratio:.4%}")
    require(aged[12][1] <= aged[0][1] + 1e-6, aged)
    del st, ex
    done(t0)

    # ---- 16. pooled finishes ----------------------------------------------
    t0 = phase("16. pooled finishes at 1M: cell-id, ranges, values + "
               "build_pool")
    st = bw.init_window_state(pos, vel, mass, cal)
    acc = bw.eval_accel_sorted(st.lists, st.pos, st.mass, DT, **ekw)
    finishes = {}
    for mode in ("cellid", "ranges", "values"):
        c = cal.replace(traversal_emit=mode)
        best = float("inf")
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lists = rebuilt_lists(bw, st, c, acc)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        finishes[mode] = lists
        print(f"    {mode}: rebuild {best * 1e3:.3f} ms (faster of 2)  pool "
              f"{tuple(lists.pool.shape)}  far_n mean "
              f"{float(lists.far_n.float().mean()):.1f}")
    ref = finishes["cellid"]
    s_pos, s_mass = eval_ab.sorted_inputs(ref, pos, mass)
    for mode in ("ranges", "values"):
        lists = finishes[mode]
        same = int((lists.far_n == ref.far_n).sum())
        require(torch.equal(lists.order, ref.order) and same == ng,
                f"{mode}: far_n equal in {same} of {ng} groups")
        for ss in (0, 23):
            a_ref = window_eval_pool(s_pos, s_mass, ref.pool, ref.pstart,
                                     ref.far_n, ss, DT, **ekw)
            a = window_eval_pool(s_pos, s_mass, lists.pool, lists.pstart,
                                 lists.far_n, ss, DT, **ekw)
            torch.cuda.synchronize()
            abs_err, err = kernel_errors(a, a_ref)
            print(f"    {mode} vs cell-id, steps_since={ss}: far_n equal in "
                  f"{same} of {ng} groups; max|da| {abs_err:.3e}, "
                  f"max|da|/max|a| {err:.3e} (tol {TOL_WINDOW})")
            require(err <= TOL_WINDOW, f"{mode} finish: {err}")
    del st, acc, finishes, ref, lists, s_pos, s_mass, a, a_ref
    torch.cuda.empty_cache()
    done(t0)

    # ---- 17. the eval forms -------------------------------------------------
    t0 = phase("17. the dense eval's row, column and matrix forms: "
               "tools/eval_ab.py at 1M")
    zero_counts()
    ab = eval_ab.run(N_MAIN, near_groups=8, reps=5, device="cuda",
                     out=lambda s: print("    " + s))
    ab_launches = counts()
    print(f"    launches in the A/B run: {ab_launches}")
    require(window_eval_cols.launches > 0 and window_eval_mxu.launches > 0,
            ab_launches)
    acfg = ab["cfg"]
    # Each kernel's time is the A/B's (steps_since 0); the checks below run
    # the kernel once more against its plain version at steps_since 23.
    for K, lists in ab["lists"].items():
        s_pos, s_mass = eval_ab.sorted_inputs(lists, ab["pos"], ab["mass"])
        outs = {}
        for form in eval_ab.FORMS:
            got = eval_ab.run_form(form, lists, s_pos, s_mass, acfg, 23)
            want = eval_ab.run_form(form, lists, s_pos, s_mass, acfg, 23,
                                    plain=True)
            torch.cuda.synchronize()
            abs_err, err = kernel_errors(got, want)
            ms = ab["eval_ms"][(K, form)]
            plain_ms = cuda_ms(lambda: eval_ab.run_form(
                form, lists, s_pos, s_mass, acfg, 23, plain=True), 1)
            pairs, ops, nbytes = eval_ab.form_work(form, lists, acfg)
            b_ms, b_by = bound(ops, nbytes)
            print(f"    K={K} {form}: max|da| {abs_err:.3e}, max|da|/max|a| "
                  f"{err:.3e} (tol {TOL_WINDOW}); kernel {ms:.4f} ms for "
                  f"{pairs:.4e} pairs = {pairs / ms / 1e6:.1f} Gpairs/s "
                  f"({eval_ab.OPS_PER_PAIR[form]:.0f} FP32 operations a "
                  f"pair); bound {b_ms:.4f} ms ({b_by}); plain "
                  f"{plain_ms:.4f} ms")
            require(err <= TOL_WINDOW, f"K={K} {form}: {err}")
            name = "window_eval" if form == "row" else f"window_eval_{form}"
            record_kernel(kernels, name, abs_err, err, ms, plain_ms, ops,
                          nbytes)
            outs[form] = got
            if form == "cols":
                want_cols, b_cols = want, b_ms
            if form == "mxu":
                want_mxu, b_mxu = want, b_ms
        _, d_mxu = kernel_errors(outs["mxu"], outs["row"])
        _, d_cols = kernel_errors(outs["cols"], outs["row"])
        print(f"    K={K}: the matrix form differs from the row form by "
              f"{d_mxu:.3e} of max|a| (report; fails above 1e-3), the column "
              f"form by {d_cols:.3e}")
        require(d_mxu <= 1e-3, f"K={K}: mxu vs row {d_mxu}")
        # Kernel 3b: every instance (T, group order or heavy-first) against
        # the plain version at steps_since 23, beside the previous kernel.
        args = (s_pos, s_mass, lists.far, lists.far_n, lists.near, 23, DT)
        ckw = dict(eval_ab.eval_kw(acfg), far_tile=acfg.eval_far_tile)
        ng, R, L = lists.far.shape
        tiles = (L, min(acfg.eval_far_tile, L))
        slots = int(_tile_counts(lists.far_n, *tiles).sum())
        gsz = acfg.group_size
        win_pairs = (eval_ab.form_work("cols", lists, acfg)[0]
                     - int(lists.far_n.long().clamp(0, L).sum()) * gsz)
        tile_pairs = win_pairs + slots * gsz
        print(f"    K={K} cols: {tile_pairs:.4e} pairs over whole far tiles "
              f"(the kernel's work; the bound counts the live entries)")
        t_plan, heavy_plan = cols_plan(gsz)
        K_near = 0 if lists.near is None else lists.near.shape[1]
        report_tiles(
            f"K={K} cols, steps_since=23",
            lambda T, order: cols_launch(*args, targets=T, order=order,
                                         **ckw),
            (None if not eval_tiles.has_parent(plib, "window_eval_cols")
             else lambda: eval_tiles.parent_cols(plib, *args, **ckw)),
            want_cols, (1, 2, 4), t_plan, tile_pairs, b_cols, ng,
            lambda T: occupancy(gsz, T, R, acfg.window_groups, K_near,
                                cols=True),
            sass.get(f"cols R={R} T={t_plan}"),
            sass_old.get(f"cols R={R} (previous, <=256 threads)"),
            order=heavy_first(lists.far_n, lists.near, gsz, tiles),
            chosen_order=heavy_plan,
            sass_of=lambda T: sass.get(f"cols R={R} T={T}"),
            regs_of=lambda T: ptxas.get(f"cols R={R} T={T}"))
        # Kernel 3c: every instance -- the register tile at T 1, 2, 4 and
        # the tensor-core contraction at M 2, 4, in group order and
        # heavy-first (equal bit for bit) -- against the plain version at
        # steps_since 0 (here) and 23 (report_tiles), beside the previous
        # kernel, with the share of the bound and of the MUFU floor.
        insts = [(c, n) for c, ns in MXU_CONTRACTIONS.items() for n in ns]
        plan = mxu_plan(gsz)
        mxu_order = heavy_first(lists.far_n, lists.near, gsz, tiles)

        def mxu_name(inst):
            return f"{inst[0]} {'T' if inst[0] == 'fma' else 'M'}={inst[1]}"

        def mxu_label(inst):
            return f"mxu R={R} {mxu_name(inst)}"

        def mxu_run(inst, order, steps=23):
            return mxu_launch(s_pos, s_mass, lists.far, lists.far_n,
                              lists.near, steps, DT, targets=inst[1],
                              order=order, contraction=inst[0], **ckw)
        want0 = eval_ab.run_form("mxu", lists, s_pos, s_mass, acfg, 0,
                                 plain=True)
        for inst in insts:
            for order in (None, mxu_order):
                got = mxu_run(inst, order, steps=0)
                torch.cuda.synchronize()
                err = kernel_errors(got, want0)[1]
                require(err <= TOL_WINDOW,
                        f"K={K} mxu {mxu_name(inst)} steps_since=0: {err}")
        print(f"    K={K} mxu: every instance within {TOL_WINDOW} of max|a| "
              f"of the plain version at steps_since 0, in both orders; "
              f"the plan {mxu_name(plan[:2])}"
              f"{' heavy-first' if plan[2] else ''}")
        report_tiles(
            f"K={K} mxu, steps_since=23", mxu_run,
            (None if not eval_tiles.has_parent(plib, "window_eval_mxu")
             else lambda: eval_tiles.parent_mxu(plib, *args, **ckw)),
            want_mxu, insts, plan[:2], tile_pairs, b_mxu, ng,
            lambda inst: mxu_occupancy(gsz, inst[0], inst[1], R,
                                       acfg.window_groups, K_near),
            sass.get(mxu_label(plan[:2])),
            sass_old.get(f"mxu R={R} (previous, <=256 threads)"),
            order=mxu_order, chosen_order=plan[2],
            sass_of=lambda inst: sass.get(mxu_label(inst)),
            regs_of=lambda inst: ptxas.get(mxu_label(inst)),
            key=mxu_name, floor_ms=tile_pairs / eval_tiles.MUFU_RATE * 1e3,
            hmma_of=lambda inst: hmma.get(mxu_label(inst)))
        if K == 0:
            for form in ("cols", "mxu"):
                ENQUEUE_US[f"window_eval_{form}"] = enqueue_us(
                    lambda: eval_ab.run_form(form, lists, s_pos, s_mass,
                                             acfg), 20)
    del ab, lists, s_pos, s_mass, outs, got, want, want_cols, want_mxu
    del want0, args
    torch.cuda.empty_cache()
    done(t0)

    # ---- 18. the exact engine -----------------------------------------------
    t0 = phase("18. the exact engine: NBodySimulation at 1M, engine='exact'")
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    esim = NBodySimulation(num_bodies=N_MAIN,
                           config=NBODY.replace(engine="exact"),
                           device="cuda")
    step_s = timed_steps(esim.update, 5, DT)
    print(f"    5 steps: "
          + ", ".join(f"{s_ * 1e3:.3f}" for s_ in step_s)
          + f" ms; median {sorted(step_s)[2] * 1e3:.3f} ms; launches "
            f"{counts()} (plain PyTorch ops); peak device memory GB "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    require(esim.engine == "exact" and not counts(), counts())
    st = esim.state
    require(bool(torch.isfinite(st.pos).all()), "exact engine state")
    t = time.perf_counter()
    exact = exact_accel_at(st.pos[:, idx], st.pos, st.mass, cal.G,
                           cal.softening)
    torch.cuda.synchronize()
    print(f"    the oracle's direct sum at {N_SAMPLE} of 1M bodies: "
          f"{time.perf_counter() - t:.3f} s")
    a_bh = barnes_hut_accel(st.pos, st.mass, esim.config)[:, idx]
    fl = bw.build_lists(st.pos, st.vel, st.mass, **bw._build_kw(cal))
    a_win = bw.eval_accel(fl, st.pos, st.mass, 0.0, **ekw)[:, idx]
    for label, a in (("exact engine", a_bh), ("window engine, fresh lists",
                                              a_win)):
        rms, med, ratio = force_errors(a, exact)
        print(f"    {label}: rms of |da|/|a| {rms:.4%}  median {med:.4%}  "
              f"rms|da|/rms|a| {ratio:.4%}")
        require(np.isfinite([rms, med, ratio]).all(), (label, rms))
    del esim, st, exact, a_bh, fl, a_win, pos, vel, mass
    torch.cuda.empty_cache()
    done(t0)

    # ---- 19. the traversal probes -------------------------------------------
    t0 = phase("19. traversal probes: tools/decide15.py and tools/decide18.py")
    require(not any(fn.launches for fn in tp.KERNELS),
            "a main path of phases 1-18 launched a probe kernel")
    # The octree's occupied cells: the past-L2 table.
    diag = decide15.octree_diagnostics(dev)
    octree_cells = sum(diag["cells_per_level"])
    print(f"    occupied octree cells of the 1M galaxy (all levels): "
          f"{octree_cells:,} = {octree_cells * 512 / 1e6:.1f} MB as 128-float "
          f"rows; worklist slots of a build (all levels): "
          f"{sum(diag['wl_sizes']):,}")
    torch.cuda.synchronize()
    # One-warp (one-thread) and card-wide instances.
    spread = (tp.row_reads, tp.block_read, tp.reduce_roundtrip, tp.row_write,
              tp.extract8, tp.scalar_load_dynsub, tp.scalar_load_dyn_dyn,
              tp.smem_table, tp.gated_reduce, tp.row_store,
              tp.iteration_core)
    print(f"    SM clock before the probes: {sm_clock()}")
    # Registers and spills of 6a's-6d's card-wide kernels and 5c's (phase
    # 1's build).
    for label, (regs, st, ld) in ptxas.items():
        if "_card_kernel" in label and ("probes_decide18" in label or
                                        "reduce_roundtrip" in label):
            print(f"    ptxas [{label.split('_cu_')[-1]}]: "
                  f"{regs} registers, spills {st} B stored, {ld} B loaded")
    for fn in tp.KERNELS:
        fn.launches = 0
    for fn in spread:
        fn.card_launches = 0

    def indent(s):
        print("    " + s)
    entries = (decide15.run("cuda", octree_cells=octree_cells, out=indent)
               + decide18.run("cuda", out=indent, octree_cells=octree_cells))
    print(f"    SM clock after the probes: {sm_clock()}")
    swept = decide15.sweep("cuda", octree_cells, out=indent)
    scalar_swept = decide15.scalar_sweep("cuda", octree_cells, out=indent)
    require(all(r["equal"] for r in swept + scalar_swept),
            [r for r in swept + scalar_swept if not r["equal"]])
    for label, rows in (("row-read w1", swept),
                        ("scalar load (dyn sub)", scalar_swept)):
        for chained in (False, True):
            for table in dict.fromkeys(r["table"] for r in rows):
                best = min((r for r in rows if r["table"] == table
                            and r["chained"] == chained),
                           key=lambda r: r["ms"])
                print(f"    sweep's fastest, {label} {table}"
                      f"{' chained' if chained else ''}: "
                      f"P={best['slices']}, {best['warps']} warps a block, "
                      f"{best['ms']:.4f} ms ({best['ns']:.3f} ns/read)")
    probe_launches = {fn.__name__: fn.launches for fn in tp.KERNELS}
    for fn in spread:
        probe_launches[fn.__name__] -= fn.card_launches
        probe_launches[fn.__name__ + "_card"] = fn.card_launches
    print(f"    launches in the probe runs (one-warp and card-wide "
          f"instances apart): {probe_launches}")
    require(all(probe_launches.values()), probe_launches)
    # A table past the opt-in limit is refused before any launch, by both
    # instances.
    limit = tp.smem_optin_bytes(dev)
    for kw in ({}, dict(spread="card", slices=decide15.CARD_SLICES)):
        try:
            tp.probe_smem_capacity(65536, where="shared", **kw)
            refused = None
        except ValueError as e:
            refused = str(e)
        require(refused is not None and tp.smem_table.launches
                == probe_launches["smem_table"] + probe_launches[
                    "smem_table_card"],
                f"where='shared' at 256 KB {kw} (opt-in limit {limit} B): "
                f"{refused}")
        print(f"    where='shared' at 256 KB {kw} raises before launch: "
              f"{refused}")
    check_probes(entries, probes)
    print("    (latency probes: one warp or thread of one SM, so each sits "
          "far above its bytes-or-operations bound by design; the "
          "card-wide instances read each row as often as the probe does, "
          "where the bound counts each distinct row once)")
    # 5c's, 6a's, 6b's and 6d's chains at one slice (6a's, 6b's and 6d's
    # redesigned) beside the one-warp or one-thread kernels on the same
    # inputs: the same output.
    chains = {e["label"]: e for e in entries if e["kernel"] in (
        tp.reduce_roundtrip, tp.smem_table, tp.gated_reduce,
        tp.iteration_core)}
    for label, e in chains.items():
        if e["grid"]:
            continue
        one = chains[f"{label} card P=1/1"]
        got, want = one["call"]().cpu(), e["call"]().cpu()
        require(torch.equal(got, want), (label, "one slice", got, want))
        print(f"    {label}: one slice {one['ns']:.2f} ns/{e['unit']}, the "
              f"one-warp kernel {e['ns']:.2f} ({one['ns'] / e['ns']:.3f}x), "
              f"both {float(got):.9g}")
    # 6a on offsets near +-2^31, where s + acc mod 7 passes INT32_MAX and
    # wraps (and, at n not dividing 2^32, the wrapped residue takes b2 !=
    # b), and on the probe's offsets at those n: every instance against its
    # plain version, bit for bit.
    for n, where in SMEM_EDGE_TABLES:
        for name, idx4 in (("near +-2^31", tp.smem_edge_inputs(dev)),
                           ("arange", tp.smem_inputs(dev))):
            if name == "arange" and n in decide18.SMEM_SIZES:
                continue          # the tool's entries held these
            serial = tp.smem_table_reference(idx4.cpu(), n)
            card = tp.smem_table_card_reference(idx4.cpu(), n, 4096, 20,
                                                decide15.CARD_SLICES)
            got = [tp.smem_table(idx4, n, where=where, **kw).cpu()
                   for kw in ({}, dict(spread="card", slices=1, warps=1),
                              dict(spread="card",
                                   slices=decide15.CARD_SLICES, warps=1))]
            require(torch.equal(got[0], serial)
                    and torch.equal(got[1], serial)
                    and torch.equal(got[2], card),
                    ("smem table", n, where, name, got, serial, card))
            print(f"    smem {n} int32 ({where}) at offsets {name}: "
                  f"one-thread, one slice and card-wide {int(got[0])}, "
                  f"{int(got[1])}, {int(got[2])}, equal to the plain "
                  f"versions")
    # 6b where each word saturates (arange x 2^24: both sums past 2^31),
    # every instance against its plain version.
    xs = tp.lane_row(dev) * 2 ** 24
    for pct in (0, 15, 100):
        serial = tp.gated_reduce_reference(xs.cpu(), pct)
        card = tp.gated_reduce_card_reference(xs.cpu(), pct, 4096, 20,
                                              decide15.CARD_SLICES)
        got = [tp.gated_reduce(xs, pct, **kw).cpu() for kw in (
            {}, dict(spread="card", slices=1, warps=1),
            dict(spread="card", slices=decide15.CARD_SLICES,
                 warps=decide15.CARD_WARPS))]
        require(torch.equal(got[0], serial) and torch.equal(got[1], serial)
                and torch.equal(got[2], card),
                ("gated reduce, saturated words", pct, got, serial, card))
        print(f"    gated {pct}% at arange x 2^24 (saturated words): "
              f"one-warp, one slice and card-wide {int(got[0])}, "
              f"{int(got[1])}, {int(got[2])}, equal to the plain versions")
    traversal_estimate(entries, diag, octree_cells)
    # Host enqueue a call of every probe wrapper at its tool shape (the
    # first entry of each kernel and instance).
    for e in entries:
        if e["key"] not in ENQUEUE_US:
            ENQUEUE_US[e["key"]] = enqueue_us(e["call"], 20)
    # 5e and torch.roll on equal terms: CUDA events over 100 back-to-back
    # calls and the host's time a call on its own (enqueue, no
    # synchronise), beside the previous launch path of the same kernel, in
    # ROLL_ROUNDS rounds of alternating order (the host's pace moves by
    # tens of percent within a call: the medians are compared); the
    # kernels' own device time under the profiler once.
    x = tp.lane_row(dev)
    prev_roll = PreviousRollPath()
    paths = (("previous launch path", lambda: prev_roll(x, 5)),
             ("tp.roll", lambda: tp.roll(x, 5)),
             ("torch.roll", lambda: torch.roll(x, 5, 1)))
    require(torch.equal(prev_roll(x, 5), torch.roll(x, 5, 1)),
            "the previous launch path's roll")
    for name, fn in paths:
        print(f"    {name}: device {device_ms(fn, ROLL_CALLS):.4f} ms a call "
              f"in its kernels (profiler)")
    rolls = {name: [] for name, _ in paths}
    for rnd in range(ROLL_ROUNDS):
        for name, fn in (paths if rnd % 2 == 0 else paths[::-1]):
            rolls[name].append((cuda_ms(fn, ROLL_CALLS),
                                enqueue_us(fn, ROLL_CALLS) / 1e3))
    med = {}
    for name, v in rolls.items():
        med[name] = tuple(statistics.median(r[i] for r in v) for i in (0, 1))
        print(f"    {name}: ms a call by CUDA events over {ROLL_CALLS} calls, "
              f"then host ms a call to enqueue, by round: "
              + ", ".join(f"{e:.4f}/{h:.4f}" for e, h in v)
              + f"; median {med[name][0]:.4f}/{med[name][1]:.4f}")
    (ev, host), (ev_t, host_t) = med["tp.roll"], med["torch.roll"]
    wins = sum(a[0] <= b[0] and a[1] <= b[1]
               for a, b in zip(rolls["tp.roll"], rolls["torch.roll"]))
    print(f"    5e on equal terms, medians of {ROLL_ROUNDS} rounds: {ev:.4f} "
          f"ms by events and {host:.4f} ms host against torch.roll's "
          f"{ev_t:.4f} and {host_t:.4f} ({ev / ev_t:.3f}x, "
          f"{host / host_t:.3f}x; at or below it on both in {wins} of "
          f"{ROLL_ROUNDS} rounds); the previous launch path "
          f"{med['previous launch path'][0]:.4f} and "
          f"{med['previous launch path'][1]:.4f}")
    # The launch path piece by piece.
    split = launch_split(x, SPLIT_CALLS)
    print(f"    the roll probe's launch path, host ns a call over "
          f"{SPLIT_CALLS:,} calls (pieces less the empty call's "
          f"{split['empty call']:.1f} ns):")
    for name, ns in split.items():
        print(f"      {ns:9.1f}  {name}")
    print("    host enqueue a call of every kernel wrapper at its main-path "
          "shape, us: " + ", ".join(f"{k} {v:.2f}"
                                   for k, v in ENQUEUE_US.items()))
    probes["roll"].update(ms=ev, library_ms=ev_t,
                          label=f"roll, {ROLL_CALLS} calls")
    del entries
    torch.cuda.empty_cache()
    done(t0)

    # ---- 20. the sharded paths ----------------------------------------------
    t0 = phase("20. parallel/: kernel 3's haloed and local_slice modes, the "
               "sorted build's shards, the sharded window step (NCCL, world "
               "size 1), the ring and sharded Barnes-Hut, the sharded boids "
               "step with kernel 4's haloed mode")
    (sharded_launches, haloed_launches, ring_launches,
     reference_at) = sharded_paths(dev, kernels)
    done(t0)

    # ---- 21. compact emission, the port bench, 10M, the estimate ---------
    t0 = phase("21. compact emission at 1M, the port bench's full suite, "
               "10M bodies (the bench's 10m config), record --estimate")
    print("  (a) compact and compact-mm emission on the card")
    compact_launches = compact_on_card(dev, kernels)
    print("  (b) python -m spatialsim_tpu_torch.tools.bench")
    torch.cuda.empty_cache()
    bench_values, bench_launches = run_bench()
    print(f"    beside this run: phase 4's 1M window engine "
          f"{STEPS / sum(step_s_1m):.3f} steps/s over {STEPS} synchronised "
          f"steps (the bench: "
          f"{bench_values['nbody_steps_per_sec_1000k_theta0.8']} over 96 in "
          f"dispatches of 48)")
    print("  (c) 10M: NBodySimulation at the bench's 10m config")
    launches_10m = ten_million(dev, kernels)
    print("  (d) python -m spatialsim_tpu_torch.tools.record --estimate")
    estimate_anchors(bench_values["nbody_steps_per_sec_1000k_theta0.8"],
                     kernels["allpairs"]["ms"])
    estimates({
        "tiny_galaxy": (f"the 8K recorder's {frame8k_ms:.3f} ms a frame "
                        f"(phase 6, its write included) and the all-pairs "
                        f"engine's {ap_step_ms[10_000]:.3f} ms a step at "
                        f"10,000 (phase 4)"),
        "bar_galaxy": (f"{frame_step_ms:.3f} ms for a frame's {rsub} steps "
                       f"at 1M (phase 6)"),
        PRESET_50M: f"the 50M median step {step50_ms:.3f} ms (phase 13)"})
    done(t0)

    # ---- 22. kernel 1's targets-and-sources mode and the tools ----------
    t0 = phase("22. kernel 1's targets-and-sources mode against its plain "
               "version; staleness_scan, nbody_error, nbody_error_scan, "
               "quad_scan, extreme_run, prof_parts and verify_drive")
    reference_at += allpairs_accel_at.launches
    compared, tool_launches = tools_on_card(dev, kernels)
    print(f"    the mode's main-path launches: the ring's hops "
          f"{ring_launches} (phase 20 (d)), the tools {tool_launches} "
          f"(22 (b)); reference launches, not counted: the oracle of the "
          f"accuracy checks in phases 5-21 {reference_at}, the "
          f"comparisons of 22 (a) {compared}")
    require(reference_at > 0 and ring_launches > 0,
            (reference_at, ring_launches))
    done(t0)

    # ---- 23. kernel 3's ablation instances and the rebuild tools -------
    t0 = phase("23. kernel 3's stage-ablation instances against their plain "
               "version; decide7, prof_rebuild, eval_bench, diag10m, "
               "decide29, decide_1m and quick_metrics")
    print("  (a) the ablation instances on phase 11's 1M dense R=10 lists")
    ablation_on_card(dev, kernels, kept_11)
    del kept_11
    print("  (b) the rebuild and eval tools on the card")
    dbg_launches = rebuild_tools_on_card()
    done(t0)

    # ---- 24. the rebuild's phase ablations and the decomposition tools --
    t0 = phase("24. the rebuild's phase ablations on phase 3's 1M state, "
               "card against CPU; decide21, 27, 25, 26, 23, 24, 22, "
               "gather_bench, decide16, decide12 and boids_capture")
    print("  (a) the ablations, the card's integer outputs against the "
          "CPU's")
    ablations_on_card(dev, kept_3)
    del kept_3
    print("  (b) the decomposition tools on the card")
    decomp_launches = decomposition_tools_on_card()
    done(t0)

    # ---- 25. the last tools of scripts/ ---------------------------------
    t0 = phase("25. decide13 (its fold counts and dense line), decide20, "
               "decide14, distsort_bench, seam_analysis, nbody_scan2, "
               "decide2-6, decide19 and decide8-11")
    final_launches = final_tools_on_card()
    done(t0)

    print(f"\ntotal seconds: {time.perf_counter() - wall0:.3f}")
    src = "spatialsim_tpu_torch/csrc"
    summary = {"kernels": [
        dict(name="allpairs", route="cuda", source=f"{src}/allpairs.cu",
             replaces="spatialsim_tpu/ops/allpairs.py:56",
             launches=launches["allpairs"], **kernels["allpairs"]),
        dict(name="allpairs_at", route="cuda", source=f"{src}/allpairs.cu",
             replaces="spatialsim_tpu/ops/allpairs.py:56",
             launches=(ring_launches + tool_launches
                       + decomp_launches["allpairs_at"]
                       + final_launches["allpairs_at"]),
             **kernels["allpairs_at"]),
        dict(name="window_eval_pool", route="cuda",
             source=f"{src}/window_eval_pool.cu",
             replaces="spatialsim_tpu/ops/bh_eval_kernel.py:313",
             launches=(launches["window_eval_pool"] + refresh_launches
                       + compact_launches
                       + decomp_launches["window_eval_pool"]
                       + final_launches["window_eval_pool"]),
             **kernels["window_eval_pool"]),
        dict(name="window_eval_pool_10m", route="cuda",
             source=f"{src}/window_eval_pool.cu",
             replaces="spatialsim_tpu/ops/bh_eval_kernel.py:313",
             launches=launches_10m, **kernels["window_eval_pool_10m"]),
        dict(name="boids_window", route="cuda",
             source=f"{src}/boids_window.cu",
             replaces="spatialsim_tpu/ops/boids_window_kernel.py:45",
             launches=(launches["boids_window"]
                       + decomp_launches["boids_window"]
                       + final_launches["boids_window"]),
             **kernels["boids_window"]),
        dict(name="boids_window_haloed", route="cuda",
             source=f"{src}/boids_window.cu",
             replaces="spatialsim_tpu/ops/boids_window_kernel.py:45",
             launches=haloed_launches, **kernels["boids_window_haloed"]),
        dict(name="window_eval", route="cuda",
             source=f"{src}/window_eval.cu",
             replaces="spatialsim_tpu/ops/bh_eval_kernel.py:432",
             launches=(quad_launches + launches_50m + near_launches
                       + ab_launches.get("window_eval", 0)
                       + sharded_launches + decomp_launches["window_eval"]
                       + final_launches["window_eval"]),
             **kernels["window_eval"]),
        dict(name="window_eval_dbg", route="cuda",
             source=f"{src}/window_eval.cu",
             replaces="spatialsim_tpu/ops/bh_eval_kernel.py:432",
             launches=(dbg_launches + decomp_launches["window_eval_dbg"]
                       + final_launches["window_eval_dbg"]),
             **kernels["window_eval_dbg"]),
        dict(name="window_eval_cols", route="cuda",
             source=f"{src}/window_eval_cols.cu",
             replaces="spatialsim_tpu/ops/bh_eval_kernel.py:182",
             launches=ab_launches["window_eval_cols"],
             **kernels["window_eval_cols"]),
        dict(name="window_eval_mxu", route="cuda",
             source=f"{src}/window_eval_mxu.cu",
             replaces="spatialsim_tpu/ops/bh_eval_kernel.py:255",
             launches=ab_launches["window_eval_mxu"],
             **kernels["window_eval_mxu"]),
    ]}
    for rec in summary["kernels"]:
        rec["host_enqueue_us"] = ENQUEUE_US.get(rec["name"])
        # Launches in the port bench's processes (phase 21 (b)): the 10M
        # kernel-2 entry counts the 10m metric's, the others the rest.
        ten = rec["name"] == "window_eval_pool_10m"
        key = "window_eval_pool" if ten else rec["name"]
        rec["bench_launches"] = sum(
            bench_launches.get(job, {}).get(key, 0)
            for job in (("10m",) if ten else ("boids", "boids500k", "1m")))
    for name, (script, line) in PROBE_KERNELS.items():
        rec = dict(probes[name])
        label = rec.pop("label")
        summary["kernels"].append(dict(
            name=f"probe_{name}", route="cuda",
            source=f"{src}/probes_{script}.cu",
            replaces=f"scripts/{script}.py:{line}",
            launches=probe_launches[name], timed=label,
            host_enqueue_us=ENQUEUE_US.get(name), **rec))
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
