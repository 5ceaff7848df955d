#!/usr/bin/env python3
"""Smoke run of the PyTorch port's N-body and boids main paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA card and raises
without one: there is no CPU fallback, no phase's error is caught, and any
failure exits non-zero.  Phases, each printed with its seconds:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   and a fresh nvcc build of every kernel in ``spatialsim_tpu_torch/csrc``;
2. kernel 1 (all-pairs) against its plain version at N = 32,768 and a
   ragged 30,001, galaxy ICs: max|da|/max|a| and CUDA-event times;
3. kernel 2 (pooled window eval) against its plain version on the lists
   the port builds for the 1M galaxy, at steps_since 0 and 23;
4. the main path with every kernel launch counted from zero: the
   all-pairs engine (``NBodySimulation(num_bodies=32_768)``, 10 steps) and
   the window engine (``NBodySimulation(num_bodies=1_000_000,
   device="cuda")`` with the default config, 48 steps at dt 0.02: one
   rebuild at step 25 on top of the initial build);
5. force accuracy against a direct sum on 4,096 sampled bodies: the rms
   of the per-body relative error |da|/|a| (the statistic of the JAX
   package's accuracy table), under that table's protocol (5 warm-up
   steps, then lists frozen to tau = 23; limits 5% fresh, 8% at tau=23),
   and for the main path's own last interval (reported);
6. the recorder CLI at 1M (bar_galaxy, 10 frames) and 8K (tiny_galaxy,
   30 frames, the all-pairs engine), last frames decoded;
7. kernel 3 (boids Morton window) against its plain version on the 500K
   ``Flock``'s initial state and again after 48 steps: pass 1 (no dedup)
   and pass 2 (dedup against pass 1's window), max|d|/max|ref| per
   accumulator group (limit 2e-4) and the share of boids whose counts
   differ (limit 1e-4), CUDA-event times;
8. the boids main path with every kernel launch counted from zero:
   ``Flock(num_boids=500_000)`` and ``Flock(num_boids=100_000)`` at the
   default config, 96 steps each at dt 1/30 (2 launches a step, 15
   re-sorts), under ``bench.py``'s metric names, and the 20K grid mode
   (no kernel, 10 steps);
9. the 500K flock after those 96 steps: window forces against the exact
   grid (``cell_capacity`` at the largest cell occupancy), the share of
   boids whose force agrees at atol 1e-4 and the share of neighbour pairs
   the window captures (both >= 0.99);
10. where the device time goes, under ``torch.profiler``: the 500K flock
    over 12 more steps (2 re-sorts), and the 1M N-body window engine over
    the 3 steps around a rebuild and 20 steps between rebuilds: wall and
    device-busy milliseconds, the idle share, the kernels by device time
    (the profiler adds host time, so the idle share is an upper bound).

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_MAIN = 1_000_000
DT = 0.02
STEPS = 48
N_SAMPLE = 4096
AP_STEPS = 10
TOL_ALLPAIRS = 1e-5    # rsqrtf (~2 ulp) + FMA contraction vs plain rsqrt/div
TOL_WINDOW = 1e-4      # same, summed over ~4K sources in another order
N_BOIDS = 500_000
BOIDS_DT = 1.0 / 30.0
BOIDS_STEPS = 96
TOL_BOIDS = 2e-4       # the JAX package's bar for its kernel vs XLA form
TOL_BOIDS_COUNTS = 1e-4   # share of boids whose counts may differ
# H100 SXM peaks (NVIDIA data sheet, 700 W): FP32 outside the tensor
# cores, HBM3 bandwidth.  A bound is the larger of ops/peak, bytes/peak.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name):
    print(f"\n=== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"    phase seconds: {time.perf_counter() - t0:.3f}", flush=True)


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


def profile_steps(label, step, steps):
    """Run ``step`` ``steps`` times under torch.profiler; print the wall
    and device-busy milliseconds, the idle share and the kernels that took
    the most device time."""
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


def sorted_padded(lists, pos, mass):
    """Original-order state -> the (3, npad)/(npad,) sorted kernel input."""
    import torch
    n = pos.shape[1]
    o = lists.order[:n].long()
    pad = lists.order.shape[0] - n
    s_pos = torch.cat([pos[:, o], pos[:, o[-1:]].expand(3, pad)], 1)
    s_mass = torch.cat([mass[o], mass.new_zeros(pad)])
    return s_pos.contiguous(), s_mass


def direct_accel(targets, pos, mass, G, softening, chunk=64):
    """Plain O(N*k) direct sum at ``targets`` (3, k) over all sources."""
    import torch
    soft_sq = float(softening) ** 2
    out = []
    for i0 in range(0, targets.shape[1], chunk):
        t = targets[:, i0:i0 + chunk]
        d = pos[:, None, :] - t[:, :, None]                # (3, c, N)
        r2 = (d * d).sum(0) + soft_sq
        inv = torch.rsqrt(r2)
        w = torch.where(r2 > soft_sq, mass[None, :] * inv * inv * inv,
                        torch.zeros_like(r2))
        out.append((w[None] * d).sum(2, dtype=torch.float64) * G)
    return torch.cat(out, 1)


def force_errors(approx, exact):
    """(rms, median) of the per-body relative error |da_i| / |a_i| -- the
    statistic of the JAX package's accuracy table -- and the ratio
    rms|da| / rms|a| over the sample."""
    err = (approx.double() - exact).norm(dim=0)
    mag = exact.norm(dim=0)
    rel = err / mag.clamp(min=1e-12)
    return (float(rel.pow(2).mean().sqrt()), float(rel.median()),
            float(err.pow(2).mean().sqrt() / mag.pow(2).mean().sqrt()))


def run_recorder(args, rec_root):
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
    kept_raw = 0
    for line in proc.stdout.splitlines():
        if line.startswith("[Compress] frame"):
            kept_raw += "keeping staged npz" in line
        elif line.startswith(("[Record]", "[Compress]")):
            print("    " + line.strip())
    if kept_raw:
        print(f"    {kept_raw} frames kept as staged .npz (the compressor "
              f"could not pack them; the codec reads both forms)")
    if proc.returncode != 0:
        raise RuntimeError(f"recorder failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    print(f"    recorder wall seconds: {secs:.3f}")


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False -- "
                         "this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from spatialsim_tpu_torch import _kernels
    from spatialsim_tpu_torch.ops.allpairs import (
        allpairs_accel, allpairs_accel_reference)
    from spatialsim_tpu_torch.ops.bh_eval_kernel import (
        window_eval_pool, window_eval_pool_reference)
    from spatialsim_tpu_torch.ops import bh_window as bw
    from spatialsim_tpu_torch.models.nbody import NBodySimulation
    from spatialsim_tpu_torch.config.nbody import NBODY, resolve_config
    from spatialsim_tpu_torch.config.boids import BOIDS
    from spatialsim_tpu_torch.models.boids import Flock
    from spatialsim_tpu_torch.ops import boids_ops as bo
    from spatialsim_tpu_torch.ops.boids_window_kernel import (
        boids_window_accumulate)
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    wall0 = time.perf_counter()
    kernels = {}

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
    for line in _kernels.build_info["log"].splitlines():
        if "Used" in line or "spill" in line:
            print("    ptxas: " + line.strip())
    done(t0)

    # ---- 2. kernel 1 vs plain -------------------------------------------
    t0 = phase("2. all-pairs kernel vs plain")
    cfg_ap = NBODY
    for n in (32_768, 30_001):
        pos, _, mass = galaxy(n, 1, dev)
        got = allpairs_accel(pos, mass, cfg_ap.G, cfg_ap.softening)
        want = allpairs_accel_reference(pos, mass, cfg_ap.G,
                                        cfg_ap.softening)
        torch.cuda.synchronize()
        abs_err, err = kernel_errors(got, want)
        ms = cuda_ms(lambda: allpairs_accel(pos, mass, cfg_ap.G,
                                            cfg_ap.softening), 20)
        plain_ms = cuda_ms(lambda: allpairs_accel_reference(
            pos, mass, cfg_ap.G, cfg_ap.softening), 3)
        print(f"    N={n}: max|da| = {abs_err:.3e}, max|da|/max|a| = "
              f"{err:.3e} (tol {TOL_ALLPAIRS})"
              f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  kernel "
              f"{n * n / ms / 1e6:.1f} Gpairs/s")
        require(err <= TOL_ALLPAIRS, f"allpairs error {err}")
        # 19 FP32 operations a pair (FMA as 2) and one rsqrt; pos and
        # mass read once, acc written once.
        record_kernel(kernels, "allpairs", abs_err, err, ms, plain_ms,
                      19.0 * n * n, 4 * n * (4 + 3))
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
    s_pos, s_mass = sorted_padded(lists, pos, mass)
    # Pairs the kernel evaluates: every window group in range, plus every
    # slot of the group's ceil(far_n/tile) tiles.
    gsz, wg, tile = cal.group_size, cal.window_groups, lists.pool.shape[2]
    ng = lists.far_n.shape[0]
    g = torch.arange(ng, device=dev)
    n_win = (torch.clamp(g + wg, max=ng - 1) - torch.clamp(g - wg, min=0)
             + 1)
    n_far = (lists.far_n.long() + tile - 1) // tile * tile
    pairs = int(((n_win * gsz + n_far) * gsz).sum())
    print(f"    pairs per eval: {pairs:.4e} (window + far tiles)")
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
        plain_ms = cuda_ms(lambda: window_eval_pool_reference(*args, **kw),
                           1)
        print(f"    steps_since={ss}: max|da| = {abs_err:.3e}, "
              f"max|da|/max|a| = {err:.3e} "
              f"(tol {TOL_WINDOW})  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  kernel {pairs / ms / 1e6:.1f} Gpairs/s")
        require(err <= TOL_WINDOW, f"window eval error {err}")
        # 18 FP32 operations a pair; the sorted bodies, the whole pool and
        # the per-group tables read once, accelerations written once.
        nbytes = 4 * (s_pos.numel() + s_mass.numel() + lists.pool.numel()
                      + lists.pstart.numel() + lists.far_n.numel()
                      + got.numel())
        record_kernel(kernels, "window_eval_pool", abs_err, err, ms,
                      plain_ms, 18.0 * pairs, nbytes)
    del st, lists, acc, s_pos, s_mass, got, want
    done(t0)

    # ---- 4. main path ----------------------------------------------------
    t0 = phase("4. main path: NBodySimulation, both engines, default config")
    torch.cuda.synchronize()
    allpairs_accel.launches = 0
    window_eval_pool.launches = 0
    boids_window_accumulate.launches = 0
    # The all-pairs engine at its threshold (N <= 32,768)...
    sim_ap = NBodySimulation(num_bodies=32_768, device="cuda")
    for _ in range(AP_STEPS):
        sim_ap.update(DT)
    require(sim_ap.engine == "allpairs", sim_ap.engine)
    require(bool(torch.isfinite(sim_ap.state.pos).all()), "allpairs state")
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
    launches = {"allpairs": allpairs_accel.launches,
                "window_eval_pool": window_eval_pool.launches}
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
    require(launches["allpairs"] == AP_STEPS, launches)
    require(sim.rebuilds + 1 == 2, f"list builds {sim.rebuilds + 1}")
    for name, t_ in (("pos", sim.state.pos), ("vel", sim.state.vel)):
        require(t_.shape == (3, N_MAIN) and bool(torch.isfinite(t_).all()),
                f"final {name} finite, shape {tuple(t_.shape)}")
    print(f"    peak device memory GB: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    done(t0)

    # ---- 5. accuracy against direct sum ---------------------------------
    t0 = phase("5. accuracy vs direct sum, 4096 sampled bodies")
    ekw = bw._eval_kw(sim.config)
    idx = torch.as_tensor(np.sort(np.random.default_rng(1).choice(
        N_MAIN, N_SAMPLE, replace=False)), device=dev)

    def errors(st, fresh_too):
        """Errors of the state's own (aged) lists, and of fresh lists
        built from the same state, at ``idx`` in original body order."""
        inv = st.lists.inv_order.long()
        pos_o, vel_o, mass_o = st.pos[:, inv], st.vel[:, inv], st.mass[inv]
        exact = direct_accel(pos_o[:, idx], pos_o, mass_o, cal.G,
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
    st = bw.init_window_state(pos, vel, mass, sim.config)
    st = bw.make_window_step(sim.config.replace(rebuild_interval=4), N_MAIN,
                             substeps=5)(st, DT)
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
    with tempfile.TemporaryDirectory(prefix=".smoke_rec_", dir=ROOT) as tmp:
        rec_root = Path(tmp)
        run_recorder(["--preset", "bar_galaxy", "--bodies", "1m",
                      "--frames", "10", "--name", "smoke_1m"], rec_root)
        check_frame(rec_root / "smoke_1m", 9, N_MAIN)
        run_recorder(["--preset", "tiny_galaxy", "--bodies", "8k",
                      "--frames", "30", "--name", "smoke_8k"], rec_root)
        check_frame(rec_root / "smoke_8k", 29, 8_000)
    done(t0)

    # ---- 7. boids kernel vs plain ----------------------------------------
    t0 = phase("7. boids window kernel vs plain, 500K Flock state")
    bcfg = BOIDS
    gsz, wg1 = bcfg.group_size, bcfg.window_groups
    wg2 = bcfg.pass2_window_groups or wg1
    kw1 = dict(gsz=gsz, wg=wg1, perception_sq=bcfg.perception_radius ** 2,
               separation_sq=bcfg.separation_radius ** 2)
    kw2 = dict(kw1, wg=wg2, prev_wg=wg1)
    flock = Flock(num_boids=N_BOIDS, device="cuda")
    npad = flock.state.p21.numel()
    ng = npad // gsz
    pairs = window_pairs(ng, gsz, wg1) + window_pairs(ng, gsz, wg2)
    print(f"    npad {npad} ({ng} groups of {gsz}); pairs a step: "
          f"{window_pairs(ng, gsz, wg1):.4e} (pass 1, wg {wg1}) + "
          f"{window_pairs(ng, gsz, wg2):.4e} (pass 2, wg {wg2}) = "
          f"{pairs:.4e}")
    for label, steps in (("initial state", 0), ("after 48 steps", 48)):
        for _ in range(steps):
            flock.update(BOIDS_DT)
        ms = plain_ms = nb_pairs = abs_err = rel_err = 0.0
        for ps, args, kw in zip((1, 2), boids_pass_inputs(flock.state, bcfg),
                                (kw1, kw2)):
            got = boids_window_accumulate(*args, **kw)
            want = bo.window_accumulate_reference(*args, **kw)
            torch.cuda.synchronize()
            got, want = got[:, :N_BOIDS], want[:, :N_BOIDS]
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
            nb_pairs += float(want[13].sum())
            k_ms = cuda_ms(lambda: boids_window_accumulate(*args, **kw), 20)
            p_ms = cuda_ms(lambda: bo.window_accumulate_reference(
                *args, **kw), 10)
            ms, plain_ms = ms + k_ms, plain_ms + p_ms
            print(f"    {label}, pass {ps}: max|d|/max|ref| {', '.join(errs)}"
                  f" (tol {TOL_BOIDS}); counts differ for {differ:.3e} of "
                  f"boids (tol {TOL_BOIDS_COUNTS}); neighbour pairs "
                  f"{int(want[13].sum())}; kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms")
        # One step's work: both passes.  ~10 FP32 operations for a pair's
        # distance test, ~30 more for a neighbour pair; each pass reads
        # its 9-10 input rows once and writes its 14 rows once.
        ops = 10.0 * pairs + 30.0 * nb_pairs
        nbytes = 4 * npad * ((9 + 14) + (10 + 14))
        print(f"    {label}, both passes: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound(ops, nbytes)[0]:.4f} ms "
              f"({bound(ops, nbytes)[1]}); kernel "
              f"{pairs / ms / 1e6:.1f} Gpairs/s; by the TPU kernel's cost "
              f"model (40 flops a pair) the bound is "
              f"{40.0 * pairs / PEAK_FP32 * 1e3:.4f} ms")
        record_kernel(kernels, "boids_window", abs_err, rel_err, ms,
                      plain_ms, ops, nbytes)
    del flock, got, want
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
        print(f"    boids_steps_per_sec_{n // 1000}k = "
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
    occupancy = int(torch.bincount(bo.cell_index(st.pos, **gkw).long()).max())
    fw, cw, nw = bo.flocking_forces_window_frozen(
        st.pos, st.vel, st.col, st.p21, st.s21, group_size=gsz,
        window_groups=wg1, pass2_window_groups=bcfg.pass2_window_groups,
        second_pass=bcfg.second_pass, return_counts=True, **fkw)
    fe, ce, ne = bo.flocking_forces(
        st.pos, st.vel, st.col, cell_range=1, cell_capacity=occupancy,
        return_counts=True, **gkw, **fkw)
    agree = float(torch.isclose(fw, fe, rtol=1e-5, atol=1e-4).all(0)
                  .float().mean())
    captured, exact = int(nw.sum()), int(ne.sum())
    # The same grid in float64 on the same float32 state: how far each
    # float32 path sits from the exact sums (reported, no limit).
    f64 = bo.flocking_forces(
        st.pos.double(), st.vel.double(), st.col.double(), cell_range=1,
        cell_capacity=occupancy, **gkw, **fkw)[0]
    for name, f in (("window", fw), ("grid", fe)):
        share = float(torch.isclose(f.double(), f64, rtol=1e-5, atol=1e-4)
                      .all(0).float().mean())
        print(f"    {name} (float32) vs the float64 grid: forces agreeing "
              f"at atol 1e-4 for {share:.6f} of boids; max|d| "
              f"{float((f.double() - f64).abs().max()):.3e}")
    print(f"    steps since re-sort {st.steps_since}; largest cell occupancy "
          f"{occupancy} (grid cell_capacity); forces agreeing at atol 1e-4: "
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
    del flock500, st
    sim = NBodySimulation(num_bodies=N_MAIN, device="cuda")
    for _ in range(23):
        sim.update(DT)
    profile_steps("N-body 1M, steps 24-26 (one rebuild)",
                  lambda: sim.update(DT), 3)
    require(sim.rebuilds == 1, sim.rebuilds)
    profile_steps("N-body 1M, steps 27-46 (between rebuilds)",
                  lambda: sim.update(DT), 20)
    require(sim.rebuilds == 1, sim.rebuilds)
    del sim
    done(t0)

    print(f"\ntotal seconds: {time.perf_counter() - wall0:.3f}")
    src = "spatialsim_tpu_torch/csrc"
    summary = {"kernels": [
        dict(name="allpairs", route="cuda", source=f"{src}/allpairs.cu",
             replaces="spatialsim_tpu/ops/allpairs.py:56",
             launches=launches["allpairs"], **kernels["allpairs"]),
        dict(name="window_eval_pool", route="cuda",
             source=f"{src}/window_eval_pool.cu",
             replaces="spatialsim_tpu/ops/bh_eval_kernel.py:313",
             launches=launches["window_eval_pool"],
             **kernels["window_eval_pool"]),
        dict(name="boids_window", route="cuda",
             source=f"{src}/boids_window.cu",
             replaces="spatialsim_tpu/ops/boids_window_kernel.py:45",
             launches=launches["boids_window"],
             **kernels["boids_window"]),
    ]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
