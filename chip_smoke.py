#!/usr/bin/env python3
"""Smoke run of the PyTorch port's N-body main path on one NVIDIA GPU.

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
   30 frames, the all-pairs engine), last frames decoded.

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


def record_kernel(kernels, name, abs_err, rel_err, ms, plain_ms):
    """Keep the worst error over a kernel's checks and its first timing."""
    rec = kernels.setdefault(name, dict(max_abs_err=0.0, max_rel_err=0.0,
                                        ms=ms, plain_ms=plain_ms))
    rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    rec["max_rel_err"] = max(rec["max_rel_err"], rel_err)


def galaxy(n, seed, device):
    import numpy as np
    import torch
    from spatialsim_tpu import distributions
    from spatialsim_tpu.config.nbody import NBODY
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
    from spatialsim_tpu.io import codec
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
    from spatialsim_tpu.config.nbody import NBODY, resolve_config
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
        record_kernel(kernels, "allpairs", abs_err, err, ms, plain_ms)
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
        record_kernel(kernels, "window_eval_pool", abs_err, err, ms,
                      plain_ms)
    del st, lists, acc, s_pos, s_mass, got, want
    done(t0)

    # ---- 4. main path ----------------------------------------------------
    t0 = phase("4. main path: NBodySimulation, both engines, default config")
    torch.cuda.synchronize()
    allpairs_accel.launches = 0
    window_eval_pool.launches = 0
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
    ]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
