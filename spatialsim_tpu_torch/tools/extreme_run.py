"""EXTREME-scale execution evidence: init, step, error sample, device
memory (port of ``scripts/extreme_run.py``).

    python -m spatialsim_tpu_torch.tools.extreme_run [n] [steps] [theta]
        [pool_tile] [--device cuda|cpu]
    python -m spatialsim_tpu_torch.tools.extreme_run --preset NAME
        [--frames K] [--device cuda|cpu]

The reference's headline claim is 50M bodies offline (the EXTREME presets,
theta 1.2-1.5).  The first form runs the window engine on the Plummer
cluster (G 0.08, softening 3, radius 700) at ``n`` bodies (default 20M)
for ``steps`` steps (default 50) and prints the numbers that make the
claim checkable: steps/s, the list line (far_n, groups at the list cap,
groups folded whole, pool tiles), each level's worklist demand against
its cap, the force error of the first build's lists on 1,024 and 4,096
sampled bodies against a direct sum over all bodies (the oracle of
:mod:`~spatialsim_tpu_torch.tools.oracle`, on the Morton-sorted state
through ``inv_order``), and device memory in use, its peak and the
card's total.  Theta defaults to the reference's EXTREME ladder: 1.2 at
10M, 1.4 at 20M, 1.5 at 50M.  ``EXTREME_SKIP_CALIBRATE=1`` skips the
calibration.  The JAX script donates the initial arrays to the first
build; here they are freed after it.

The second form builds a preset's simulation as the recorder does
(``config_from_preset``, ``NBodySimulation``): set-up seconds, peak
memory, the list line, demand against caps and the sampled error; then
frees it and runs the recorder CLI (``python -m
spatialsim_tpu_torch.tools.record``) for ``--frames`` frames in a
recordings directory of its own, printing its frame time.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.eval_ab import _sync, device_line
from spatialsim_tpu_torch.tools.oracle import (
    device_of, exact_accel_at, initial_conditions, relative_errors,
    sample_ids)

SAMPLES = (1024, 4096)
DT = 0.015
_ROOT = Path(__file__).resolve().parents[2]


def default_theta(n):
    if n >= 50_000_000:
        return 1.5
    if n >= 20_000_000:
        return 1.4
    return 1.2


def extreme_run_config(n, theta=0.8):
    """The script's configuration at ``n`` bodies and ``theta``: the
    Plummer cluster, G 0.08, softening 3, radius 700, resolved."""
    return resolve_config(NBodyConfig(
        num_bodies=n, theta=theta, G=0.08, softening=3.0, damping=1.0,
        spawn_radius=700.0, distribution="cluster", engine="window",
        rebuild_drift_mode="off"), n)


def memory_stats(device) -> str:
    """Device memory in use, its peak and the card's total (the script's
    ``hbm_stats``)."""
    if device.type != "cuda":
        return "device memory not measured (cpu)"
    gb = [torch.cuda.memory_allocated(device) / 1e9,
          torch.cuda.max_memory_allocated(device) / 1e9,
          torch.cuda.get_device_properties(device).total_memory / 1e9]
    return (f"device memory {gb[0]:.1f} GB in use, peak {gb[1]:.1f} / "
            f"{gb[2]:.1f} GB")


def list_health(st, c, label, out=print):
    """The script's list line of a window state's lists (or of ``st``, a
    ``BHLists``): far_n mean, p99 and max, groups at the list cap, groups
    folded whole (far_n <= 1), and the pool tiles in use."""
    lists = getattr(st, "lists", st)
    fn = lists.far_n.cpu().numpy()
    line = (f"{label} lists: far_n mean={fn.mean():.0f} "
            f"p99={np.percentile(fn, 99):.0f} max={fn.max()} "
            f"at_cap={(fn >= c.list_capacity - 1).sum()} "
            f"folded={(fn <= 1).sum()}/{fn.shape[0]}")
    if lists.pool is not None:
        ps = lists.pstart.cpu().numpy()
        used = int(ps[-1] + -(-int(fn[-1]) // lists.pool.shape[2]))
        line += f" | pool tiles {used}/{lists.pool.shape[0]}"
    out(line, flush=True)


def demand_against_caps(st, c, label, out=print):
    """``build_diagnostics`` on the state: each level's pre-clamp worklist
    demand beside its cap (a demand above its cap folds cells coarsely at
    that level).  Returns the diagnostics."""
    pos_o, vel_o, mass_o = bw.state_original_order(st)
    d = bw.build_diagnostics(pos_o, vel_o, mass_o, c)
    del pos_o, vel_o, mass_o
    pairs = list(zip(d["wl_demand"], d["wl_caps"]))
    over = [li for li, (dm, cap) in enumerate(pairs) if dm > cap]
    out(f"{label} worklists, level: demand / cap: "
        + ", ".join(f"{li}: {int(dm)} / {cap}"
                    for li, (dm, cap) in enumerate(pairs))
        + f"; levels over their cap: {over}; groups at the list cap "
        f"{d['groups_at_cap']}; residual share of the mass "
        f"{d['residual_mass_frac']:.3e}", flush=True)
    return d


def fresh_sample_errors(st, c, label, samples=SAMPLES, out=print):
    """The script's force error on the state's own lists at tau 0: |da|/|a|
    against a direct sum over all bodies, on the bodies ``default_rng(1)``
    draws (1,024, the script's, and 4,096, the accuracy protocol's).  The
    state lives Morton-sorted: the sampled ids map to its slots through
    ``inv_order``.  Returns {k: (median, p99, rms)}."""
    n = st.pos.shape[1]
    acc = bw.eval_accel_sorted(st.lists, st.pos, st.mass, 0.0,
                               **bw._eval_kw(c))
    inv = st.lists.inv_order.long()
    res = {}
    for k in samples:
        slots = inv[torch.as_tensor(sample_ids(n, min(k, n)),
                                    device=inv.device)]
        exact = exact_accel_at(st.pos[:, slots], st.pos, st.mass, c.G,
                               c.softening)
        err = relative_errors(acc[:, slots], exact)
        res[k] = (float(np.median(err)), float(np.percentile(err, 99)),
                  float(np.sqrt((err ** 2).mean())))
        out(f"{label}, force error (fresh lists, {len(slots)} samples): "
            f"median={res[k][0]:.4f} p99={res[k][1]:.4f} "
            f"rms={res[k][2]:.4f}", flush=True)
    return res


def run(n=20_000_000, steps=50, theta=None, pool_over=-1, device="cuda",
        out=print):
    """The first form; returns {"errors", "ms_per_step", "setup_s"}."""
    device = torch.device(device)
    theta = default_theta(n) if theta is None else theta
    cfg = extreme_run_config(n, theta)
    if pool_over >= 0:
        cfg = cfg.replace(pool_tile=pool_over)
    out(f"n={n:,} theta={theta} depth={cfg.max_depth} "
        f"gsz={cfg.group_size} L={cfg.list_capacity} "
        f"interval={cfg.rebuild_interval} adv={cfg.advance_order} "
        f"pool_tile={cfg.pool_tile} device={device.type}", flush=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_all = t0 = time.perf_counter()
    pos, vel, mass = initial_conditions("cluster", n, cfg.spawn_radius,
                                        cfg.G, device)
    out(f"init conditions: {time.perf_counter() - t0:.1f} s", flush=True)
    if os.environ.get("EXTREME_SKIP_CALIBRATE") != "1":
        t0 = time.perf_counter()
        cfg = bw.calibrate_config(cfg, pos, vel, mass)
        _sync(device)
        out(f"calibrate: {time.perf_counter() - t0:.1f} s "
            f"wl_caps={list(cfg.wl_caps) or 'default'}", flush=True)
    t0 = time.perf_counter()
    state = bw.init_window_state(pos, vel, mass, cfg)
    del pos, vel, mass         # the script donates them to the build
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _sync(device)
    setup_s = time.perf_counter() - t_all
    out(f"first build: {time.perf_counter() - t0:.1f} s (set-up "
        f"{setup_s:.1f} s) | {memory_stats(device)}", flush=True)

    # List/pool health: saturation and capacity folds are the two ways
    # accuracy silently degrades at EXTREME scale.
    list_health(state, cfg, f"{n:,}", out)
    demand_against_caps(state, cfg, f"{n:,}", out)
    errors = fresh_sample_errors(state, cfg, f"{n:,}", out=out)

    step = bw.make_window_step(cfg, n, substeps=1)
    state = step(state, DT)                  # the first step, warm
    _sync(device)
    out(f"first step done | {memory_stats(device)}", flush=True)
    t0 = time.perf_counter()
    for k in range(steps):
        state = step(state, DT)
        if (k + 1) % 10 == 0:
            _sync(device)
            el = time.perf_counter() - t0
            out(f"  step {k + 1}/{steps}: {el / (k + 1) * 1000:.0f} "
                f"ms/step ({(k + 1) / el:.2f} steps/s)", flush=True)
    _sync(device)
    el = time.perf_counter() - t0
    out(f"sustained: {steps / el:.2f} steps/s "
        f"({el / steps * 1000:.1f} ms/step) over {steps} steps, "
        f"{step.rebuilds} rebuilds | {memory_stats(device)}", flush=True)
    if not bool(torch.isfinite(state.pos).all()):
        raise RuntimeError("extreme_run: non-finite positions")
    out("state finite OK", flush=True)
    return {"errors": errors, "ms_per_step": el / steps * 1e3,
            "setup_s": setup_s}


def run_preset(name, frames=3, device="cuda", out=print):
    """The second form; returns {"setup_s", "peak_gb", "errors",
    "frame_ms"}."""
    from spatialsim_tpu_torch.models.nbody import NBodySimulation
    from spatialsim_tpu_torch.presets import get_preset_config
    from spatialsim_tpu_torch.tools.record import config_from_preset
    device = torch.device(device)
    preset = get_preset_config(name)
    if preset is None:
        raise SystemExit(f"extreme_run: unknown preset {name!r}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    sim = NBodySimulation(config=config_from_preset(preset),
                          substeps=int(preset.get("substeps", 1)),
                          seed=int(preset.get("seed", 0)), device=device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    c = sim.config
    out(f"{name}: {c.num_bodies:,} bodies ({c.distribution}), theta "
        f"{c.theta}, depth {c.max_depth}, group {c.group_size}, list cap "
        f"{c.list_capacity}, pool tile {c.pool_tile}; set-up {setup_s:.1f} s"
        f" (" + ", ".join(f"{k} {v:.1f} s"
                          for k, v in sim.setup_seconds.items())
        + f") | {memory_stats(device)}", flush=True)
    list_health(sim.state, c, name, out)
    demand_against_caps(sim.state, c, name, out)
    errors = fresh_sample_errors(sim.state, c, name, out=out)
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    del sim
    if device.type == "cuda":
        torch.cuda.empty_cache()
    frame_ms = record_frames(name, frames, device, out)
    return {"setup_s": setup_s, "peak_gb": peak, "errors": errors,
            "frame_ms": frame_ms}


def record_frames(preset, frames, device, out=print):
    """The recorder CLI for ``frames`` frames of ``preset`` in a
    recordings directory of its own; returns its median frame ms."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(_ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory(prefix="extreme_rec_") as rec:
        env["SPATIALSIM_RECORDINGS"] = rec
        cmd = [sys.executable, "-m", "spatialsim_tpu_torch.tools.record",
               "--preset", preset, "--frames", str(frames), "--device",
               device.type]
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=_ROOT, env=env, capture_output=True,
                              text=True)
        secs = time.perf_counter() - t
    frame_ms = None
    for line in proc.stdout.splitlines():
        if line.startswith("[Record] Frame time: median "):
            frame_ms = float(line.split()[4])
            out(f"{preset} recorder: {line[len('[Record] '):]}", flush=True)
    if proc.returncode != 0 or frame_ms is None:
        raise RuntimeError(f"recorder failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    out(f"{preset} recorder: {frames} frames, wall {secs:.1f} s with the "
        f"interpreter's start and the set-up", flush=True)
    return frame_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=float, nargs="?", default=20_000_000)
    ap.add_argument("steps", type=int, nargs="?", default=50)
    ap.add_argument("theta", type=float, nargs="?", default=None)
    ap.add_argument("pool_tile", type=int, nargs="?", default=-1)
    ap.add_argument("--preset", help="a preset, built as the recorder does")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "extreme_run")
    print(device_line(dev), flush=True)
    if a.preset:
        run_preset(a.preset, a.frames, dev)
    else:
        run(int(a.n), a.steps, a.theta, a.pool_tile, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
