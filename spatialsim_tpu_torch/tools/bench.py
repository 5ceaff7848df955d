"""Benchmark harness of the PyTorch port: the JAX package's ``bench.py``
metrics, protocol and configurations on one NVIDIA card.

    python -m spatialsim_tpu_torch.tools.bench             # the full suite
    python -m spatialsim_tpu_torch.tools.bench --only 1m   # one metric

The full suite prints the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``) on a line of its own,
then one JSON line per metric, under ``bench.py``'s names and keys
(``metric``, ``value``, ``unit``, ``vs_baseline``):

1. ``boids_steps_per_sec_100k`` and ``boids_steps_per_sec_500k``: boid
   steps/s at the default ``BoidsConfig``, 96 steps in dispatches of 24;
2. ``nbody_steps_per_sec_1000k_theta0.8``: physics steps/s at 1M galaxy
   bodies (the window engine, calibrated; rebuilds included);
3. ``nbody_frame_time_ms_10000k``: ms a step at 10M bodies, the Plummer
   ``cluster`` at the resolved config (depth 9, group 1024, list cap
   8192), 48 steps in dispatches of 24.

``vs_baseline`` is against the reference CPU anchors ``bench.py`` uses
(:func:`reference_steps_per_sec`, :data:`BOIDS_BASELINE_100K`).  Each
metric runs in a subprocess of its own under :data:`METRIC_TIMEOUT_S`,
cheapest first; one that fails or overruns is reported as ``FAILED`` on
the standard error and the suite goes on.  A dispatch of ``--chain``
steps ends with a host read of one element, so the times are the
device's.  Each metric also prints, on the standard error, its kernel
launches counted from zero.  ``--device`` (default ``cuda``) picks the
torch device; without a card the bench exits 1 -- only ``--device cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

# Hard per-metric wall budget (seconds), as in bench.py: a metric that
# cannot finish inside it is reported as failed and the suite moves on.
METRIC_TIMEOUT_S = {"boids": 420, "boids500k": 420, "1m": 900, "10m": 900}
JOBS = ("boids", "boids500k", "1m", "10m")     # cheapest first
# Set in the suite's subprocesses: the parent printed the card line.
_CHILD_ENV = "SPATIALSIM_BENCH_METRIC"


def reference_steps_per_sec(n: int, theta: float) -> float:
    """Reference CPU anchor extrapolated with its own n log n x (0.8/theta)^2
    scaling model: 70 ms a step at 100K bodies."""
    anchor_n, anchor_theta, anchor_ms = 100_000, 0.8, 70.0
    scale = (n * math.log(max(n, 2))) / (anchor_n * math.log(anchor_n))
    theta_scale = (anchor_theta / theta) ** 2
    return 1000.0 / (anchor_ms * scale * theta_scale)


BOIDS_BASELINE_100K = 30.0  # steps/s, reference interactive claim scale


def _device(device):
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"bench: device {device!r} requested but "
            f"torch.cuda.is_available() is False; pass --device cpu to run "
            f"the plain PyTorch path")
    return dev


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi prints them (the
    torch device name on the CPU or without nvidia-smi)."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"device: {dev.type}"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        return out[dev.index or 0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return (f"{torch.cuda.get_device_name(dev)}, power limit not read "
                f"(no nvidia-smi)")


def _sync(x):
    """End a dispatch: a host read of one element waits for the device."""
    float(x[0, 0])


def _launch_counters():
    from spatialsim_tpu_torch.ops.allpairs import allpairs_accel
    from spatialsim_tpu_torch.ops.bh_eval_kernel import (
        window_eval, window_eval_pool)
    from spatialsim_tpu_torch.ops.boids_window_kernel import (
        boids_window_accumulate)
    return {"allpairs": allpairs_accel, "window_eval_pool": window_eval_pool,
            "window_eval": window_eval,
            "boids_window": boids_window_accumulate}


def nbody_config(n, theta, distribution, engine, group_size, depth,
                 list_cap, skin, rebuild_interval, drift_mode,
                 refresh_interval=0, emit_mode="auto", pool_tile=-1):
    """The N-body metric's config, field for field as ``bench.py`` builds
    it (before calibration)."""
    from spatialsim_tpu_torch.config.nbody import NBodyConfig
    cfg = NBodyConfig(num_bodies=n, theta=theta, G=0.1, softening=2.0,
                      damping=1.0, spawn_radius=500.0,
                      distribution=distribution, engine=engine,
                      group_size=group_size, max_depth=depth,
                      window_groups=2, list_capacity=list_cap, skin=skin,
                      rebuild_interval=rebuild_interval,
                      refresh_interval=refresh_interval,
                      rebuild_drift_mode=drift_mode,
                      traversal_emit=emit_mode)
    if pool_tile >= 0:
        cfg = cfg.replace(pool_tile=pool_tile)
    return cfg


def bench_nbody(n, theta, steps, warmup, chain, distribution, engine,
                group_size, depth, list_cap, skin, rebuild_interval,
                drift_mode, refresh_interval=0, emit_mode="auto",
                pool_tile=-1, verbose=False, device="cuda"):
    """Sustained steps/s with ``chain`` physics steps a dispatch."""
    import numpy as np
    import torch
    from spatialsim_tpu_torch import distributions
    from spatialsim_tpu_torch.models.nbody import (
        NBodyState, make_step_fn, resolve_engine)

    dev = _device(device)
    cfg = nbody_config(n, theta, distribution, engine, group_size, depth,
                       list_cap, skin, rebuild_interval, drift_mode,
                       refresh_interval, emit_mode, pool_tile)
    if engine == "auto":
        engine = resolve_engine(cfg, n)
    if verbose:
        print(f"[bench] device={card_line(dev)} n={n:,} theta={theta} "
              f"engine={engine}", file=sys.stderr)
    t0 = time.time()
    pos, vel, mass = (
        torch.as_tensor(np.ascontiguousarray(a.T if a.ndim == 2 else a,
                                             np.float32), device=dev)
        for a in distributions.generate_distribution(
            distribution, n, cfg.spawn_radius, cfg.G, seed=0))
    if engine == "window":
        # Demand-calibrate the tree, worklist and pool caps on the real
        # initial conditions, as bench.py does.
        from spatialsim_tpu_torch.ops.bh_window import (
            calibrate_config, init_window_state)
        cfg = calibrate_config(cfg, pos, vel, mass)
    step = make_step_fn(cfg, n, substeps=chain, engine=engine)
    if engine == "window":
        state = init_window_state(pos, vel, mass, cfg)
        # Warm-up crosses a rebuild, so both kinds of step ran before the
        # timed region.
        warmup = max(warmup, rebuild_interval // max(chain, 1) + 1)
    else:
        state = NBodyState(pos=pos, vel=vel, mass=mass)
    _sync(state.pos)
    if verbose:
        print(f"[bench] set-up {time.time() - t0:.1f}s", file=sys.stderr)
    dt = 0.02

    t0 = time.time()
    for _ in range(warmup):
        state = step(state, dt)
        _sync(state.pos)
    if verbose:
        print(f"[bench] warmup {time.time() - t0:.1f}s", file=sys.stderr)

    dispatches = max(1, steps // chain)
    t0 = time.time()
    for _ in range(dispatches):
        state = step(state, dt)
        _sync(state.pos)
    elapsed = time.time() - t0
    if not bool(torch.isfinite(state.pos).all()):
        raise RuntimeError(f"non-finite positions after {n:,}-body run")
    return dispatches * chain / elapsed


def bench_boids(n, steps, warmup, chain, verbose=False, device="cuda"):
    """Sustained boid steps/s with ``chain`` steps a dispatch."""
    import torch
    from spatialsim_tpu_torch.config.boids import BoidsConfig
    from spatialsim_tpu_torch.models.boids import Flock, make_step_fn

    dev = _device(device)
    cfg = BoidsConfig(num_boids=n)
    flock = Flock(config=cfg, seed=0, device=dev)
    step = make_step_fn(cfg, substeps=chain)
    if verbose:
        print(f"[bench] boids n={n:,} mode={flock.neighbor_mode}",
              file=sys.stderr)
    state = flock.state
    dt = 1.0 / 30.0
    for _ in range(warmup):
        state = step(state, dt)
        _sync(state.pos)
    dispatches = max(1, steps // chain)
    t0 = time.time()
    for _ in range(dispatches):
        state = step(state, dt)
        _sync(state.pos)
    elapsed = time.time() - t0
    if not bool(torch.isfinite(state.pos).all()):
        raise RuntimeError(f"non-finite boid positions after {n:,} boids")
    return dispatches * chain / elapsed


def job_kwargs(job, args):
    """The keyword arguments of the job's bench function, as ``bench.py``'s
    ``main`` passes them."""
    common = dict(theta=args.theta, warmup=args.warmup, engine=args.engine,
                  skin=args.skin, drift_mode=args.drift_mode,
                  verbose=args.verbose, device=args.device)
    if job == "1m":
        return dict(n=args.bodies or 1_000_000, steps=args.steps,
                    chain=args.chain, distribution=args.distribution,
                    group_size=args.group_size, depth=args.depth,
                    list_cap=args.list_cap,
                    rebuild_interval=args.rebuild_interval,
                    refresh_interval=args.refresh_interval,
                    emit_mode=args.emit_mode, pool_tile=args.pool_tile,
                    **common)
    if job == "10m":
        # EXTREME cluster scale: the resolved engine geometry
        # (resolve_config), a shorter chain.
        return dict(n=args.bodies or 10_000_000, steps=48, chain=24,
                    distribution="cluster", group_size=0, depth=0,
                    list_cap=0, rebuild_interval=args.rebuild_interval,
                    **common)
    return dict(n=args.bodies or (500_000 if job == "boids500k"
                                  else 100_000),
                steps=96, warmup=args.warmup, chain=24,
                verbose=args.verbose, device=args.device)


def parser():
    p = argparse.ArgumentParser(
        description="bench.py's metrics on the PyTorch port (one NVIDIA "
                    "card)")
    p.add_argument("--only", choices=list(JOBS),
                   help="run a single metric (default: the full suite)")
    p.add_argument("--bodies", type=int, default=0,
                   help="override body count for the metric")
    p.add_argument("--theta", type=float, default=0.8)
    p.add_argument("--steps", type=int, default=96)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--chain", type=int, default=48,
                   help="physics steps per dispatch")
    p.add_argument("--distribution", default="galaxy")
    p.add_argument("--engine",
                   choices=["auto", "allpairs", "exact", "window"],
                   default="window")
    p.add_argument("--group-size", type=int, default=256)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--list-cap", type=int, default=6144)
    p.add_argument("--skin", type=float, default=2.0)
    p.add_argument("--rebuild-interval", type=int, default=24,
                   help="list rebuild interval in steps")
    p.add_argument("--refresh-interval", type=int, default=0,
                   help="moment-refresh cadence between rebuilds (0 off)")
    p.add_argument("--drift-mode", choices=["max", "off"], default="off")
    p.add_argument("--emit-mode", default="auto",
                   choices=["auto", "values", "ranges", "compact",
                            "compact-mm"],
                   help="traversal emission mode (config.traversal_emit)")
    p.add_argument("--pool-tile", type=int, default=-1,
                   help="far-list pool tile (-1 = config default)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no CPU fallback)")
    return p


def _suite(argv) -> int:
    """One subprocess a metric, cheapest first, each under its budget."""
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, **{_CHILD_ENV: "1"}, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    failures = 0
    for job in JOBS:
        try:
            rc = subprocess.call(
                [sys.executable, "-m", "spatialsim_tpu_torch.tools.bench",
                 "--only", job] + list(argv), env=env,
                timeout=METRIC_TIMEOUT_S[job])
        except subprocess.TimeoutExpired:
            rc = -9
        if rc != 0:
            failures += 1
            print(f"[bench] metric {job} FAILED rc={rc}", file=sys.stderr,
                  flush=True)
    return 1 if failures == len(JOBS) else 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    dev = _device(args.device)
    if not os.environ.get(_CHILD_ENV):
        print(card_line(dev), flush=True)
    if args.only is None:
        return _suite(argv)

    job = args.only
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    kw = job_kwargs(job, args)
    if job == "1m":
        rate = bench_nbody(**kw)
        baseline = reference_steps_per_sec(kw["n"], args.theta)
        line = {"metric": f"nbody_steps_per_sec_{kw['n'] // 1000}k_theta"
                          f"{args.theta}",
                "value": round(rate, 3), "unit": "steps/s",
                "vs_baseline": round(rate / baseline, 2)}
    elif job == "10m":
        rate = bench_nbody(**kw)
        frame_ms = 1000.0 / rate
        base_ms = 1000.0 / reference_steps_per_sec(kw["n"], args.theta)
        line = {"metric": f"nbody_frame_time_ms_{kw['n'] // 1000}k",
                "value": round(frame_ms, 1), "unit": "ms/step",
                "vs_baseline": round(base_ms / frame_ms, 2)}
    else:
        rate = bench_boids(**kw)
        # The 500K line is the reference's default agent count; its CPU
        # anchor scales the 100K one linearly in n.
        baseline = BOIDS_BASELINE_100K * 100_000 / kw["n"]
        line = {"metric": f"boids_steps_per_sec_{kw['n'] // 1000}k",
                "value": round(rate, 3), "unit": "steps/s",
                "vs_baseline": round(rate / baseline, 2)}
    print(json.dumps(line), flush=True)
    print(f"[bench] {job} kernel launches: "
          f"{json.dumps({k: f.launches for k, f in counters.items()})}",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
