"""The 10M eval wall against group size and window width (port of
``scripts/decide29.py``).

    python -m spatialsim_tpu_torch.tools.decide29 [n] [variant_filter]
        [--device cuda|cpu]

The Plummer ``cluster`` (seed 0) at ``n`` bodies (default 10M) at the
script's configuration (theta 0.8, rebuild interval 24), resolved, in
three geometries: ``g1024_w2`` (the resolved group 1,024 and window 2),
``g512_w2`` and ``g512_w1``.  Each is calibrated on the initial
conditions (its caps printed), then measured: the fresh lists' force
error on the script's 2,048 sampled bodies (``default_rng(1)``) against
one direct sum (:mod:`~spatialsim_tpu_torch.tools.oracle`, kernel 1's
targets-and-sources mode on the card), median, p99 and rms of |da|/|a|;
then the sustained rate of two dispatches of 24 steps (each crossing one
rebuild) after a warm-up dispatch, host clock ended by a synchronise.
Between geometries the state is dropped and the caching allocator
emptied (the script's ``jax.clear_caches()``).  A failure raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.models.nbody import make_step_fn
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.eval_ab import _sync, device_line
from spatialsim_tpu_torch.tools.oracle import (
    add_bodies, bodies_of, device_of, exact_accel_at, initial_conditions,
    relative_errors, sample_ids)

DT = 0.02
SAMPLE = 2048
VARIANTS = (
    ("g1024_w2", {}),
    ("g512_w2", {"group_size": 512}),
    ("g512_w1", {"group_size": 512, "window_groups": 1}),
)


def scan_config(n: int) -> NBodyConfig:
    return resolve_config(NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, spawn_radius=500.0,
        distribution="cluster", engine="window", rebuild_interval=24), n)


def scan(n=10_000_000, filt="", device="cuda", sample=SAMPLE, out=print):
    """The geometries; returns one record a geometry: the caps, the error
    statistics (unrounded) and the sustained rate."""
    device = torch.device(device)
    base = scan_config(n)
    pos, vel, mass = initial_conditions("cluster", n, base.spawn_radius,
                                        base.G, device)
    out(f"device={device.type} n={n:,}", flush=True)
    idx = torch.as_tensor(sample_ids(n, min(sample, n)), device=device)
    exact = exact_accel_at(pos[:, idx], pos, mass, base.G, base.softening)
    out("oracle ready", flush=True)
    recs = []
    for tag, over in VARIANTS:
        if filt and filt not in tag:
            continue
        t0 = time.perf_counter()
        cfg = bw.calibrate_config(base.replace(**over), pos, vel, mass)
        out(f"[{tag}] calibrated {time.perf_counter() - t0:.0f}s "
            f"caps={list(cfg.wl_caps or ())} "
            f"pool_cap={getattr(cfg, 'pool_cap', 0)}", flush=True)
        acc = bw.window_bh_accel(pos, vel, mass, cfg)
        err = relative_errors(acc[:, idx], exact)
        rec = dict(cfg=tag, wl_caps=list(cfg.wl_caps or ()),
                   pool_cap=getattr(cfg, "pool_cap", 0),
                   median=float(np.median(err)),
                   p99=float(np.percentile(err, 99)),
                   rms=float(np.sqrt((err ** 2).mean())))
        out(f"[{tag}] err median={rec['median']:.4f} "
            f"p99={rec['p99']:.4f} rms={rec['rms']:.4f}", flush=True)
        del acc

        step = make_step_fn(cfg, n, substeps=24, engine="window")
        state = bw.init_window_state(pos, vel, mass, cfg)
        state = step(state, DT)
        _sync(device)
        t1 = time.perf_counter()
        for _ in range(2):
            state = step(state, DT)
        _sync(device)
        ms = (time.perf_counter() - t1) / 48.0 * 1e3
        rec.update(ms_per_step=ms, steps_per_sec=1000.0 / ms,
                   rebuilds=step.rebuilds)
        out(json.dumps({"cfg": tag, "ms_per_step": round(ms, 1),
                        "steps_per_sec": round(1000.0 / ms, 2),
                        "ms_per_step_unrounded": ms,
                        "rebuilds": step.rebuilds}), flush=True)
        recs.append(rec)
        del state, step
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out("done", flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 10_000_000)
    ap.add_argument("variant_filter", nargs="?", default="")
    ap.add_argument("--sample", type=int, default=SAMPLE)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide29")
    print(device_line(dev), flush=True)
    scan(bodies_of(a), a.variant_filter, dev, a.sample)
    return 0


if __name__ == "__main__":
    sys.exit(main())
