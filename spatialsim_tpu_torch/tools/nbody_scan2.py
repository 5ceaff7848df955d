"""Depth-8 window refinements against the direct sum, and the sustained
step rates (port of ``scripts/nbody_scan2.py``).

    python -m spatialsim_tpu_torch.tools.nbody_scan2 [n] [--device cuda|cpu]

The galaxy (seed 0) at ``n`` bodies (default 1M) at the script's base
(theta 0.8, depth 8, group 256, window 3, list cap 6,144, skin 6,
rebuild interval 48, drift off, the default pooled lists).  The direct
sum at 2,048 sampled bodies
(:func:`~spatialsim_tpu_torch.tools.oracle.exact_accel_at`, kernel 1's
targets-and-sources mode on a card; the sample of
:mod:`~spatialsim_tpu_torch.tools.nbody_error_scan`), then for each of
the script's variants (``d8_wg2``: window 2, ``d7``: depth 7,
``d8_L8192``: list cap 8,192) fresh lists and one eval
(``window_bh_accel``'s build and ``eval_accel``: kernel 2 on a card) and
the script's JSON line (median, p99 and rms of |da|/|a|; the second
call's ms, host clock ended by a synchronise) with two more keys:
``folded``, the groups whose far list the default pool cap folded whole
(far_n <= 1, :func:`~spatialsim_tpu_torch.tools.extreme_run.folded_groups`),
of ``groups``; then ``build_diagnostics`` of the base (its worklist caps
and fills, far_n's mean and max, groups at the cap); then the sustained
rate of the production step (``models/nbody.make_step_fn``, one call of
``interval`` substeps after a warm-up call, host clock) at intervals 48
and 96.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.models.nbody import make_step_fn
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.chain import sync
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.extreme_run import folded_groups
from spatialsim_tpu_torch.tools.nbody_error_scan import SAMPLE
from spatialsim_tpu_torch.tools.oracle import (
    add_bodies, bodies_of, device_of, exact_accel_at, initial_conditions,
    report, sample_ids)

DT = 0.02
VARIANTS = (("d8_wg2", {"window_groups": 2}), ("d7", {"max_depth": 7}),
            ("d8_L8192", {"list_capacity": 8192}))
INTERVALS = (48, 96)
DIAG_KEYS = ("wl_caps", "wl_sizes", "far_n_mean", "far_n_max",
             "groups_at_cap")


def scan2_config(n: int) -> NBodyConfig:
    """The script's base."""
    return NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, spawn_radius=500.0,
        distribution="galaxy", engine="window", max_depth=8, group_size=256,
        window_groups=3, list_capacity=6144, skin=6.0, rebuild_interval=48,
        rebuild_drift_mode="off")


def accel_and_folds(pos, vel, mass, cfg):
    """``window_bh_accel``'s accelerations (its build and eval), and the
    groups its lists fold whole and their number."""
    cfg = resolve_config(cfg, pos.shape[1])
    lists = bw.build_lists(pos, vel, mass, **bw._build_kw(cfg))
    acc = bw.eval_accel(lists, pos, mass, 0.0, **bw._eval_kw(cfg))
    far_n = lists.far_n.cpu().numpy()
    return acc, folded_groups(far_n), far_n.shape[0]


def run(n=1_000_000, device="cuda", out=print):
    """The script's lines; returns ``{"variants": [records], "diag":
    {...}, "sustained": {interval: steps/s}}``."""
    device = torch.device(device)
    base = scan2_config(n)
    pos, vel, mass = initial_conditions("galaxy", n, base.spawn_radius,
                                        base.G, device)
    idx = torch.as_tensor(sample_ids(n, min(SAMPLE, n)), device=device)
    exact = exact_accel_at(pos[:, idx], pos, mass, base.G, base.softening)
    out("oracle ready", flush=True)
    recs = []
    for tag, over in VARIANTS:
        cfg = base.replace(**over)
        acc, folded, groups = accel_and_folds(pos, vel, mass, cfg)
        sync(device)
        t1 = time.perf_counter()
        acc2 = bw.window_bh_accel(pos, vel, mass, cfg)
        sync(device)
        del acc2
        recs.append(report(tag, acc[:, idx], exact,
                           time.perf_counter() - t1, out=out,
                           folded=folded, groups=groups))
    diag = bw.build_diagnostics(pos, vel, mass, base)
    diag = {k: diag[k] for k in DIAG_KEYS}
    out(json.dumps(diag), flush=True)
    rates = {}
    for interval in INTERVALS:
        cfg = base.replace(rebuild_interval=interval)
        step = make_step_fn(cfg, n, substeps=interval)
        st = bw.init_window_state(pos.clone(), vel.clone(), mass.clone(),
                                  cfg)
        st = step(st, DT)
        sync(device)
        t0 = time.perf_counter()
        st = step(st, DT)
        sync(device)
        dt = time.perf_counter() - t0
        rates[interval] = interval / dt
        out(json.dumps({"sustained_interval": interval,
                        "steps_per_sec": round(interval / dt, 2),
                        "ms_per_step": round(dt / interval * 1000, 1),
                        "ms_per_step_unrounded": dt / interval * 1000}),
            flush=True)
        del st
    return dict(variants=recs, diag=diag, sustained=rates)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "nbody_scan2")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
