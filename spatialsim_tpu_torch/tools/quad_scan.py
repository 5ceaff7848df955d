"""Quadrupole-vs-monopole frontier at production scale (port of
``scripts/quad_scan.py``).

    python -m spatialsim_tpu_torch.tools.quad_scan [n] [--device cuda|cpu]

For each engine config: force error against one shared direct-sum oracle
(median / p99 / rms over 2,048 sampled bodies; kernel 1's
targets-and-sources mode on the card), rebuild time, eval time, and
list / worklist occupancy.  This is the measurement that sets the
``use_quadrupole`` / ``quad_accept_scale`` / ``list_capacity`` defaults.

* ``n`` <= 4M: the six-variant frontier of the galaxy at depth 7 and 6,
  monopole and quadrupole.  The port builds every variant as dense lists
  (``pool_tile=0``): the quadrupole forces them, and for the monopole
  they evaluate the same forces without the JAX package's default pool
  cap, which folds whole groups at 1M (``ROADMAP.md`` Queue 3).
* ``n`` > 4M: the production path at the Plummer cluster, resolved and
  calibrated as the bench runs it: ``prod`` and ``prod_theta1.3``, and
  ``prod_deep_caps``: ``prod`` with every level's worklist cap grown to
  its measured pre-clamp demand (``build_diagnostics``, re-measured
  until no level folds; calibration freezes the two deepest levels) and
  the pool sized to the grown caps' exact emission bound.  Each line adds
  the peak device memory of its build and eval, the rms over 4,096
  samples (the accuracy protocol's sample), and that rms at tau = 23
  (5 warm-up steps at rebuild interval 4, then the lists frozen for 22
  steps at dt 0.02).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.eval_ab import _sync, device_line
from spatialsim_tpu_torch.tools.oracle import (
    device_of, exact_accel_at, initial_conditions, relative_errors,
    sample_ids)
from spatialsim_tpu_torch.tools.staleness_scan import warmed_state

DT = 0.02
SAMPLE, SAMPLE_PROTOCOL, TAU = 2048, 4096, 23
LARGE = 4_000_000
FRONTIER = [
    ("mono_d7", {"max_depth": 7}),
    ("quad_d7_s1.0", {"max_depth": 7, "use_quadrupole": True,
                      "quad_accept_scale": 1.0}),
    ("quad_d7_s1.0_L3k", {"max_depth": 7, "use_quadrupole": True,
                          "quad_accept_scale": 1.0, "list_capacity": 3072}),
    ("quad_d7_s1.2_L3k", {"max_depth": 7, "use_quadrupole": True,
                          "quad_accept_scale": 1.2, "list_capacity": 3072}),
    ("mono_d6", {"max_depth": 6}),
    ("quad_d6_s1.0", {"max_depth": 6, "use_quadrupole": True,
                      "quad_accept_scale": 1.0}),
]
PRODUCTION = [("prod", {}), ("prod_theta1.3", {"theta": 1.3})]


def timeit(fn, device, reps=2):
    """(fastest of ``reps`` host-clock calls after one warm-up, each ended
    by a synchronise; the last result)."""
    out = fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        _sync(device)
        best = min(best, time.perf_counter() - t)
    return best, out


def grown_caps(cfg, pos, vel, mass):
    """Every level's worklist cap raised to its measured pre-clamp demand
    (rounded up to 1024), re-measured after each growth until no level's
    demand exceeds its cap (a level that folds undercounts the deeper
    levels' demand, so a round can uncover the next level's); returns the
    caps."""
    caps = None
    for _ in range(cfg.max_depth):
        d = bw.build_diagnostics(pos, vel, mass, cfg)
        caps = [int(c) for c in d["wl_caps"]]
        new = [max(c, -(-int(dm) // 1024) * 1024)
               for c, dm in zip(caps, d["wl_demand"])]
        if new == caps:
            break
        caps = new
        cfg = cfg.replace(wl_caps=tuple(new))
    return caps


def production_base(n):
    """The bench's 10M configuration shape at ``n``: the Plummer cluster,
    resolved (pooled cell-id, depth 9, group 1024 at 10M)."""
    return resolve_config(NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, spawn_radius=500.0,
        distribution="cluster", engine="window"), n)


def frontier_base(n):
    return NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, spawn_radius=500.0,
        distribution="galaxy", engine="window", max_depth=8, group_size=256,
        window_groups=2, list_capacity=6144, skin=6.0, use_quadrupole=False,
        pool_tile=0)


def tau23_errors(pos, vel, mass, cfg, idx):
    """|da|/|a| at ``idx`` (original ids) of lists aged to tau = 23 under
    the accuracy protocol."""
    n = pos.shape[1]
    st = warmed_state(pos, vel, mass, cfg)
    st = bw.make_window_step(cfg.replace(rebuild_interval=10 ** 6), n,
                             substeps=22)(st, DT)
    slots = st.lists.inv_order.long()[idx]
    exact = exact_accel_at(st.pos[:, slots], st.pos, st.mass, cfg.G,
                           cfg.softening)
    acc = bw.eval_accel_sorted(st.lists, st.pos, st.mass, DT,
                               **bw._eval_kw(cfg))
    return relative_errors(acc[:, slots], exact), st.lists.steps_since


def scan(n=1_000_000, device="cuda", out=print):
    """Run the scan; returns the JSON records."""
    device = torch.device(device)
    large = n > LARGE
    base = production_base(n) if large else frontier_base(n)
    pos, vel, mass = initial_conditions(base.distribution, n,
                                        base.spawn_radius, base.G, device)
    variants = list(PRODUCTION) if large else list(FRONTIER)
    if large:
        t0 = time.time()
        base = bw.calibrate_config(base, pos, vel, mass)
        out(f"calibrated in {time.time() - t0:.0f}s "
            f"wl_caps={list(base.wl_caps or ())} pool_cap={base.pool_cap}",
            flush=True)
        caps = grown_caps(base, pos, vel, mass)
        out(f"deep caps: wl_caps={caps} (calibrated "
            f"{list(base.wl_caps or ())})", flush=True)
        # pool_cap 0: the build sizes the pool to the caps' exact
        # emission bound, so the grown levels fold no group.
        variants.append(("prod_deep_caps", {"wl_caps": tuple(caps),
                                            "pool_cap": 0}))
    idx = torch.as_tensor(sample_ids(n, min(SAMPLE, n)), device=device)
    exact = exact_accel_at(pos[:, idx], pos, mass, base.G, base.softening)
    if large:
        idx4 = torch.as_tensor(sample_ids(n, min(SAMPLE_PROTOCOL, n)),
                               device=device)
        exact4 = exact_accel_at(pos[:, idx4], pos, mass, base.G,
                                base.softening)
    out("oracle ready", flush=True)
    recs = []
    for tag, over in variants:
        cfg = base.replace(**over)
        kw = bw._build_kw(cfg)
        ekw = bw._eval_kw(cfg)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t_build, lists = timeit(lambda: bw.build_lists(pos, vel, mass, **kw),
                                device)
        t_eval, acc = timeit(lambda: bw.eval_accel(lists, pos, mass, DT,
                                                   **ekw), device)
        err = relative_errors(acc[:, idx], exact)
        diag = bw.build_diagnostics(pos, vel, mass, cfg)
        wl = np.array(diag["wl_sizes"][:diag["n_levels"]], float)
        rec = {
            "cfg": tag,
            "median": round(float(np.median(err)), 5),
            "p99": round(float(np.percentile(err, 99)), 5),
            "rms": round(float(np.sqrt((err ** 2).mean())), 5),
            "build_ms": round(t_build * 1000),
            "eval_ms": round(t_eval * 1000, 1),
            "far_n_mean": round(diag["far_n_mean"]),
            "far_n_p99": round(diag["far_n_p99"]),
            "groups_at_cap": diag["groups_at_cap"],
            "wl_visited_M": round(float(wl.sum()) / 1e6, 2),
            "residual_frac": round(diag["residual_mass_frac"], 5),
        }
        if large:
            e4 = relative_errors(acc[:, idx4], exact4)
            rec["rms_4096"] = round(float(np.sqrt((e4 ** 2).mean())), 5)
            rec["wl_caps"] = list(diag["wl_caps"])
            rec["wl_demand"] = [int(x) for x in diag["wl_demand"]]
            del lists, acc
            e23, age = tau23_errors(pos, vel, mass, cfg, idx4)
            rec[f"tau{age}_rms_4096"] = round(
                float(np.sqrt((e23 ** 2).mean())), 5)
        if device.type == "cuda":
            rec["peak_gb"] = round(
                torch.cuda.max_memory_allocated(device) / 1e9, 3)
        out(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "quad_scan")
    print(device_line(dev), flush=True)
    scan(a.n, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
