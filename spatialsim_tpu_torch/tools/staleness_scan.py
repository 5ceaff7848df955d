"""Force-error growth of aged interaction lists at production scale (port
of ``scripts/staleness_scan.py``).

    python -m spatialsim_tpu_torch.tools.staleness_scan [n] [skin] [wg]
        [gsz] [refresh_iv] [taus] [--sample K] [--device cuda|cpu]

Runs the window engine with NO rebuilds from one initial build, and at
each tau (default 0, 24, 48, 96; 192 too with refreshes; any multiples of
8, comma-separated) measures the aged lists' force error against a
direct-sum oracle (:mod:`~spatialsim_tpu_torch.tools.oracle`, kernel 1's
targets-and-sources mode on the card) at the *current* (drifted)
positions, beside fresh lists of the same state, on ``--sample`` bodies
(the script's 2,048; the accuracy protocol draws 4,096 from the same
seed).  This is the
measurement that sets the ``rebuild_interval`` / ``skin`` defaults: the
interval is safe while the staleness term stays small against the
theta-level floor.  ``refresh_iv`` > 0 refreshes the lists' moments
every that many steps, so the taus measure only the geometric acceptance
decay.

As the port's engine does (``NBodySimulation``), the config is
calibrated on the initial conditions (``calibrate_config``): the JAX
package's default pool cap folds whole groups at the 1M galaxy
(``ROADMAP.md`` Queue 3).  Prints one JSON line per tau, as the script.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.eval_ab import _sync, device_line
from spatialsim_tpu_torch.tools.oracle import (
    device_of, err_stats, exact_accel_at, initial_conditions, sample_ids)

DT = 0.02
SAMPLE = 2048


def scan_config(n, skin=6.0, wg=2, gsz=256, refresh_iv=0):
    """The script's configuration, resolved for ``n``: no rebuilds, no
    drift check, monopole."""
    return resolve_config(NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, spawn_radius=500.0,
        distribution="galaxy", engine="window", max_depth=8, group_size=gsz,
        window_groups=wg, list_capacity=6144, skin=skin,
        rebuild_interval=10 ** 6, rebuild_drift_mode="off",
        refresh_interval=refresh_iv, use_quadrupole=False), n)


def warmed_state(pos, vel, mass, cfg, dt=DT):
    """The script's warm-up: the first build has zero accelerations (its
    interval is ballistic), so 5 steps at rebuild interval 4 cross one
    rebuild and the lists carry real cell accelerations (1 step old)."""
    st = bw.init_window_state(pos, vel, mass, cfg)
    return bw.make_window_step(cfg.replace(rebuild_interval=4),
                               pos.shape[1], substeps=5)(st, dt)


def scan(n=1_000_000, skin=6.0, wg=2, gsz=256, refresh_iv=0, taus=None,
         device="cuda", sample=SAMPLE, out=print):
    """Run the scan; returns the JSON records, one a tau."""
    if taus is None:
        taus = [0, 24, 48, 96] if not refresh_iv else [0, 24, 48, 96, 192]
    if any(t % 8 for t in taus) or list(taus) != sorted(taus):
        raise ValueError(f"taus must ascend in multiples of 8: {taus}")
    device = torch.device(device)
    cfg = scan_config(n, skin, wg, gsz, refresh_iv)
    pos, vel, mass = initial_conditions("galaxy", n, cfg.spawn_radius,
                                        cfg.G, device)
    cfg = bw.calibrate_config(cfg, pos, vel, mass)
    idx = torch.as_tensor(sample_ids(n, min(sample, n)), device=device)
    st = warmed_state(pos, vel, mass, cfg)
    del pos, vel, mass
    _sync(device)
    out(f"# warmup done, steps_since={st.lists.steps_since}, "
        f"advance_order={cfg.advance_order}", flush=True)
    ekw = bw._eval_kw(cfg)
    step8 = bw.make_window_step(cfg, n, substeps=8)
    recs = []
    for i, tau in enumerate(taus):
        if tau:
            for _ in range((tau - taus[i - 1]) // 8):
                st = step8(st, DT)
        # The state lives Morton-sorted: original ids map to its slots.
        slots = st.lists.inv_order.long()[idx]
        exact = exact_accel_at(st.pos[:, slots], st.pos, st.mass, cfg.G,
                               cfg.softening)
        stale = bw.eval_accel_sorted(st.lists, st.pos, st.mass, DT, **ekw)
        med_s, p99_s, rms_s = err_stats(stale, exact, slots)
        fresh = bw.window_bh_accel(st.pos, st.vel, st.mass, cfg)
        med_f, p99_f, rms_f = err_stats(fresh, exact, slots)
        drift = (st.pos - st.lists.ref_pos).abs()
        rec = {"tau": tau, "skin": skin,
               "stale": {"med": med_s, "p99": p99_s, "rms": rms_s},
               "fresh": {"med": med_f, "p99": p99_f, "rms": rms_f},
               "drift_max": round(float(drift.max()), 2),
               "drift_p95": round(float(torch.quantile(
                   drift.amax(0).double().cpu(), 0.95)), 3),
               "refresh_interval": refresh_iv,
               "refreshes": step8.refreshes}
        out(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=1_000_000)
    ap.add_argument("skin", type=float, nargs="?", default=6.0)
    ap.add_argument("wg", type=int, nargs="?", default=2)
    ap.add_argument("gsz", type=int, nargs="?", default=256)
    ap.add_argument("refresh_iv", type=int, nargs="?", default=0)
    ap.add_argument("taus", nargs="?", default=None,
                    help="comma-separated multiples of 8")
    ap.add_argument("--sample", type=int, default=SAMPLE,
                    help="sampled bodies (the accuracy protocol's: 4096)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "staleness_scan")
    print(device_line(dev), flush=True)
    taus = None if a.taus is None else [int(t) for t in a.taus.split(",")]
    scan(a.n, a.skin, a.wg, a.gsz, a.refresh_iv, taus, dev, a.sample)
    return 0


if __name__ == "__main__":
    sys.exit(main())
