"""Window-engine force error against a direct-sum oracle at scale (port of
``scripts/nbody_error.py``).

    python -m spatialsim_tpu_torch.tools.nbody_error [n] [--theta T]
        [--depth D] [--group-size G] [--list-cap L] [--budget B] [--wg W]
        [--skin S] [--distribution NAME] [--sample K] [--quad]
        [--scale X] [--device cuda|cpu]

Samples bodies, computes their EXACT accelerations by direct summation
over all N bodies (:mod:`~spatialsim_tpu_torch.tools.oracle`: kernel 1's
targets-and-sources mode on the card), and prints the window engine's
relative force error (median / p99 / rms of |da|/|a|, and of |da| over
the rms |a|) as one JSON line.  This is the gate for depth /
worklist-budget / list-capacity tuning: faster configs must keep errors
at the theta level.  The lists are dense (``pool_tile=0``): they
evaluate the same forces as the pool without its cap, which the JAX
package's default sets too small at 1M (``ROADMAP.md`` Queue 3); the
worklist caps stay what the flags give.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import (
    _np64, device_of, exact_accel_at, initial_conditions, sample_ids)


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, nargs="?", default=1_000_000)
    p.add_argument("--theta", type=float, default=0.8)
    p.add_argument("--depth", type=int, default=9)
    p.add_argument("--group-size", type=int, default=256)
    p.add_argument("--list-cap", type=int, default=6144)
    p.add_argument("--budget", type=int, default=0)
    p.add_argument("--wg", type=int, default=3)
    p.add_argument("--skin", type=float, default=6.0)
    p.add_argument("--distribution", default="galaxy")
    p.add_argument("--sample", type=int, default=2048)
    p.add_argument("--quad", action="store_true")
    p.add_argument("--scale", type=float, default=1.0,
                   help="quad_accept_scale (with --quad)")
    p.add_argument("--device", default="cuda")
    return p


def run(args, device, out=print):
    """The measurement for parsed ``args``; returns its JSON record."""
    n = args.n
    cfg = NBodyConfig(
        num_bodies=n, theta=args.theta, G=0.1, softening=2.0,
        spawn_radius=500.0, distribution=args.distribution, engine="window",
        max_depth=args.depth, group_size=args.group_size,
        window_groups=args.wg, list_capacity=args.list_cap, skin=args.skin,
        worklist_budget=args.budget, use_quadrupole=args.quad,
        quad_accept_scale=args.scale, pool_tile=0)
    pos, vel, mass = initial_conditions(args.distribution, n,
                                        cfg.spawn_radius, cfg.G, device)
    acc = bw.window_bh_accel(pos, vel, mass, cfg)
    idx = torch.as_tensor(sample_ids(n, args.sample), device=device)
    exact = exact_accel_at(pos[:, idx], pos, mass, cfg.G, cfg.softening)
    a, e = _np64(acc[:, idx]), _np64(exact)
    mag = np.linalg.norm(e, axis=0)
    err = np.linalg.norm(a - e, axis=0) / np.maximum(mag, 1e-12)
    # Per-body relative error explodes where the NET force nearly cancels
    # (cluster centres); the rms-normalized variant divides by the rms
    # force magnitude instead (the tests' convention).
    err_n = np.linalg.norm(a - e, axis=0) / np.sqrt((mag ** 2).mean())
    rec = {
        "n": n, "depth": args.depth, "budget": args.budget,
        "list_cap": args.list_cap, "gsz": args.group_size,
        "theta": args.theta,
        "err_median": float(np.median(err)),
        "err_p99": float(np.percentile(err, 99)),
        "err_rms": float(np.sqrt((err ** 2).mean())),
        "relrms_median": float(np.median(err_n)),
        "relrms_p99": float(np.percentile(err_n, 99)),
        "relrms_rms": float(np.sqrt((err_n ** 2).mean())),
    }
    out(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = device_of(args.device, "nbody_error")
    print(device_line(dev), flush=True)
    run(args, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
