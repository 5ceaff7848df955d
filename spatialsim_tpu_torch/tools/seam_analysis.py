"""The share of far-list entries within a few group radii: the Morton
window's seam overhead (port of ``scripts/seam_analysis.py``).

    python -m spatialsim_tpu_torch.tools.seam_analysis [n]
        [--device cuda|cpu]

The galaxy (seed 0) at ``n`` bodies (default 262,144) at the script's
configuration (theta 0.8, softening 2, spawn radius 500, the window
engine's defaults, resolved), its dense lists built without
accelerations (``pool_tile=0``) on the device; then, on the host in
numpy as the script computes it, each group's centre (the mean of its
sorted bodies) and radius (the farthest body from it), every live far
entry's distance from its group's centre over that radius, and the share
of the entries within 1.5, 2, 3, 5 and 10 radii, and of their mass within
2 and 3.  Entries that close are spatially near mass the contiguous window
missed: the payload of a near-group list.  The sorted bodies are
``pos[:, order]`` over every slot, the group padding included: ``order``'s
pad slots repeat the last sorted body's id (in both packages), so every id
lies within the bodies.  No kernel of the port runs.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import (
    add_bodies, bodies_of, device_of, initial_conditions)

RADII = (1.5, 2.0, 3.0, 5.0, 10.0)
MASS_RADII = (2.0, 3.0)


def seam_config(n: int) -> NBodyConfig:
    """The script's configuration, resolved for ``n``."""
    return resolve_config(NBodyConfig(
        num_bodies=n, theta=0.8, softening=2.0, spawn_radius=500.0,
        engine="window"), n)


def seam_shares(s_pos, far, far_n, gsz):
    """The script's numbers from numpy arrays: sorted ``(3, npad)``
    positions, the dense ``(ng, R, L)`` far entries and ``(ng,)`` far_n:
    ``{"total", "ng", "within": {radii: share}, "mass_within": {radii:
    share}}``."""
    npad = s_pos.shape[1]
    ng = npad // gsz
    gpos = s_pos.reshape(3, ng, gsz)
    center = gpos.mean(axis=2)
    radius = np.linalg.norm(gpos - center[:, :, None], axis=0).max(axis=1)
    L = far.shape[2]
    valid = np.arange(L)[None, :] < far_n[:, None]
    d = np.linalg.norm(far[:, 0:3, :] - center.T[:, :, None], axis=1)
    ratio = np.where(valid, d / np.maximum(radius, 1e-6)[:, None], np.inf)
    total = int(valid.sum())
    mass_e = np.where(valid, far[:, 6, :], 0.0)
    return dict(total=total, ng=ng,
                within={t: float((ratio < t).sum() / total) for t in RADII},
                mass_within={t: float(mass_e[ratio < t].sum() / mass_e.sum())
                             for t in MASS_RADII})


def run(n=262_144, device="cuda", out=print):
    """The shares; returns :func:`seam_shares`' record with ``n``."""
    device = torch.device(device)
    cfg = seam_config(n)
    pos, vel, mass = initial_conditions("galaxy", n, cfg.spawn_radius,
                                        cfg.G, device)
    lists = bw.build_lists(pos, vel, mass,
                           **{**bw._build_kw(cfg), "pool_tile": 0})
    s_pos = pos[:, lists.order.long()].cpu().numpy()
    rec = seam_shares(s_pos, lists.far.cpu().numpy(),
                      lists.far_n.cpu().numpy(), cfg.group_size)
    total, ng = rec["total"], rec["ng"]
    out(f"n={n:,} ng={ng} far entries total={total:,} "
        f"mean/group={total / ng:.0f}", flush=True)
    for t, frac in rec["within"].items():
        out(f"  entries within {t:4.1f} group radii: {frac * 100:5.1f}%  "
            f"({frac:.6f})", flush=True)
    for t, frac in rec["mass_within"].items():
        out(f"  far MASS within {t:4.1f} group radii: {frac * 100:5.1f}%  "
            f"({frac:.6f})", flush=True)
    return dict(rec, n=n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 262_144)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "seam_analysis")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
