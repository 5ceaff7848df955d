"""Scan window-engine configs against one shared direct-sum oracle (port of
``scripts/nbody_error_scan.py``).

    python -m spatialsim_tpu_torch.tools.nbody_error_scan [n]
        [--device cuda|cpu]

The oracle is :mod:`~spatialsim_tpu_torch.tools.oracle` (kernel 1's
targets-and-sources mode on the card) at 2,048 sampled bodies.  Also
reports the exact per-step Barnes-Hut engine's error on the same sample
-- the floor set by theta itself; window configs should sit near it.
Each variant's line carries the time of its second build (host clock,
synchronised).  The lists are dense (``pool_tile=0``), as in
:mod:`~spatialsim_tpu_torch.tools.nbody_error`: the worklist budget and
depth under test decide them, not a pool cap.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.ops.barnes_hut import barnes_hut_accel
from spatialsim_tpu_torch.tools.eval_ab import _sync, device_line
from spatialsim_tpu_torch.tools.oracle import (
    device_of, exact_accel_at, initial_conditions, report, sample_ids)

SAMPLE = 2048
VARIANTS = [
    ("win_d9_base", {}),
    ("win_d8", {"max_depth": 8}),
    ("win_d9_budget3M", {"worklist_budget": 3_000_000}),
    ("win_d8_budget3M", {"max_depth": 8, "worklist_budget": 3_000_000}),
    ("win_d9_gsz512", {"group_size": 512, "list_capacity": 8192}),
    ("win_d9_L4096", {"list_capacity": 4096}),
]


def scan(n=1_000_000, device="cuda", out=print):
    """The exact engine's line, then one line a variant of
    :data:`VARIANTS`; returns them."""
    device = torch.device(device)
    base = NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, spawn_radius=500.0,
        distribution="galaxy", engine="window", max_depth=9, group_size=256,
        window_groups=3, list_capacity=6144, skin=6.0, pool_tile=0)
    pos, vel, mass = initial_conditions("galaxy", n, base.spawn_radius,
                                        base.G, device)
    idx = torch.as_tensor(sample_ids(n, min(SAMPLE, n)), device=device)
    exact = exact_accel_at(pos[:, idx], pos, mass, base.G, base.softening)
    out("oracle ready", flush=True)
    recs = []
    # Exact-traversal BH engine = the theta floor.
    acc = barnes_hut_accel(pos, mass, base.replace(max_depth=9))
    recs.append(report("exact_bh_depth9", acc[:, idx], exact, out=out))
    for tag, over in VARIANTS:
        cfg = base.replace(**over)
        acc = bw.window_bh_accel(pos, vel, mass, cfg)
        _sync(device)
        t1 = time.perf_counter()
        acc2 = bw.window_bh_accel(pos, vel, mass, cfg)
        _sync(device)
        t_build = time.perf_counter() - t1
        del acc2
        recs.append(report(tag, acc[:, idx], exact, t_build, out=out))
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "nbody_error_scan")
    print(device_line(dev), flush=True)
    scan(a.n, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
