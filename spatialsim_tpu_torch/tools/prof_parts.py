"""Decompose the rebuild: sort / gather / octree / full build / eval at
scale (port of ``scripts/prof_parts.py``).

    python -m spatialsim_tpu_torch.tools.prof_parts [n] [--device cuda|cpu]

The galaxy at ``n`` bodies (default 1M) at the script's configuration
(rebuild interval 48, skin 2), resolved and calibrated as the engine
runs it.  Each part is timed by CUDA events around 3 calls after one
warm-up and a synchronise (their mean; the host clock on the CPU): the
Morton sort (bounds, codes, the stable argsort), the sorted
state's gather, the octree, the whole ``build_lists`` (which includes
the three), the traversal and finish by difference, and one pooled
eval.  One process a run.
"""

from __future__ import annotations

import argparse
import sys

import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.ops.bounds import compute_bounds
from spatialsim_tpu_torch.ops.morton import morton_encode
from spatialsim_tpu_torch.ops.octree import build_octree
from spatialsim_tpu_torch.tools.eval_ab import device_line, time_ms
from spatialsim_tpu_torch.tools.oracle import device_of, initial_conditions

REPS = 3


def parts(n=1_000_000, device="cuda", out=print):
    """The decomposition; returns {part: ms}."""
    device = torch.device(device)
    cfg = resolve_config(NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, damping=1.0,
        spawn_radius=500.0, distribution="galaxy", engine="window",
        skin=2.0, rebuild_interval=48, rebuild_drift_mode="off"), n)
    pos, vel, mass = initial_conditions("galaxy", n, cfg.spawn_radius,
                                        cfg.G, device)
    cfg = bw.calibrate_config(cfg, pos, vel, mass)
    out(f"n={n:,} depth={cfg.max_depth} gsz={cfg.group_size} "
        f"L={cfg.list_capacity} pool_tile={cfg.pool_tile} "
        f"device={device.type}", flush=True)
    gsz, depth = cfg.group_size, cfg.max_depth
    npad = -(-n // gsz) * gsz
    pad = npad - n

    def sort_part():
        half = compute_bounds(pos)
        codes = morton_encode(pos, half, depth)
        return codes, torch.argsort(codes, stable=True), half

    def gather_part(codes, order):
        order_pad = torch.cat([order, order[-1:].expand(pad)])
        s_mass = mass[order_pad].clone()
        s_mass[n:] = 0.0
        return (codes[order_pad], pos[:, order_pad], vel[:, order_pad],
                s_mass)

    codes, order, half = sort_part()
    s_codes, s_pos, s_vel, s_mass = gather_part(codes, order)

    def octree_part():
        return build_octree(s_codes, s_pos, s_mass, half, max_depth=depth,
                            start_level=2, n=npad, sorted_vel=s_vel,
                            level_caps=tuple(cfg.tree_caps or ()))

    kw = bw._build_kw(cfg)
    acc0 = torch.zeros_like(pos)
    ms = {"sort+morton": time_ms(sort_part, REPS, device),
          "state gather": time_ms(lambda: gather_part(codes, order), REPS,
                                  device),
          "octree": time_ms(octree_part, REPS, device),
          "build_lists": time_ms(
              lambda: bw.build_lists(pos, vel, mass, acc0, **kw), REPS,
              device)}
    ms["traversal+finish"] = (ms["build_lists"] - ms["sort+morton"]
                              - ms["state gather"] - ms["octree"])
    lists = bw.build_lists(pos, vel, mass, acc0, **kw)
    o = lists.order[:n].long()
    pos_s, mass_s = pos[:, o].contiguous(), mass[o].contiguous()
    ms["eval"] = time_ms(lambda: bw.eval_accel_sorted(
        lists, pos_s, mass_s, 0.02, **bw._eval_kw(cfg)), REPS, device)
    for k, v in ms.items():
        note = "  (incl. all above)" if k == "build_lists" else ""
        out(f"{k + ':':<18}{v:10.3f} ms{note}", flush=True)
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "prof_parts")
    print(device_line(dev), flush=True)
    parts(a.n, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
