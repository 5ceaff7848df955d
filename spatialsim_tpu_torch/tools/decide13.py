"""The rebuild's worklist budget down and group size up: rebuild ms
against the fresh lists' force error (port of ``scripts/decide13.py``).

    python -m spatialsim_tpu_torch.tools.decide13 [n] [--device cuda|cpu]

The galaxy (seed 0) at ``n`` bodies (default 1M) at the script's
configuration (theta 0.8, skin 2, rebuild interval 48, drift off,
resolved), list cap 6,144, for each of the script's (group size, window
groups, worklist budget) variants: the rebuild (the fastest of 3 after a
warm-up: host clock ended by a synchronise, and CUDA events), one eval
of the fresh lists (``eval_accel_sorted``: kernel 2 on a card) and the
per-body error |da|/|a| on 2,048 sampled bodies (``default_rng(1)``)
against the direct sum of :mod:`~spatialsim_tpu_torch.tools.oracle`
(kernel 1's targets-and-sources mode on a card): median, p99 and rms,
far_n's mean and max, and the groups the pool folded whole out of all
(``folded=F/G``, far_n <= 1: the count ``tools/prof_rebuild.py``
prints).  The builds are uncalibrated, so the pool's tile cap is the
default one the budget sizes: where the emissions outgrow it, whole
groups fold into one residual entry.

After the script's six variants one more, labelled ``dense``: group 256,
window 1, the auto budget with ``pool_tile=0`` (dense lists, kernel 3 on a
card), which no pool cap can fold.  The script has no such line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.chain import chain_ms
from spatialsim_tpu_torch.tools.eval_ab import ab_config, device_line
from spatialsim_tpu_torch.tools.extreme_run import folded_groups
from spatialsim_tpu_torch.tools.oracle import (
    add_bodies, bodies_of, device_of, exact_accel_at, initial_conditions,
    relative_errors, sample_ids)

SAMPLE = 2048
REPS = 3
# (group size, window groups, worklist budget; 0 = auto, pool tile; None =
# the configuration's): the script's six, then the dense line.
VARIANTS = ((256, 1, 0, None), (256, 1, 3_000_000, None),
            (256, 1, 2_000_000, None), (256, 1, 1_500_000, None),
            (512, 1, 0, None), (256, 2, 2_000_000, None), (256, 1, 0, 0))


def label(gsz, wg, budget, pool_tile=None):
    """A variant's label: the script's, and `` dense`` for pool tile 0."""
    return (f"gsz={gsz} W{wg} B={budget or 'auto'}"
            + (" dense" if pool_tile == 0 else ""))


def run(n=1_000_000, device="cuda", out=print, variants=VARIANTS):
    """The sweep; returns one record per variant."""
    out(f"platform={device.type}", flush=True)
    base = ab_config(n)
    pos, vel, mass = initial_conditions("galaxy", n, base.spawn_radius,
                                        base.G, device)
    idx = torch.as_tensor(sample_ids(n, SAMPLE), device=device)
    exact = exact_accel_at(pos[:, idx], pos, mass, base.G, base.softening)
    acc0 = torch.zeros_like(pos)
    recs = []
    for gsz, wg, budget, tile in variants:
        cfg = base.replace(group_size=gsz, window_groups=wg,
                           list_capacity=6144, worklist_budget=budget)
        if tile is not None:
            cfg = cfg.replace(pool_tile=tile)
        kw = bw._build_kw(cfg)
        built = []
        host, dev = chain_ms(lambda: built.append(
            bw.build_lists(pos, vel, mass, acc0, **kw)), 1, device, REPS)
        lists = built[-1]
        del built
        o = lists.order[:n].long()
        acc = bw.eval_accel_sorted(lists, pos[:, o], mass[o], 0.0, G=cfg.G,
                                   softening=cfg.softening, group_size=gsz,
                                   window_groups=wg)
        err = relative_errors(acc[:, lists.inv_order.long()[idx]], exact)
        fn = lists.far_n.cpu().numpy()
        rec = dict(gsz=gsz, wg=wg, budget=budget, pool_tile=tile,
                   label=label(gsz, wg, budget, tile), rebuild_ms=host,
                   rebuild_device_ms=dev, med=float(np.median(err)),
                   p99=float(np.percentile(err, 99)),
                   rms=float(np.sqrt((err ** 2).mean())),
                   far_mean=float(fn.mean()), far_max=int(fn.max()),
                   folded=folded_groups(fn), groups=int(fn.shape[0]))
        recs.append(rec)
        dtext = ("device not measured" if dev is None
                 else f"device {dev:.3f} ms")
        out(f"  {rec['label']}: rebuild "
            f"{host:.3f} ms ({dtext}) | err med={rec['med']:.4f} "
            f"p99={rec['p99']:.4f} rms={rec['rms']:.4f} | "
            f"far mean={rec['far_mean']:.0f} max={rec['far_max']} "
            f"folded={rec['folded']}/{rec['groups']}",
            flush=True)
        del lists, acc
    out("done", flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide13")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
