"""The whole rebuild, A/B: the finish's share by ablation and the
demand-fit worklist caps (port of ``scripts/decide27.py``).

    python -m spatialsim_tpu_torch.tools.decide27 [n] [--device cuda|cpu]

The galaxy (seed 1) at ``n`` bodies (default 1M) at the script's
configuration with occupancy-tight tree caps (``_measure_tree_caps``);
the worklist caps are the default profile's, or demand-fit: each level's
pre-clamp demand from one count-only traversal probe (the one
``calibrate_config`` runs) times 1.30, rounded up to 1024, between the
level's floor and its default.  Prints the demand, the default and fit
caps, the ranges and cell-id builds' checksums on the fit caps (far_n's
sum, the pool's summed |mass| and range rows), then the chained
marginals (:mod:`~spatialsim_tpu_torch.tools.chain`: host clock and
device time, and the device's peak allocation) of ``build_lists`` for
a. ranges, b. ranges with ``ablate=("finish",)`` (a - b: the finish),
c. cell-id, d. ranges on the fit caps, e. cell-id on the fit caps and
f. e without its finish; last, each build's device busy time under
``torch.profiler`` beside its wall.
"""

from __future__ import annotations

import argparse
import sys

from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.ops.octree import level_capacity
from spatialsim_tpu_torch.tools.chain import (
    build_kw, busy_line, galaxy_bodies, galaxy_config, marginal, peak_text)
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of

FIT = 1.30


def fit_caps(demand, defaults, ng, c0):
    """Demand x 1.30 rounded up to 1024, at least the level's floor, at
    most its default."""
    fit = []
    for li, d in enumerate(defaults):
        floor = ng * (c0 if li == 0 else 8)
        tgt = int(max(demand[li] * FIT, floor))
        fit.append(int(min(-(-tgt // 1024) * 1024, d)))
    return tuple(fit)


def checksums(lists):
    """(far_n's sum, the pool's summed |mass|, its range rows' sum).  The
    range rows' sum is exact; the script's wraps at 32 bits (JAX without
    64-bit types)."""
    return (int(lists.far_n.long().sum()),
            float(lists.pool[:, 6, :].abs().sum()),
            int(lists.pool[:, 10:14, :].double().sum()))


def run(n=1_000_000, device="cuda", out=print):
    """The A/B; returns ``{"demand", "defaults", "fit", "sums",
    "rebuild": {name: Marginal}}``."""
    cfg = galaxy_config(n)
    kw = bw._build_kw(cfg)
    gsz = kw["group_size"]
    npad = -(-n // gsz) * gsz
    ng = npad // gsz
    n_levels = kw["max_depth"] - 2 + 1
    pos, vel, mass, acc = galaxy_bodies(cfg, n, device)

    tree_caps = bw._measure_tree_caps(cfg, pos)
    cfg = cfg.replace(tree_caps=tree_caps)
    out(f"platform={device.type} n={n} tree_caps={list(tree_caps)}",
        flush=True)
    budget = kw["worklist_budget"] or bw._auto_budget(npad)
    c0 = level_capacity(2, npad)
    defaults = bw._default_wl_caps(ng, n_levels, budget, c0=c0)
    bkw = build_kw(kw, tree_caps=tree_caps)

    wl = bw._traverse_probe(cfg, pos, vel, mass, defaults)
    demand = wl[n_levels:]
    fit = fit_caps(demand, defaults, ng, c0)
    out(f"  demand={[int(d) for d in demand]}", flush=True)
    out(f"  defaults={list(defaults)} sum={sum(defaults)}", flush=True)
    out(f"  fit caps={list(fit)} sum={sum(fit)}", flush=True)

    sums = {}
    for mode in ("ranges", "cellid"):
        ls = bw.build_lists(pos, vel, mass, acc, emit_mode=mode,
                            wl_caps=fit, **bkw)
        sums[mode] = checksums(ls)
        out(f"  [{mode}] far_n_sum={sums[mode][0]} "
            f"mass_abs={sums[mode][1]:.4f} rng_sum={sums[mode][2]}",
            flush=True)
        del ls
    peak_text(device)

    variants = (
        ("a.ranges", dict(emit_mode="ranges", wl_caps=defaults)),
        ("b.ranges-nofinish", dict(emit_mode="ranges", wl_caps=defaults,
                                   ablate=("finish",))),
        ("c.cellid", dict(emit_mode="cellid", wl_caps=defaults)),
        ("d.ranges-fit", dict(emit_mode="ranges", wl_caps=fit)),
        ("e.cellid-fit", dict(emit_mode="cellid", wl_caps=fit)),
        ("f.cellid-fit-nofinish", dict(emit_mode="cellid", wl_caps=fit,
                                       ablate=("finish",))),
    )
    rebuild = {}
    for name, extra in variants:
        m = marginal(lambda extra=extra: bw.build_lists(
            pos, vel, mass, acc, **extra, **bkw), device)
        rebuild[name] = m
        out(f"  rebuild[{name}] marginal: {m.line()}; {peak_text(device)}",
            flush=True)
    out(busy_line([(name, lambda extra=extra: bw.build_lists(
        pos, vel, mass, acc, **extra, **bkw)) for name, extra in variants],
        device), flush=True)
    out("done", flush=True)
    return dict(demand=[int(d) for d in demand], defaults=defaults, fit=fit,
                sums=sums, rebuild=rebuild)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide27")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
