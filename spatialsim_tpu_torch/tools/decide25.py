"""Occupancy-tight octree level caps (headroom 2): what they cost to
measure, and what they buy in the octree and the rebuild (port of
``scripts/decide25.py``).

    python -m spatialsim_tpu_torch.tools.decide25 [n] [--device cuda|cpu]

The galaxy (seed 1) at ``n`` bodies (default 1M) at the script's
configuration.  Prints ``_measure_tree_caps``' caps and its host ms
(ended by a synchronise), then with the full caps and the tight ones:
the octree's chained marginal on the presorted state, the ranges
build's checksums (far_n's sum, the pool's summed |mass|: equal while
the cells fit) and the ranges rebuild's chained marginal
(:mod:`~spatialsim_tpu_torch.tools.chain`: host clock and device time).
"""

from __future__ import annotations

import argparse
import sys
import time

from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.chain import (
    build_kw, galaxy_bodies, galaxy_config, marginal, octree, presort, sync)
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of


def run(n=1_000_000, device="cuda", out=print):
    """The A/B; returns ``{"caps", "caps_ms", "sums", "octree",
    "rebuild"}`` (the last two ``{full|tight: Marginal}``)."""
    cfg = galaxy_config(n)
    kw = bw._build_kw(cfg)
    pos, vel, mass, acc = galaxy_bodies(cfg, n, device)
    sync(device)
    t = time.perf_counter()
    caps = bw._measure_tree_caps(cfg, pos)
    sync(device)
    caps_ms = (time.perf_counter() - t) * 1e3
    out(f"platform={device.type} n={n} tree_caps={list(caps)} measured in "
        f"{caps_ms:.3f} ms", flush=True)
    # The octree without accelerations, as the script builds it.
    st = presort(pos, vel, mass, None, kw)
    res = dict(caps=caps, caps_ms=caps_ms, sums={}, octree={}, rebuild={})
    for name, lc in (("full", ()), ("tight", caps)):
        m = marginal(lambda lc=lc: octree(kw, st, lc, with_acc=False),
                     device)
        res["octree"][name] = m
        out(f"  octree[{name}] marginal: {m.line()}", flush=True)
    bkw = build_kw(kw)
    for name, lc in (("full", ()), ("tight", caps)):
        lists = bw.build_lists(pos, vel, mass, acc, emit_mode="ranges",
                               tree_caps=lc, **bkw)
        s = (int(lists.far_n.long().sum()),
             float(lists.pool[:, 6, :].abs().sum()))
        res["sums"][name] = s
        out(f"  [{name}] far_n_sum={s[0]} mass_abs={s[1]:.4f}", flush=True)
        del lists
    for name, lc in (("full", ()), ("tight", caps)):
        m = marginal(lambda lc=lc: bw.build_lists(
            pos, vel, mass, acc, emit_mode="ranges", tree_caps=lc, **bkw),
            device)
        res["rebuild"][name] = m
        out(f"  rebuild[{name}] marginal: {m.line()}", flush=True)
    out("done", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide25")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
