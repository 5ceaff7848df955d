"""Compact emission by stage: the traversal alone and the finish alone,
ranges against compact, on the same inputs (port of
``scripts/decide26.py``).

    python -m spatialsim_tpu_torch.tools.decide26 [n] [--device cuda|cpu]

The galaxy (seed 1) at ``n`` bodies (default 1M) at the script's
configuration, presorted, its octree with zero accelerations, the
default worklist caps.  Chained marginals
(:mod:`~spatialsim_tpu_torch.tools.chain`: host clock and device time)
of the ranges-mode traversal with ``emit_compact`` off, on and "mm" (on
the port the same sort within tiles as on), then of the pooled ranges
finish and the compact finish, each on its traversal's real outputs.
"""

from __future__ import annotations

import argparse
import sys

from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.chain import (
    galaxy_bodies, galaxy_config, marginal, presort, traversal_inputs)
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of

TRAVERSALS = (("ranges", False), ("compact", True), ("compact-mm", "mm"))


def run(n=1_000_000, device="cuda", out=print):
    """The stages; returns ``{name: Marginal}``."""
    cfg = galaxy_config(n)
    kw = bw._build_kw(cfg)
    out(f"platform={device.type} n={n} gsz={kw['group_size']}", flush=True)
    pos, vel, mass, acc = galaxy_bodies(cfg, n, device)
    st = presort(pos, vel, mass, None, kw)
    half, order, order_pad, s_codes, s_pos, s_vel, s_mass, _ = st
    s_acc = s_pos.new_zeros(s_pos.shape)
    st = (half, order, order_pad, s_codes, s_pos, s_vel, s_mass, s_acc)
    tree, bmin, bmax, ng, tkw, budget = traversal_inputs(kw, st)
    res = {}
    for name, ec in TRAVERSALS:
        m = marginal(lambda ec=ec: bw._traverse_global(
            tree, bmin, bmax, ng, **tkw, emit_compact=ec), device)
        res[f"traverse[{name}]"] = m
        out(f"  traverse[{name}] marginal: {m.line()}", flush=True)

    _f, fr, fn, sls, sle, sln, rsd, _wl = bw._traverse_global(
        tree, bmin, bmax, ng, **tkw)
    _f, emits, fnc, slsc, slec, slnc, rsdc, _wl = bw._traverse_global(
        tree, bmin, bmax, ng, **tkw, emit_compact=True)
    tile = kw["pool_tile"] or 512
    cap = bw.pool_cap_tiles(budget, ng, tile, s_pos.shape[1])
    rest = (s_pos, s_vel, s_mass, order, order_pad, pos, n, kw["list_cap"])
    for name, fn_ in (
            ("finish[ranges]", lambda: bw._finish_pool_ranges(
                fr, fn, sls, sle, sln, rsd, *rest, tile=tile, cap_tiles=cap,
                s_acc=s_acc)),
            ("finish[compact]", lambda: bw._finish_pool_compact(
                emits, fnc, slsc, slec, slnc, rsdc, *rest, tile=tile,
                cap_tiles=cap, emit_offsets=bw._emit_offsets(tkw["wl_caps"]),
                s_acc=s_acc))):
        m = marginal(fn_, device)
        res[name] = m
        out(f"  {name} marginal: {m.line()}", flush=True)
    out("done", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide26")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
