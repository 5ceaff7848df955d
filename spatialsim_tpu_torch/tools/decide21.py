"""The rebuild traversal by phase, each phase replaced by its stand-in
(``_traverse_global(..., ablate=...)``), and the rebuild's other parts
on the same inputs (port of ``scripts/decide21.py``).

    python -m spatialsim_tpu_torch.tools.decide21 [n] [--device cuda|cpu]

The galaxy (seed 1) at ``n`` bodies (default 1M) at the script's
configuration (theta 0.8, resolved, not calibrated: the default worklist
caps and the budget's pool cap).  Chained marginals
(:mod:`~spatialsim_tpu_torch.tools.chain`: host clock and device time)
of the Morton sort and the sorted state's gathers, the octree, the
ranges-mode traversal with no phase ablated, with each of "gather_cell",
"gather_group", "emit", "sliver" and "expand" replaced, and with all five
(the floor), each with its phase cost against the baseline; then the
pooled ranges finish and the dense finish on the baseline traversal's
outputs.  Each traversal line ends with the device's peak allocation;
the last line gives each call's device busy time under ``torch.profiler``
beside its wall.
The script's ``probe_all`` has no counterpart: eager PyTorch drops no
work whose result is unread.
"""

from __future__ import annotations

import argparse
import sys

from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.chain import (
    busy_line, galaxy_bodies, galaxy_config, marginal, octree, peak_text,
    presort, traversal_inputs)
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of

VARIANTS = (
    ("baseline", ()),
    ("-gather_cell", ("gather_cell",)),
    ("-gather_group", ("gather_group",)),
    ("-emit", ("emit",)),
    ("-sliver", ("sliver",)),
    ("-expand", ("expand",)),
    ("floor(all off)", bw.TRAVERSAL_PHASES),
)


def run(n=1_000_000, device="cuda", out=print):
    """The decomposition; returns ``{part: Marginal}`` (traversal parts
    keyed ``traverse[name]``)."""
    cfg = galaxy_config(n)
    kw = bw._build_kw(cfg)
    out(f"platform={device.type} n={n} depth={kw['max_depth']} "
        f"gsz={kw['group_size']} wg={kw['window_groups']} "
        f"L={kw['list_cap']} pool={kw['pool_tile']} emit={kw['emit_mode']}",
        flush=True)
    pos, vel, mass, acc = galaxy_bodies(cfg, n, device)
    res = {}
    res["sort"] = marginal(lambda: presort(pos, vel, mass, acc, kw), device)
    out(f"  sort+gathers marginal: {res['sort'].line()}", flush=True)
    st = presort(pos, vel, mass, acc, kw)
    res["octree"] = marginal(lambda: octree(kw, st), device)
    out(f"  octree marginal: {res['octree'].line()}", flush=True)
    tree, bmin, bmax, ng, tkw, budget = traversal_inputs(kw, st)
    out(f"  budget={budget} wl_caps={list(tkw['wl_caps'])}", flush=True)
    peak_text(device)

    base = None
    for name, abl in VARIANTS:
        m = marginal(lambda abl=abl: bw._traverse_global(
            tree, bmin, bmax, ng, **tkw, ablate=abl), device)
        res[f"traverse[{name}]"] = m
        delta = ""
        if base is None:
            base = m
        else:
            delta = f"  (phase cost {base.host - m.host:+.3f} ms"
            if m.device is not None:
                delta += f", device {base.device - m.device:+.3f} ms"
            delta += ")"
        out(f"  traverse[{name}] marginal: {m.line()}{delta}; "
            f"{peak_text(device)}", flush=True)

    _far, far_range, far_n, sl_s, sl_e, sl_n, rsd, _wl = \
        bw._traverse_global(tree, bmin, bmax, ng, **tkw)
    half, order, order_pad, _, s_pos, s_vel, s_mass, s_acc = st
    tile = kw["pool_tile"] or 512
    cap = bw.pool_cap_tiles(budget, ng, tile, s_pos.shape[1])
    fin = (far_range, far_n, sl_s, sl_e, sl_n, rsd, s_pos, s_vel, s_mass,
           order, order_pad, pos, n, kw["list_cap"])
    res["finish_pool"] = marginal(lambda: bw._finish_pool_ranges(
        *fin, tile=tile, cap_tiles=cap, s_acc=s_acc), device)
    out(f"  finish_pool marginal: {res['finish_pool'].line()}; "
        f"{peak_text(device)}", flush=True)
    res["finish_dense"] = marginal(lambda: bw._finish_lists(
        None, *fin, s_acc=s_acc), device)
    out(f"  finish_dense marginal: {res['finish_dense'].line()}; "
        f"{peak_text(device)}", flush=True)
    out(busy_line([(f"traverse[{name}]", lambda abl=abl: bw._traverse_global(
        tree, bmin, bmax, ng, **tkw, ablate=abl)) for name, abl in VARIANTS]
        + [("finish_pool", lambda: bw._finish_pool_ranges(
            *fin, tile=tile, cap_tiles=cap, s_acc=s_acc)),
           ("finish_dense", lambda: bw._finish_lists(
               None, *fin, s_acc=s_acc))], device), flush=True)
    out("done", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide21")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
