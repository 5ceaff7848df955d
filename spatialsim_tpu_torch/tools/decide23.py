"""Compact emission against ranges emission: the whole rebuild, A/B
(port of ``scripts/decide23.py``).

    python -m spatialsim_tpu_torch.tools.decide23 [n] [--device cuda|cpu]

The galaxy (seed 1) at ``n`` bodies (default 1M) at the script's
configuration.  For "ranges", "compact" and "compact-mm" (on the port
one path: both sort within tiles): the build's checksums (far_n's sum,
the pool's summed |mass| and its sum times 1e-6), equal across the modes,
then each rebuild's chained marginal
(:mod:`~spatialsim_tpu_torch.tools.chain`: host clock and device time).
"""

from __future__ import annotations

import argparse
import sys

from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.chain import (
    build_kw, galaxy_bodies, galaxy_config, marginal)
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of

MODES = ("ranges", "compact", "compact-mm")


def run(n=1_000_000, device="cuda", out=print):
    """The A/B; returns ``{"sums": {mode: ...}, "rebuild": {mode:
    Marginal}}``."""
    cfg = galaxy_config(n)
    kw = bw._build_kw(cfg)
    out(f"platform={device.type} n={n} depth={kw['max_depth']} "
        f"gsz={kw['group_size']} wg={kw['window_groups']} "
        f"L={kw['list_cap']} pool={kw['pool_tile']}", flush=True)
    pos, vel, mass, acc = galaxy_bodies(cfg, n, device)
    bkw = build_kw(kw)
    res = dict(sums={}, rebuild={})
    for mode in MODES:
        lists = bw.build_lists(pos, vel, mass, acc, emit_mode=mode, **bkw)
        s = (int(lists.far_n.long().sum()),
             float(lists.pool[:, 6, :].abs().sum()),
             float((lists.pool * 1e-6).sum()))
        res["sums"][mode] = s
        out(f"  [{mode}] far_n_sum={s[0]} mass_abs={s[1]:.4f} "
            f"pool_sum={s[2]:.4f}", flush=True)
        del lists
    for mode in MODES:
        m = marginal(lambda mode=mode: bw.build_lists(
            pos, vel, mass, acc, emit_mode=mode, **bkw), device)
        res["rebuild"][mode] = m
        out(f"  rebuild[{mode}] marginal: {m.line()}", flush=True)
    out("done", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide23")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
