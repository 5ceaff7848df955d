"""The emission primitives head to head at one worklist level's width
(port of ``scripts/decide24.py``).

    python -m spatialsim_tpu_torch.tools.decide24 [--W 4194304] [--ng 3907]
        [--L 6144] [--density 0.35] [--device cuda|cpu]

The script's shape by default: W = 4,194,304 slots at 35% density, 3,907
groups, list cap 6,144 (the 1M galaxy's level 8).  Chained marginals
(:mod:`~spatialsim_tpu_torch.tools.chain`: host clock and device time)
of a) the flat cumulative sum over W, b) the two range columns'
scatter into ``(ng * L,)`` slots, c) the segment sum W -> ng, d) and e)
``_tile_compact`` (the port has one method, the sort: e is d again,
labelled as the script labels it), f) ``_tile_assemble`` with cap W and
g) a packed ``(2, T)[:, seg]`` gather at W.  The columns are int64, the
port's index type; the segment sum is the port's float form
(``octree._segment``, a fixed-order ``torch.segment_reduce``).  The data
come from numpy's ``default_rng(0)`` (the script's are JAX's PRNG).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.ops.octree import _segment
from spatialsim_tpu_torch.tools.chain import marginal
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import device_of

W, NG, L, DENS = 4_194_304, 3_907, 6_144, 0.35


def inputs(w, ng, L, dens, device):
    """(mask, cs, ce, flat, gidx) as the script makes them."""
    rng = np.random.default_rng(0)
    mask = rng.random(w) < dens
    cs = rng.integers(0, 1_000_000, w)
    ce = cs + rng.integers(1, 64, w)
    gidx = np.sort(rng.integers(0, ng, w))
    flat = np.where(mask, np.clip(gidx, 0, ng - 1) * L + np.arange(w) % L,
                    ng * L)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (mask, cs, ce, flat, gidx))


def run(w=W, ng=NG, L=L, dens=DENS, device="cuda", out=print):
    """The primitives; returns ``{label: Marginal}``."""
    tile = bw._COMPACT_TILE
    w = -(-w // tile) * tile
    out(f"platform={device.type} W={w} dens={dens}", flush=True)
    mask, cs, ce, flat, gidx = inputs(w, ng, L, dens, device)

    def scatter2():
        a = torch.zeros((ng * L + 1,), dtype=cs.dtype, device=device)
        b = torch.zeros((ng * L + 1,), dtype=cs.dtype, device=device)
        a[flat] = cs
        b[flat] = ce
        return a, b

    comp, tcnt = bw._tile_compact(mask, (cs, ce))
    T = w // tile
    rng = np.random.default_rng(1)
    tbl = torch.stack([torch.arange(T, device=device),
                       torch.arange(T, device=device) * 2])
    seg = torch.as_tensor(np.sort(rng.integers(0, T, w)), device=device)
    cases = (
        ("a) cumsum W i32", lambda: torch.cumsum(cs & 1, 0)),
        ("b) 2-col scatter (ng*L)", scatter2),
        ("c) segment_sum W->ng",
         lambda: _segment((cs & 1).to(torch.float32), gidx, ng)),
        ("d) tile_compact sort", lambda: bw._tile_compact(mask, (cs, ce))),
        ("e) tile_compact matmul", lambda: bw._tile_compact(mask, (cs, ce))),
        ("f) tile_assemble cap=W", lambda: bw._tile_assemble(tcnt, comp, w)),
        ("g) packed (2,T)[:,seg] gather W", lambda: tbl[:, seg]),
    )
    res = {}
    for name, fn in cases:
        res[name] = m = marginal(fn, device)
        note = " (the sort: the port has one method)" if name[0] == "e" else ""
        out(f"  {name}: {m.line()}{note}", flush=True)
    out("done", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--W", type=int, default=W)
    ap.add_argument("--ng", type=int, default=NG)
    ap.add_argument("--L", type=int, default=L)
    ap.add_argument("--density", type=float, default=DENS)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide24")
    print(device_line(dev), flush=True)
    run(a.W, a.ng, a.L, a.density, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
