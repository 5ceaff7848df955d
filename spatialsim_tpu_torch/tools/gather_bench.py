"""Packed against separate gathers and scatters of a level's attribute
columns (port of ``scripts/gather_bench.py``).

    python -m spatialsim_tpu_torch.tools.gather_bench [--W 3200000]
        [--C 1000000] [--R 16] [--device cuda|cpu]

R = 16 float32 columns of C = 1M cells, W = 3.2M random slots (the
script's sizes).  Each operation is timed once a call, the fastest of 5
after a warm-up: on the host clock ended by a synchronise and by CUDA
events, in ms and ns a slot.  ``sep_scatter_add`` is ``index_add_`` on
float columns: the priced primitive, not a path of the port (its atomics
add in no fixed order, so the rebuild's float sums never use it).  The
data come from numpy's ``default_rng(0)``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from spatialsim_tpu_torch.tools.chain import chain_ms
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import device_of

C, W, R = 1_000_000, 3_200_000, 16
REPS = 5


def run(w=W, c=C, r=R, device="cuda", out=print):
    """The operations; returns ``{name: (host ms, device ms | None)}``."""
    rng = np.random.default_rng(0)
    packed = torch.as_tensor(rng.standard_normal((r, c), np.float32),
                             device=device)
    cols = list(packed.clone())
    packed_t = packed.T.contiguous()
    idx = torch.as_tensor(rng.integers(0, c, w), device=device)
    vals = torch.as_tensor(rng.standard_normal((r, w), np.float32),
                           device=device)
    vals_t = vals.T.contiguous()

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def sep_scatter():
        outs = [zeros(c) for _ in vals]
        for o, v in zip(outs, vals):
            o[idx] = v
        return outs

    def packed_scatter():
        o = zeros(r, c)
        o[:, idx] = vals
        return o

    def packed_scatter_rows():
        o = zeros(c, r)
        o[idx] = vals_t
        return o

    def sep_add():
        return [zeros(c).index_add_(0, idx, v) for v in vals]

    res = {}
    for name, fn in (
            ("one_gather (1 col, W idx)", lambda: cols[0][idx]),
            ("sep_gather (16 cols)", lambda: [x[idx] for x in cols]),
            ("packed_gather (16,C)[:,idx]", lambda: packed[:, idx]),
            ("packed_gather_rows (C,16)[idx]", lambda: packed_t[idx]),
            ("sep_scatter (16 cols)", sep_scatter),
            ("packed_scatter (16,C).at[:,idx]", packed_scatter),
            ("packed_scatter_rows (C,16).at[idx]", packed_scatter_rows),
            ("sep_scatter_add (16 cols)", sep_add)):
        host, dev = chain_ms(fn, 1, device, REPS)
        res[name] = (host, dev)
        line = f"{name:38s} {host:8.3f} ms   {host / w * 1e6:7.4f} ns/slot"
        line += ("; device not measured" if dev is None else
                 f"; device {dev:8.3f} ms {dev / w * 1e6:7.4f} ns/slot")
        out(line, flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--W", type=int, default=W)
    ap.add_argument("--C", type=int, default=C)
    ap.add_argument("--R", type=int, default=R)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "gather_bench")
    print(device_line(dev), flush=True)
    run(a.W, a.C, a.R, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
