"""The packed-gather layout at the 20M worklist's widths (port of
``scripts/decide19.py``).

    python -m spatialsim_tpu_torch.tools.decide19 [--n 2000000]
        [--W 4000000] [--device cuda|cpu]

A table of ``k`` float32 rows of ``n`` = 2M columns (numpy's
``default_rng(0)``) and ``W`` = 4M random int32 column ids
(``default_rng(1)``), at k = 6, 10 and 2 (the script's order), gathered
three ways: ``packed (k,n)[:,idx]`` (one gather of every row, then the
sum over k), ``separate k gathers`` (one a row, summed as they come) and
``packed rowsT[idx,:]`` (rows of the transposed ``(n, k)`` table, made
once, summed over k).  Each is a chained marginal: a chain of K calls,
each adding its first sum's integer part modulo 2 to the ids (an id
past the table reads the last column, as JAX's gathers clamp), K = 4
against K = 1, ``(t4 - t1) / 3``
(:func:`~spatialsim_tpu_torch.tools.chain.marginal`: the host clock
ended by a synchronise, and CUDA events), in ms and ns a slot.  No kernel
of the port runs: these are PyTorch's gathers.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from spatialsim_tpu_torch.tools.chain import marginal
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import device_of

N, W = 2_000_000, 4_000_000
KS = (6, 10, 2)


def bench(k, n, w, device="cuda", out=print):
    """The three layouts at one ``k``; returns ``{name: Marginal}``."""
    device = torch.device(device)
    rows = torch.as_tensor(
        np.random.default_rng(0).random((k, n)).astype(np.float32),
        device=device)
    idx0 = torch.as_tensor(
        np.random.default_rng(1).integers(0, n, w).astype(np.int32),
        device=device)
    rows_t = rows.T.contiguous()

    def packed(ix):
        return rows[:, ix].sum(0)

    def separate(ix):
        acc = rows[0][ix]
        for r in range(1, k):
            acc = acc + rows[r][ix]
        return acc

    def packed_cols(ix):
        return rows_t[ix, :].sum(1)

    res = {}
    for name, body in (("packed (k,n)[:,idx]", packed),
                       ("separate k gathers", separate),
                       ("packed rowsT[idx,:]", packed_cols)):
        carry = [idx0]

        def call(body=body):
            c = carry[0]
            # Ids past the table clamp, as JAX's gathers clamp them.
            out0 = body(c.long().clamp(max=n - 1))
            carry[0] = c + out0[:1].to(torch.int32) % 2
        m = res[name] = marginal(call, device, k=4)
        per = m.host / w * 1e6
        out(f"  k={k} W={w // 1000000}M {name}: marginal {m.host:.1f} ms = "
            f"{per:.1f} ns/slot  ({m.line()}; {per:.4f} ns/slot"
            + ("" if m.device is None
               else f", {m.device / w * 1e6:.4f} by events") + ")",
            flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N, help="table columns")
    ap.add_argument("--W", type=int, default=W, help="gathered slots")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide19")
    print(device_line(dev), flush=True)
    print(f"platform={dev.type}", flush=True)
    for k in KS:
        bench(k, a.n, a.W, dev)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
