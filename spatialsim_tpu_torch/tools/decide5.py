"""The eval's cost decomposition (far lists off) and the boids
accumulation A/B (port of ``scripts/decide5.py``).

    python -m spatialsim_tpu_torch.tools.decide5 [n] [--boids 500000 100000]
        [--device cuda|cpu]

N-body: the galaxy (seed 0) at ``n`` bodies (default 1M) at the round-3
sweeps' configuration, group 256, window 1, list cap 6,144, built with
zero accelerations (pooled at these sizes), then ``eval_accel_sorted``
(kernel 2 on a card for pooled lists) in the script's six rows: the TPU
kernel's target block ``iblk`` at 256, 128, 64 and 32, and with far_n
set to 0 at 256 and 64.  ``iblk`` has no counterpart on the card (only
the dense kernel's ``nouttr`` block sums read a block size): every row
runs the card's one instance, and the label says so.  Each row is the
fastest of 3 after a warm-up (host clock ended by a synchronise, and
CUDA events), with its largest difference from the first row over max|a|
(nan for the far-free rows).

Boids: for each flock size (the script's 500K, then 100K), the uniform
flock of :mod:`~spatialsim_tpu_torch.tools.decide12` padded to whole
groups, then one call of the first pass's accumulation, the fastest of 3
after a warm-up: "xla" is the port's plain version
(``ops/boids_ops.window_accumulate_reference``), "pallas" kernel 4's
wrapper (``ops/boids_window_kernel.boids_window_accumulate``).
"""

from __future__ import annotations

import argparse
import sys

import torch

from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools import round3 as r3
from spatialsim_tpu_torch.tools.decide12 import ROWS as BOIDS_ROWS
from spatialsim_tpu_torch.tools.decide12 import padded_flock
from spatialsim_tpu_torch.tools.decide16 import SIZES
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of

# The script's rows: (tag, far lists kept, iblk).
ROWS = (("W1_iblk256", True, 256), ("W1_iblk128", True, 128),
        ("W1_iblk64", True, 64), ("W1_iblk32", True, 32),
        ("W1_nofar_iblk256", False, 256), ("W1_nofar_iblk64", False, 64))


def nbody_part(n, device="cuda", out=print):
    """The N-body rows; returns ``{tag: ((host, device) ms, dev)}``."""
    device = torch.device(device)
    base = r3.ab_config(n)
    pos, vel, mass = r3.initial_state(base, device)
    cfg = base.replace(group_size=256, window_groups=1, list_capacity=6144)
    lists = bw.build_lists(pos, vel, mass, torch.zeros_like(pos),
                           **bw._build_kw(cfg))
    pos_s, _, mass_s = r3.sorted_state(lists, pos, vel, mass)
    nofar = lists._replace(far_n=torch.zeros_like(lists.far_n))
    out(f"# evals: {r3.eval_kernel(lists)}", flush=True)
    ekw = r3.eval_kw(cfg)
    res, ref = {}, None
    for tag, keep, iblk in ROWS:
        lst = lists if keep else nofar

        def call(lst=lst):
            return bw.eval_accel_sorted(lst, pos_s, mass_s, r3.DT, **ekw)
        t = r3.timed(call, device)
        a = call()
        if tag == "W1_iblk256":
            ref = a
        dev = (float((a - ref).abs().max() / ref.abs().max())
               if ref is not None and keep else float("nan"))
        res[tag] = (t, dev)
        out(f"{tag}: {t[0]:.1f} ms (dev {dev:.2e})  ({t[0]:.4f}; "
            f"{r3.dev_text(t)}){r3.no_counterpart(f'iblk={iblk}')}",
            flush=True)
    return res


def boids_part(n, device="cuda", out=print):
    """The boids rows at one flock size; returns ``{tag: (host, device)
    ms}``."""
    device = torch.device(device)
    ppos, pvel, pcol, kw = padded_flock(n, device, out)
    res = {}
    for tag, fn, what in BOIDS_ROWS:
        t = res[tag] = r3.timed(lambda fn=fn: fn(ppos, pvel, pcol, None,
                                                 **kw), device)
        out(f"boids accumulate [{tag}]: {t[0]:.1f} ms  ({t[0]:.4f}; "
            f"{r3.dev_text(t)}) -- {what}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--boids", type=int, nargs="*", default=list(SIZES),
                    help="flock sizes (default 500,000 and 100,000; none: "
                         "the N-body part only)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide5")
    print(device_line(dev), flush=True)
    print(f"platform={dev.type}", flush=True)
    nbody_part(bodies_of(a), dev)
    for b in a.boids:
        boids_part(b, dev)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
