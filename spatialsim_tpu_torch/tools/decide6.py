"""The eval at 4 and 8 groups a TPU program, with the far lists off, and
the boids accumulation A/B (port of ``scripts/decide6.py``).

    python -m spatialsim_tpu_torch.tools.decide6 [n] [--boids 500000 100000]
        [--device cuda|cpu]

N-body: the galaxy (seed 0) at ``n`` bodies (default 1M) at the round-3
sweeps' configuration, group 256, list cap 6,144, window 1 then 2, built
with zero accelerations (pooled at these sizes), then
``eval_accel_sorted`` (kernel 2 on a card for pooled lists) in the
script's rows ``g4``, ``g8`` and ``g8_nofar`` (far_n set to 0), each the
fastest of 3 after a warm-up (host clock ended by a synchronise, and CUDA
events), with far_n's mean.  The groups a TPU program (``gpp``) has no
counterpart on the card, which runs one block a group: ``g4`` and ``g8``
run the same instance, and the label says so.  The boids rows are
:func:`~spatialsim_tpu_torch.tools.decide5.boids_part`'s.
"""

from __future__ import annotations

import argparse
import sys

import torch

from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools import round3 as r3
from spatialsim_tpu_torch.tools.decide5 import boids_part
from spatialsim_tpu_torch.tools.decide16 import SIZES
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of

WINDOWS = (1, 2)
# The script's rows: (tag suffix, far lists kept, gpp).
ROWS = (("g4", True, 4), ("g8", True, 8), ("g8_nofar", False, 8))


def nbody_part(n, device="cuda", out=print):
    """The N-body rows; returns ``{tag: (host, device) ms}``."""
    device = torch.device(device)
    base = r3.ab_config(n)
    pos, vel, mass = r3.initial_state(base, device)
    acc0 = torch.zeros_like(pos)
    res = {}
    for wg in WINDOWS:
        cfg = base.replace(group_size=256, window_groups=wg,
                           list_capacity=6144)
        lists = bw.build_lists(pos, vel, mass, acc0, **bw._build_kw(cfg))
        pos_s, _, mass_s = r3.sorted_state(lists, pos, vel, mass)
        fm = float(lists.far_n.float().mean())
        nofar = lists._replace(far_n=torch.zeros_like(lists.far_n))
        out(f"# W{wg} evals: {r3.eval_kernel(lists)}", flush=True)
        ekw = r3.eval_kw(cfg)
        for suffix, keep, gpp in ROWS:
            tag = f"W{wg}_{suffix}"
            lst = lists if keep else nofar
            t = res[tag] = r3.timed(lambda lst=lst: bw.eval_accel_sorted(
                lst, pos_s, mass_s, r3.DT, **ekw), device)
            out(f"{tag}: {t[0]:.1f} ms | far_n mean={fm:.0f}  ({t[0]:.4f}; "
                f"{r3.dev_text(t)}){r3.no_counterpart(f'gpp={gpp}')}",
                flush=True)
        del lists, nofar, pos_s, mass_s
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--boids", type=int, nargs="*", default=list(SIZES),
                    help="flock sizes (default 500,000 and 100,000; none: "
                         "the N-body part only)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide6")
    print(device_line(dev), flush=True)
    print(f"platform={dev.type}", flush=True)
    nbody_part(bodies_of(a), dev)
    for b in a.boids:
        boids_part(b, dev)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
