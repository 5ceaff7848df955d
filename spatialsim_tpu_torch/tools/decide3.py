"""Group size, window, list cap and worklist budget, with the row eval
against the column eval (port of ``scripts/decide3.py``).

    python -m spatialsim_tpu_torch.tools.decide3 [n] [--device cuda|cpu]

As :mod:`~spatialsim_tpu_torch.tools.decide2`, at the script's (group
size, window groups, list cap, worklist budget) variants, with two evals
of each set of lists: ``use_cols`` off ("old") and on ("cols"), each the
fastest of 3 after a warm-up, and their largest difference over max|a|
(``kern_dev``).  ``use_cols`` selects kernel 3b for dense lists; the
configuration's lists are pooled at these sizes, and pooled lists take
kernel 2 either way, as in the JAX package (the line says which kernel
ran).  The errors are the "cols" eval's, as the script's.
"""

from __future__ import annotations

import argparse
import sys

import torch

from spatialsim_tpu_torch.tools import round3 as r3
from spatialsim_tpu_torch.tools.decide2 import SAMPLE, measure, tail
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of

# The script's (tag, group size, window groups, list cap, budget).
VARIANTS = (("G256_W2_L6144_B0", 256, 2, 6144, 0),
            ("G256_W1_L6144_B0", 256, 1, 6144, 0),
            ("G128_W2_L6144_B12M", 128, 2, 6144, 12_000_000),
            ("G128_W1_L6144_B12M", 128, 1, 6144, 12_000_000),
            ("G128_W1_L4096_B16M", 128, 1, 4096, 16_000_000))


def run(n=1_000_000, device="cuda", out=print):
    """The sweep; returns ``{tag: record}``."""
    device = torch.device(device)
    base = r3.ab_config(n)
    out(f"n={n:,} platform={device.type}", flush=True)
    pos, vel, mass = r3.initial_state(base, device)
    ora = r3.oracle(pos, mass, base, min(SAMPLE, n), device)
    out("exact oracle ready", flush=True)
    recs = {}
    for tag, gsz, wg, L, B in VARIANTS:
        cfg = base.replace(group_size=gsz, window_groups=wg,
                           list_capacity=L, worklist_budget=B)
        rec = recs[tag] = measure(cfg, pos, vel, mass, ora, device,
                                  use_cols=(False, True))
        old, cols = rec["evals"][False], rec["evals"][True]
        out(f"{tag}: rebuild {rec['rebuild'][0]:.0f} ms"
            f" | eval old {old[0]:.1f} / cols {cols[0]:.1f} ms"
            f" (kern_dev {rec['kern_dev']:.2e})" + tail(rec)
            + f" | host ms {rec['rebuild'][0]:.3f} / {old[0]:.4f} / "
            f"{cols[0]:.4f} / {rec['refresh'][0]:.3f}; rebuild "
            f"{r3.dev_text(rec['rebuild'])}, old {r3.dev_text(old)}, cols "
            f"{r3.dev_text(cols)}, refresh {r3.dev_text(rec['refresh'])}; "
            f"{rec['kernel']}", flush=True)
    out("done", flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide3")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
