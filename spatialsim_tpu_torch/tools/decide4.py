"""The column eval against the row eval at the two production windows
(port of ``scripts/decide4.py``).

    python -m spatialsim_tpu_torch.tools.decide4 [n] [--device cuda|cpu]

The galaxy (seed 0) at ``n`` bodies (default 1M) at the round-3 sweeps'
configuration, group 256, list cap 6,144, window 2 then 1: the build
with zero accelerations (pooled at these sizes), then ``eval_accel_sorted``
in the script's four rows -- ``old`` (``use_cols`` off), ``cols``,
``cols_t256`` (``far_tile=256``) and ``cols_gpp8`` (the TPU's groups a
program, no counterpart on the card: one block a group) -- each the
fastest of 3 after a warm-up (host clock ended by a synchronise, and
CUDA events), and its largest difference from ``old`` over max|a|.
``use_cols`` and ``far_tile`` select kernel 3b's instance for dense
lists; pooled lists take kernel 2 in every row, as in the JAX package
(a line starting with ``#`` says which kernel ran).
"""

from __future__ import annotations

import argparse
import sys

import torch

from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools import round3 as r3
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of

WINDOWS = (2, 1)
# The script's rows: (tag, eval_accel_sorted's arguments, knobs without a
# counterpart on the card).
ROWS = (("old", dict(use_cols=False), ()),
        ("cols", dict(use_cols=True), ()),
        ("cols_t256", dict(use_cols=True, far_tile=256), ()),
        ("cols_gpp8", dict(use_cols=True), ("gpp=8",)))


def run(n=1_000_000, device="cuda", out=print):
    """The rows at each window; returns ``{(wg, tag): ((host, device) ms,
    dev)}``."""
    device = torch.device(device)
    base = r3.ab_config(n)
    out(f"n={n:,} platform={device.type}", flush=True)
    pos, vel, mass = r3.initial_state(base, device)
    acc0 = torch.zeros_like(pos)
    res = {}
    for wg in WINDOWS:
        cfg = base.replace(group_size=256, window_groups=wg,
                           list_capacity=6144)
        lists = bw.build_lists(pos, vel, mass, acc0, **bw._build_kw(cfg))
        pos_s, _, mass_s = r3.sorted_state(lists, pos, vel, mass)
        out(f"# W{wg} evals: {r3.eval_kernel(lists)}", flush=True)
        ekw = r3.eval_kw(cfg)
        old = None
        for tag, kw, knobs in ROWS:
            def call(kw=kw):
                return bw.eval_accel_sorted(lists, pos_s, mass_s, r3.DT,
                                            **ekw, **kw)
            t = r3.timed(call, device)
            a = call()
            old = a if old is None else old
            dev = float((a - old).abs().max()
                        / max(float(old.abs().max()), 1e-30))
            res[(wg, tag)] = (t, dev)
            out(f"W{wg} {tag}: {t[0]:.1f} ms (dev {dev:.2e})  ({t[0]:.4f}; "
                f"{r3.dev_text(t)}){r3.no_counterpart(*knobs)}", flush=True)
        del lists, pos_s, mass_s, old
    out("done", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide4")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
