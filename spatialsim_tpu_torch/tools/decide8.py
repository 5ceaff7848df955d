"""The dense eval kernel with the TPU's VMEM limit and cost estimate
switched, and empty (port of ``scripts/decide8.py``).

    python -m spatialsim_tpu_torch.tools.decide8 [n] [--device cuda|cpu]

The galaxy (seed 0) at ``n`` bodies (default 1M) at the round-3 sweeps'
configuration, group 256, window 1, list cap 6,144, its dense lists
built with zero accelerations (R = 10), then kernel 3 (``window_eval``,
the row form; its plain version on the CPU) in the script's seven rows,
each the fastest of 3 after a warm-up (host clock ended by a synchronise,
and CUDA events).  The TPU knobs ``vmem_mb`` (the scoped VMEM limit),
``no_cost`` (XLA's cost estimate) and ``groups_per_program`` have no
counterpart on the card -- it has 227 KB of shared memory a block, the
wrapper opts in to it, and it runs one block a group -- so those rows run
the one instance and the label says so; ``empty`` sets the stage
ablation ``dbg="nowin,nostage,notgt"`` (the kernel's ``kAblate``
instance: no window, a constant target; ``nostage`` has no stage of its
own on the card).
"""

from __future__ import annotations

import argparse
import sys

import torch

from spatialsim_tpu_torch.ops.bh_eval_kernel import window_eval
from spatialsim_tpu_torch.tools import round3 as r3
from spatialsim_tpu_torch.tools.eval_ab import device_line, sorted_inputs
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of

GSZ, WG, GPP = 256, 1, 4
EMPTY = "nowin,nostage,notgt"
# The script's rows: (tag, dbg, knobs without a counterpart on the card).
ROWS = (("asis", "", ()),
        ("vm64", "", ("vmem_mb=64",)),
        ("nocost", "", ("no_cost",)),
        ("vm64_nocost", "", ("vmem_mb=64", "no_cost")),
        ("vm100_nocost", "", ("vmem_mb=100", "no_cost")),
        ("empty_vm64_nocost", EMPTY, ("vmem_mb=64", "no_cost")),
        ("g8_vm64_nocost", "", ("vmem_mb=64", "no_cost",
                                "groups_per_program=8")))


def dense_setup(n, device, gsz=GSZ, wg=WG, L=6144, ics=None):
    """(cfg, lists, s_pos, s_mass) of the scripts' dense build."""
    base = r3.ab_config(n)
    cfg = base.replace(group_size=gsz, window_groups=wg, list_capacity=L)
    pos, vel, mass = ics or r3.initial_state(base, device)
    lists = r3.dense_lists(cfg, pos, vel, mass)
    s_pos, s_mass = sorted_inputs(lists, pos, mass)
    return cfg, lists, s_pos, s_mass


def eval_call(lists, s_pos, s_mass, cfg, far_n=None, dbg=""):
    """One call of kernel 3 on the scripts' arguments (dt 0.02)."""
    return lambda: window_eval(
        s_pos, s_mass, lists.far, lists.far_n if far_n is None else far_n,
        None, lists.steps_since, r3.DT, dbg=dbg, **r3.eval_kw(cfg))


def run(n=1_000_000, device="cuda", out=print):
    """The rows; returns ``{tag: (host, device) ms}``."""
    device = torch.device(device)
    out(f"platform={device.type}", flush=True)
    cfg, lists, s_pos, s_mass = dense_setup(n, device)
    out(f"n={n:,} gsz={GSZ} wg={WG} gpp={GPP} "
        f"far_mean={float(lists.far_n.float().mean()):.0f}", flush=True)
    res = {}
    for tag, dbg, knobs in ROWS:
        t = res[tag] = r3.timed(eval_call(lists, s_pos, s_mass, cfg,
                                          dbg=dbg), device)
        out(f"  {tag}: {t[0]:.1f} ms  ({t[0]:.4f}; {r3.dev_text(t)}"
            + (f"; dbg={dbg!r}" if dbg else "") + ")"
            + r3.no_counterpart(*knobs), flush=True)
    out("done", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide8")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
