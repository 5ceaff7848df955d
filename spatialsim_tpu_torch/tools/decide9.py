"""The dense eval kernel, empty and whole, at three list caps (port of
``scripts/decide9.py``).

    python -m spatialsim_tpu_torch.tools.decide9 [n] [--device cuda|cpu]

As :mod:`~spatialsim_tpu_torch.tools.decide8`, at list caps 6,144, 2,048
and 512 (the lists built at each cap: at the small caps they saturate,
and only the times matter, as in the script), kernel 3 in the script's
four rows: ``empty`` (``dbg="nowin,nostage,notgt"``), ``emptyDS``,
``full`` and ``fullDS``.  The ``DS`` rows set the TPU's VMEM limit and
``dimension_semantics``, which have no counterpart on the card (its
blocks are always independent): they run the same instance as their
plain rows, and the label says so.
"""

from __future__ import annotations

import argparse
import sys

import torch

from spatialsim_tpu_torch.tools import round3 as r3
from spatialsim_tpu_torch.tools.decide8 import EMPTY, dense_setup, eval_call
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of

CAPS = (6144, 2048, 512)
DS = ("vmem_mb=64", "dimension_semantics")
# The script's rows: (tag, dbg, knobs without a counterpart on the card;
# every row sets no_cost).
ROWS = (("empty", EMPTY, ("no_cost",)), ("emptyDS", EMPTY, ("no_cost",) + DS),
        ("full", "", ("no_cost",)), ("fullDS", "", ("no_cost",) + DS))


def run(n=1_000_000, device="cuda", out=print):
    """The rows at each cap; returns ``{(L, tag): (host, device) ms}``."""
    device = torch.device(device)
    out(f"platform={device.type}", flush=True)
    ics = r3.initial_state(r3.ab_config(n), device)
    res = {}
    for L in CAPS:
        cfg, lists, s_pos, s_mass = dense_setup(n, device, L=L, ics=ics)
        for tag, dbg, knobs in ROWS:
            t = res[(L, tag)] = r3.timed(
                eval_call(lists, s_pos, s_mass, cfg, dbg=dbg), device)
            out(f"  L={L} {tag}: {t[0]:.1f} ms  ({t[0]:.4f}; "
                f"{r3.dev_text(t)})"
                + r3.no_counterpart(*knobs), flush=True)
        del lists, s_pos, s_mass
    out("done", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide9")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
