"""The dense eval's target transpose alone, and the kernel by target mode
(port of ``scripts/decide10.py``).

    python -m spatialsim_tpu_torch.tools.decide10 [n] [--device cuda|cpu]

The dense set-up of :mod:`~spatialsim_tpu_torch.tools.decide8` (group 256,
window 1, list cap 6,144, R = 10), then the script's two pieces alone:
the TPU kernel's pre-transposed target input (the sorted positions padded
to whole TPU programs of ``gpp`` = 4 groups, permuted to (gsz, programs,
gpp, 3), padded to ``TGT_LANES`` = 16 lanes a group and to whole 128-lane
rows; ``TGT_LANES`` is the JAX kernel's constant,
``spatialsim_tpu/ops/bh_eval_kernel.py:45``) and the (8, npad) source
rows (positions, mass, zeros), the same permutes, pads and copies in
PyTorch; then kernel 3 in the script's rows ``mxu_full``, ``pre_full``,
``mxu_empty`` (``dbg="nowin,nostage,notgt"``), ``mxu_nofar`` (far_n 0)
and ``mxu_g8``.  ``tgt_mode`` (an identity-matmul transpose in the TPU
kernel, or the pre-transposed input) has no counterpart on the card,
whose kernel loads its targets into registers; neither have
``groups_per_program`` and ``no_cost``: those rows run the one instance,
and the label says so.  Each time is the fastest of 3 after a warm-up
(host clock ended by a synchronise, and CUDA events).  The card's
kernel reads no transposed input: the two pieces price what the TPU
kernel needed, not a part of the port's eval.
"""

from __future__ import annotations

import argparse
import sys

import torch

from spatialsim_tpu_torch.tools import round3 as r3
from spatialsim_tpu_torch.tools.decide8 import EMPTY, dense_setup, eval_call
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of

GSZ, WG, GPP = 256, 1, 4
TGT_LANES = 16
# The script's rows: (tag, dbg, far lists kept, knobs without a
# counterpart on the card; every row sets no_cost).
ROWS = (("mxu_full", "", True, ("tgt_mode=mxu",)),
        ("pre_full", "", True, ("tgt_mode=pre",)),
        ("mxu_empty", EMPTY, True, ("tgt_mode=mxu",)),
        ("mxu_nofar", "", False, ("tgt_mode=mxu",)),
        ("mxu_g8", "", True, ("tgt_mode=mxu", "groups_per_program=8")))


def tgt_transpose(s_pos, gsz, gpp=GPP):
    """The TPU kernel's pre-transposed targets ``(gsz, programs *
    width)`` of sorted ``(3, npad)`` positions (the script's
    ``mk_tgtT``)."""
    npad = s_pos.shape[1]
    ng = npad // gsz
    ng2 = -(-ng // gpp) * gpp
    nprog = ng2 // gpp
    width = -(-(TGT_LANES * gpp) // 128) * 128
    sp = torch.nn.functional.pad(s_pos, (0, (ng2 - ng) * gsz))
    t = sp.reshape(3, nprog, gpp, gsz).permute(3, 1, 2, 0)
    t = torch.nn.functional.pad(t, (0, TGT_LANES - 3))
    t = t.reshape(gsz, nprog, gpp * TGT_LANES)
    if width != gpp * TGT_LANES:
        t = torch.nn.functional.pad(t, (0, width - gpp * TGT_LANES))
    return t.reshape(gsz, nprog * width)


def pos8(s_pos, s_mass):
    """The (8, npad) source rows: positions, mass, four zero rows."""
    npad = s_pos.shape[1]
    return torch.cat([s_pos, s_mass[None, :],
                      s_pos.new_zeros((4, npad))], 0)


def run(n=1_000_000, device="cuda", out=print):
    """The pieces and rows; returns ``{name: (host, device) ms}``."""
    device = torch.device(device)
    out(f"platform={device.type}", flush=True)
    res = {}
    cfg, lists, s_pos, s_mass = dense_setup(n, device)
    out(f"n={n:,} gsz={GSZ} wg={WG} gpp={GPP} "
        f"far_mean={float(lists.far_n.float().mean()):.0f}", flush=True)
    t = res["tgtT"] = r3.timed(lambda: tgt_transpose(s_pos, GSZ), device)
    out(f"  tgtT construction alone: {t[0]:.1f} ms  ({t[0]:.4f}; "
        f"{r3.dev_text(t)})", flush=True)
    t = res["pos8"] = r3.timed(lambda: pos8(s_pos, s_mass), device)
    out(f"  pos8 concat alone: {t[0]:.1f} ms  ({t[0]:.4f}; "
        f"{r3.dev_text(t)})", flush=True)
    zero = torch.zeros_like(lists.far_n)
    for tag, dbg, keep, knobs in ROWS:
        t = res[tag] = r3.timed(eval_call(
            lists, s_pos, s_mass, cfg, far_n=None if keep else zero,
            dbg=dbg), device)
        out(f"  {tag}: {t[0]:.1f} ms  ({t[0]:.4f}; {r3.dev_text(t)})"
            + r3.no_counterpart(*knobs, "no_cost"), flush=True)
    out("done", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide10")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
