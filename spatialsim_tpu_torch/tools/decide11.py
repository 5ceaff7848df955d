"""The dense eval's chained marginals, dispatch floor taken out (port of
``scripts/decide11.py``).

    python -m spatialsim_tpu_torch.tools.decide11 [n] [--device cuda|cpu]

The dispatch floor (one ``x + 1`` on an (8, 128) tensor), then for each
of the script's (group size, window groups, groups a TPU program, target
mode) configurations: the galaxy's (seed 0) dense lists at ``n`` bodies
(default 1M; round-3 configuration, list cap 6,144, zero accelerations,
R = 10), and kernel 3's chained marginal -- a chain of K calls of
``window_eval``, each feeding its accelerations back into the positions
(times 1e-30), K = 9 against K = 1, ``(t9 - t1) / 8``
(:func:`~spatialsim_tpu_torch.tools.chain.marginal`: the host clock ended
by a synchronise, and CUDA events) -- with the far lists and with far_n
set to 0, beside far_n's mean.  ``gpp`` and ``tgt_mode`` have no
counterpart on the card (one block a group, targets loaded into
registers): the rows that differ only there run the same instance, and
the label says so.
"""

from __future__ import annotations

import argparse
import sys

import torch

from spatialsim_tpu_torch.ops.bh_eval_kernel import window_eval
from spatialsim_tpu_torch.tools import round3 as r3
from spatialsim_tpu_torch.tools.chain import marginal
from spatialsim_tpu_torch.tools.decide8 import dense_setup
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of

# The script's (group size, window groups, gpp, tgt_mode).
CONFIGS = ((256, 1, 4, "mxu"), (256, 1, 4, "pre"), (256, 1, 8, "mxu"),
           (256, 2, 4, "mxu"), (512, 1, 4, "mxu"))


def dispatch_floor(device):
    """The script's floor: one tiny op, (host, device) ms."""
    tiny = torch.zeros((8, 128), device=device)
    return r3.timed(lambda: tiny + 1.0, device)


def chained(lists, s_pos, s_mass, cfg, far_n, device):
    """Kernel 3's chained marginal, K = 9 against K = 1."""
    npad = s_pos.shape[1]
    carry = [s_pos]
    kw = r3.eval_kw(cfg)

    def call():
        c = carry[0]
        acc = window_eval(c, s_mass, lists.far, far_n, None,
                          lists.steps_since, r3.DT, **kw)
        carry[0] = c + 1e-30 * acc[:, :npad]
    return marginal(call, device, k=9)


def run(n=1_000_000, device="cuda", out=print):
    """The configurations; returns ``{label: (Marginal, Marginal nofar)}``
    and the floor under ``"floor"``."""
    device = torch.device(device)
    out(f"platform={device.type}", flush=True)
    res = {"floor": dispatch_floor(device)}
    out(f"  dispatch floor (tiny op): {res['floor'][0]:.1f} ms  "
        f"({res['floor'][0]:.4f}; {r3.dev_text(res['floor'])})", flush=True)
    ics = r3.initial_state(r3.ab_config(n), device)
    for gsz, wg, gpp, tm in CONFIGS:
        cfg, lists, s_pos, s_mass = dense_setup(n, device, gsz, wg,
                                                ics=ics)
        fm = float(lists.far_n.float().mean())
        m = chained(lists, s_pos, s_mass, cfg, lists.far_n, device)
        mz = chained(lists, s_pos, s_mass, cfg,
                     torch.zeros_like(lists.far_n), device)
        label = f"gsz={gsz} W{wg} g{gpp} {tm}"
        res[label] = (m, mz)
        out(f"  {label}: marginal eval {m.host:.1f} ms | nofar "
            f"{mz.host:.1f} ms | far_mean={fm:.0f}  (eval {m.line()}; "
            f"nofar {mz.line()})"
            + r3.no_counterpart(f"gpp={gpp}", f"tgt_mode={tm}", "no_cost"),
            flush=True)
        del lists, s_pos, s_mass
    out("done", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide11")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
