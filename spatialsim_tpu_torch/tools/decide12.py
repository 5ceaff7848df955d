"""The boids window accumulation, A/B: kernel 4 against its plain version,
chained K = 1 against 9 (port of ``scripts/decide12.py``).

    python -m spatialsim_tpu_torch.tools.decide12 [--boids 500000 100000]
        [--device cuda|cpu]

For each flock size (the script's 500K, then 100K): the uniform flock of
``tools/decide16.py`` sorted into the window state and padded to whole
groups (positions at 1e9), then the first pass's accumulation, each call
feeding its separation sum back into the positions (times 1e-30), as a
chained marginal ((t9 - t1) / 8; host clock ended by a synchronise, and
CUDA events).  The script's two rows keep their tags: "xla" is the
port's plain version, ``ops/boids_ops.window_accumulate_reference`` (the
counterpart of the JAX package's XLA form; no path of the port takes
it on a card), "pallas" the kernel's wrapper
``ops/boids_window_kernel.boids_window_accumulate`` (kernel 4 on a card;
on the CPU the wrapper takes the plain version).
"""

from __future__ import annotations

import argparse
import sys

import torch

from spatialsim_tpu_torch.models.boids import init_boids_window_state
from spatialsim_tpu_torch.ops.boids_ops import window_accumulate_reference
from spatialsim_tpu_torch.ops.boids_window_kernel import (
    boids_window_accumulate)
from spatialsim_tpu_torch.tools.chain import marginal
from spatialsim_tpu_torch.tools.decide16 import SIZES, flock
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import device_of

ROWS = (("xla", window_accumulate_reference,
         "ops/boids_ops.window_accumulate_reference, the plain version"),
        ("pallas", boids_window_accumulate,
         "ops/boids_window_kernel.boids_window_accumulate, kernel 4"))


def padded_flock(n, device, out=print):
    """The uniform flock of ``n`` boids sorted into the window state and
    padded to whole groups (positions at 1e9), and its header line:
    ``(ppos, pvel, pcol, kw)``, ``kw`` the accumulation's arguments."""
    cfg, pos, vel, col = flock(n, device)
    st = init_boids_window_state(pos, vel, col, cfg)
    gsz, wg = cfg.group_size, cfg.window_groups
    npad = st.p21.shape[0]
    pad = npad - n
    ppos = torch.cat([st.pos, torch.full((3, pad), 1e9, device=device)], 1)
    pvel = torch.nn.functional.pad(st.vel, (0, pad))
    pcol = torch.nn.functional.pad(st.col, (0, pad))
    out(f"boids n={n:,} gsz={gsz} wg={wg} npad={npad}", flush=True)
    kw = dict(gsz=gsz, wg=wg, perception_sq=float(cfg.perception_radius ** 2),
              separation_sq=float(cfg.separation_radius ** 2))
    return ppos, pvel, pcol, kw


def boids_part(n, device="cuda", out=print):
    """One flock size; returns ``{tag: Marginal}``."""
    device = torch.device(device)
    ppos, pvel, pcol, kw = padded_flock(n, device, out)
    res = {}
    for tag, fn, what in ROWS:
        carry = [ppos]

        def call(fn=fn):
            p = carry[0]
            rows = fn(p, pvel, pcol, None, **kw)
            carry[0] = p + 1e-30 * rows[0:3]
        res[tag] = m = marginal(call, device, k=9)
        out(f"  accumulate [{tag}]: marginal {m.line()} -- {what}",
            flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--boids", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide12")
    print(device_line(dev), flush=True)
    print(f"platform={dev.type}", flush=True)
    for n in a.boids:
        boids_part(n, dev)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
