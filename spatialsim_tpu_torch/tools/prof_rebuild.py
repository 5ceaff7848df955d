"""Profile the window engine's rebuild and eval at production scale (port
of ``scripts/prof_rebuild.py``).

    python -m spatialsim_tpu_torch.tools.prof_rebuild [n] [--device cuda|cpu]

The galaxy (seed 0) at ``n`` bodies (default 1M) at the script's
configuration exactly: ``bench.py``'s 1M defaults (depth 8, group 256,
window 2, list cap 6,144) with skin 2 and rebuild interval 48, resolved
inside the engine but NOT calibrated: the worklist caps are the default
profile's and the pool cap the budget's, so groups may fold whole
(``ROADMAP.md`` Queue 3, "Pool cap").  Prints ``build_diagnostics`` (the
per-level worklist fills and pre-clamp demands against their caps, the
far-list occupancy) and the fill of each level, then the built lists'
line (far_n, groups at the list cap and folded whole, pool tiles in use),
the rebuild (the fastest of 3 after a warm-up, host clock ended by a
synchronise), one eval through ``eval_accel_sorted`` (kernel 2 on a card;
CUDA events, the mean of 3) and the sustained rate of one dispatch of 48
steps with its rebuild (host clock after a synchronise).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.eval_ab import (
    _sync, device_line, time_build_ms, time_ms)
from spatialsim_tpu_torch.tools.extreme_run import list_health
from spatialsim_tpu_torch.tools.oracle import (
    add_bodies, bodies_of, device_of, initial_conditions)

DT = 0.02
REPS = 3


def rebuild_config(n: int) -> NBodyConfig:
    """The script's configuration (``bench.py``'s 1M defaults), as given:
    resolved by the engine's entry points, never calibrated."""
    return NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, damping=1.0,
        spawn_radius=500.0, distribution="galaxy", engine="window",
        max_depth=8, group_size=256, window_groups=2, list_capacity=6144,
        skin=2.0, rebuild_interval=48, rebuild_drift_mode="off")


def profile(n=1_000_000, device="cuda", out=print):
    """The profile; returns ``{"diag", "rebuild_ms", "eval_ms",
    "steps_per_s"}``."""
    device = torch.device(device)
    cfg = rebuild_config(n)
    out(f"n={n:,} device={device.type}", flush=True)
    pos, vel, mass = initial_conditions(cfg.distribution, n,
                                        cfg.spawn_radius, cfg.G, device)
    diag = bw.build_diagnostics(pos, vel, mass, cfg)
    out(json.dumps(diag, indent=1), flush=True)
    caps = np.array(diag["wl_caps"], dtype=float)
    sizes = np.array(diag["wl_sizes"][:len(caps)], dtype=float)
    out("per-level fill: "
        + " ".join(f"{s / c:.2f}" for s, c in zip(sizes, caps)), flush=True)
    out(f"total slots={caps.sum() / 1e6:.1f}M "
        f"visited={sizes.sum() / 1e6:.1f}M", flush=True)

    kw = bw._build_kw(cfg)
    t_build, lists = time_build_ms(pos, vel, mass, kw, REPS, device)
    list_health(lists, cfg, "built", out)
    out(f"rebuild: {t_build:.0f} ms  ({t_build:.3f})", flush=True)

    o = lists.order[:n].long()
    pos_s, mass_s = pos[:, o].contiguous(), mass[o].contiguous()
    ekw = dict(G=cfg.G, softening=cfg.softening, group_size=cfg.group_size,
               window_groups=cfg.window_groups)
    t_eval = time_ms(lambda: bw.eval_accel_sorted(lists, pos_s, mass_s, DT,
                                                  **ekw), REPS, device)
    out(f"eval:    {t_eval:.1f} ms  ({t_eval:.4f})", flush=True)
    del lists, pos_s, mass_s

    step = bw.make_window_step(cfg, n, substeps=cfg.rebuild_interval)
    st = step(bw.init_window_state(pos, vel, mass, cfg), DT)
    _sync(device)
    t0 = time.perf_counter()
    st = step(st, DT)
    _sync(device)
    dt_chain = time.perf_counter() - t0
    rate = cfg.rebuild_interval / dt_chain
    out(f"sustained: {rate:.2f} steps/s "
        f"({dt_chain / cfg.rebuild_interval * 1000:.1f} ms/step; "
        f"{step.rebuilds} rebuilds in {2 * cfg.rebuild_interval} steps)",
        flush=True)
    return dict(diag=diag, rebuild_ms=t_build, eval_ms=t_eval,
                steps_per_s=rate)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "prof_rebuild")
    n = bodies_of(a)
    print(device_line(dev), flush=True)
    profile(n, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
