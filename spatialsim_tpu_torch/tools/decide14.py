"""The pooled engine's sustained rates at 1M (port of
``scripts/decide14.py``).

    python -m spatialsim_tpu_torch.tools.decide14 [n [wg [budget]]]
        [--device cuda|cpu]

The galaxy (seed 0) at ``n`` bodies (default 1M) at the script's
configuration (theta 0.8, skin 2, window ``wg`` (1), worklist budget
``budget`` (0: auto), pool tile 512, rebuild interval 48, drift off,
resolved).  It prints the rebuild with the pool's compaction (the
fastest of 3 after a warm-up: host clock ended by a synchronise, and
CUDA events) and the pool's tiles against those in use; the pooled
eval's chained marginal, K = 1 against K = 9 calls of ``window_eval_pool``
(kernel 2 on a card), each call feeding its accelerations back into the
positions (times 1e-30), ``(t9 - t1) / 8`` through
:func:`~spatialsim_tpu_torch.tools.chain.marginal`; one refresh of the
pool's moments (``refresh_lists``); and the sustained rate of the
production step (``make_window_step``, one call of ``interval`` substeps
after a warm-up call, host clock) at the script's (interval, refresh)
pairs (48, 0), (48, 12), (24, 8) and (96, 12).  The script's pool tile
is 512, kernel 2's far tile, the one the card runs.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.ops.bh_eval_kernel import window_eval_pool
from spatialsim_tpu_torch.tools.chain import chain_ms, marginal, sync
from spatialsim_tpu_torch.tools.eval_ab import device_line, sorted_inputs
from spatialsim_tpu_torch.tools.oracle import (
    add_bodies, bodies_of, device_of, initial_conditions)

DT = 0.02
REPS = 3
TILE = 512
# The script's (rebuild interval, refresh interval) pairs.
SUSTAINED = ((48, 0), (48, 12), (24, 8), (96, 12))


def pool_config(n: int, wg: int = 1, budget: int = 0) -> NBodyConfig:
    """The script's configuration, resolved for ``n``."""
    return resolve_config(NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, damping=1.0,
        spawn_radius=500.0, distribution="galaxy", engine="window",
        skin=2.0, window_groups=wg, worklist_budget=budget, pool_tile=TILE,
        rebuild_interval=48, rebuild_drift_mode="off"), n)


def _ms(host, dev):
    d = "device not measured" if dev is None else f"device {dev:.3f} ms"
    return f"{host:.3f} ms; {d}"


def run(n=1_000_000, wg=1, budget=0, device="cuda", out=print):
    """The script's lines; returns ``{"rebuild": (host, device), "tiles":
    (pool tiles, in use), "eval": Marginal, "refresh": (host, device),
    "sustained": {(interval, refresh): (steps/s, rebuilds, refreshes)}}``.
    """
    device = torch.device(device)
    out(f"platform={device.type} n={n:,} wg={wg} B={budget or 'auto'}",
        flush=True)
    base = pool_config(n, wg, budget)
    pos, vel, mass = initial_conditions("galaxy", n, base.spawn_radius,
                                        base.G, device)
    kw = bw._build_kw(base)
    acc0 = torch.zeros_like(pos)
    built = []
    t_build = chain_ms(lambda: built.append(
        bw.build_lists(pos, vel, mass, acc0, **kw)), 1, device, REPS)
    lists = built[-1]
    del built
    ct = lists.pool.shape[0]
    used = int(((lists.far_n.long() + TILE - 1) // TILE).sum())
    out(f"  rebuild+compact: {t_build[0]:.0f} ms | pool tiles {ct} used "
        f"{used}  ({_ms(*t_build)})", flush=True)

    s_pos, s_mass = sorted_inputs(lists, pos, mass)
    npad = s_pos.shape[1]
    o = lists.order[:n].long()
    vel_s, mass_s = vel[:, o].contiguous(), mass[o].contiguous()
    ekw = dict(G=base.G, softening=base.softening,
               group_size=base.group_size, window_groups=wg)
    carry = [s_pos]

    def call():
        c = carry[0]
        acc = window_eval_pool(c, s_mass, lists.pool, lists.pstart,
                               lists.far_n, lists.steps_since, DT, **ekw)
        carry[0] = c + 1e-30 * acc[:, :npad]
    m = marginal(call, device, k=9)
    out(f"  pooled eval marginal: {m.host:.1f} ms  ({m.line()})",
        flush=True)

    zeros = torch.zeros((3, n), device=device)
    t_r = chain_ms(lambda: bw.refresh_lists(
        lists, s_pos[:, :n], vel_s, mass_s, zeros, DT, 24.0), 1, device,
        REPS)
    out(f"  pool refresh: {t_r[0]:.0f} ms (one call, {_ms(*t_r)})",
        flush=True)
    del lists, s_pos, s_mass, carry

    rates = {}
    for interval, riv in SUSTAINED:
        cfg = base.replace(rebuild_interval=interval, refresh_interval=riv)
        st = bw.init_window_state(pos, vel, mass, cfg)
        step = bw.make_window_step(cfg, n, substeps=interval)
        st = step(st, DT)                 # the first call's rebuild
        sync(device)
        t0 = time.perf_counter()
        st = step(st, DT)
        sync(device)
        dt_w = time.perf_counter() - t0
        rates[(interval, riv)] = (interval / dt_w, step.rebuilds,
                                  step.refreshes)
        out(f"  interval={interval} refresh={riv}: "
            f"{interval / dt_w:.1f} steps/s ({dt_w / interval * 1e3:.1f} "
            f"ms/step; {dt_w / interval * 1e3:.4f}; {step.rebuilds} "
            f"rebuilds, {step.refreshes} refreshes in {2 * interval} "
            f"steps)", flush=True)
        del st
    out("done", flush=True)
    return dict(rebuild=t_build, tiles=(ct, used), eval=m, refresh=t_r,
                sustained=rates)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("wg", type=int, nargs="?", default=1)
    ap.add_argument("budget", type=lambda x: int(float(x)), nargs="?",
                    default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide14")
    print(device_line(dev), flush=True)
    run(bodies_of(a), a.wg, a.budget, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
