"""The boids step by part: sustained chains of the whole step, and the
forces alone with both window passes against pass 1 only (port of
``scripts/decide16.py``).

    python -m spatialsim_tpu_torch.tools.decide16 [--boids 500000 100000]
        [--device cuda|cpu]

For each flock size (the script's 500K, then 100K): uniform boids from
``default_rng(3)`` at the default window-mode config, then the step
(``models/boids.make_step_fn``) in chains of K = 6 and 24 substeps (the
second call of a fresh state after a warm-up call: steps/s and ms a step
on the host clock ended by a synchronise, and by CUDA events), and the
chained marginal of ``flocking_forces_window_frozen`` on the sorted
state with ``second_pass`` on and off ((t9 - t1) / 8, host and device:
the second pass's cost is their difference); last, one step's and each
forces call's device busy time under ``torch.profiler`` beside its wall.
Both window passes launch kernel 4 on a card.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from spatialsim_tpu_torch.config.boids import BoidsConfig
from spatialsim_tpu_torch.models.boids import (
    init_boids_window_state, make_step_fn)
from spatialsim_tpu_torch.ops import boids_ops
from spatialsim_tpu_torch.tools.chain import busy_line, marginal, sync
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import device_of

DT = 0.02
SIZES = (500_000, 100_000)
CHAINS = (6, 24)       # substeps of the sustained step chains


def flock(n, device, seed=3):
    """The script's (config, pos, vel, col): uniform in the bounds."""
    cfg = BoidsConfig(num_boids=n, neighbor_mode="window")
    rng = np.random.default_rng(seed)
    pos = (rng.random((3, n)) - 0.5) * 2 * cfg.bounds
    vel = (rng.random((3, n)) - 0.5) * 10
    col = rng.random((3, n))
    return (cfg,) + tuple(torch.as_tensor(a.astype(np.float32),
                                          device=device)
                          for a in (pos, vel, col))


def run(n, device="cuda", out=print):
    """One flock size; returns ``{"chain": {K: (host ms a step, device
    ms a step | None)}, "forces": {tag: Marginal}}``."""
    device = torch.device(device)
    cfg, pos, vel, col = flock(n, device)
    out(f"boids n={n:,} resort_interval="
        f"{getattr(cfg, 'resort_interval', 6)}", flush=True)
    res = dict(chain={}, forces={})
    cuda = device.type == "cuda"
    for K in CHAINS:
        st = init_boids_window_state(pos, vel, col, cfg)
        step = make_step_fn(cfg, substeps=K)
        st2 = step(st, DT)
        sync(device)
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        st2 = step(st2, DT)
        if cuda:
            e1.record()
        sync(device)
        dt_w = time.perf_counter() - t0
        dev = e0.elapsed_time(e1) / K if cuda else None
        res["chain"][K] = (dt_w / K * 1e3, dev)
        dtext = ("device not measured" if dev is None
                 else f"device {dev:.3f} ms/step")
        out(f"  full step chain K={K}: {K / dt_w:.1f} steps/s "
            f"({dt_w / K * 1e3:.3f} ms/step; {dtext})", flush=True)
        del st, st2

    st = init_boids_window_state(pos, vel, col, cfg)
    fkw = dict(perception_radius=cfg.perception_radius,
               separation_radius=cfg.separation_radius,
               separation_weight=cfg.separation_weight,
               alignment_weight=cfg.alignment_weight,
               cohesion_weight=cfg.cohesion_weight,
               max_speed=cfg.max_speed, max_force=cfg.max_force,
               group_size=cfg.group_size, window_groups=cfg.window_groups)
    for tag, second in (("both_passes", True), ("pass1_only", False)):
        m = marginal(lambda second=second: boids_ops.
                     flocking_forces_window_frozen(
                         st.pos, st.vel, st.col, st.p21, st.s21,
                         second_pass=second, **fkw), device, k=9)
        res["forces"][tag] = m
        out(f"  forces [{tag}]: marginal {m.line()}", flush=True)
    step = make_step_fn(cfg, substeps=1)
    out(busy_line([("step", lambda: step(st, DT))] + [
        (tag, lambda second=second: boids_ops.flocking_forces_window_frozen(
            st.pos, st.vel, st.col, st.p21, st.s21, second_pass=second,
            **fkw)) for tag, second in (("both_passes", True),
                                        ("pass1_only", False))], device),
        flush=True)
    out("done_n", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--boids", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide16")
    print(device_line(dev), flush=True)
    for n in a.boids:
        run(n, dev)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
