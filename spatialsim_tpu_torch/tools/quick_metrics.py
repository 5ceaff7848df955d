"""The 1M decision metrics on dense lists against the list cap: rebuild,
far_n tail, eval and refresh at L = 6,144 and 2,048 (port of
``scripts/quick_metrics.py``).

    python -m spatialsim_tpu_torch.tools.quick_metrics [n] [--device cuda|cpu]

The galaxy (seed 0) at ``n`` bodies (default 1M, the script's) at
``tools/decide_1m.py``'s configuration.  Both caps build dense lists
(``pool_tile=0``), as the script means to: its line that sets
``pool_tile`` is dedented out of the loop, so the script does not
compile.  Per cap: the rebuild (the fastest of 3, host clock ended by a
synchronise), far_n's mean, p90, p99, max and groups at the cap, one
eval (kernel 3, the row form; CUDA events, the mean of 3) and one moment
refresh.
"""

from __future__ import annotations

import argparse
import sys

import torch

from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.decide_1m import (
    DT, REPS, dense_kw, eval_kw, far_stats, matrix_config, sorted_state,
    time_refresh)
from spatialsim_tpu_torch.tools.eval_ab import (
    device_line, time_build_ms, time_ms)
from spatialsim_tpu_torch.tools.oracle import (
    add_bodies, bodies_of, device_of, initial_conditions)

CAPS = (6144, 2048)


def run(n=1_000_000, device="cuda", out=print):
    """The metrics; returns one record a list cap."""
    device = torch.device(device)
    base = matrix_config(n)
    out(f"n={n:,} device={device.type}", flush=True)
    pos, vel, mass = initial_conditions("galaxy", n, base.spawn_radius,
                                        base.G, device)
    recs = []
    for L in CAPS:
        cfg = base.replace(list_capacity=L)
        t_b, lists = time_build_ms(pos, vel, mass, dense_kw(cfg), REPS,
                                   device)
        rec = dict(L=L, rebuild_ms=t_b, **far_stats(lists.far_n, L))
        out(f"L={L}: rebuild {t_b:.0f} ms | far_n "
            f"mean={rec['far_n_mean']:.0f} p90={rec['far_n_p90']:.0f}"
            f" p99={rec['far_n_p99']:.0f} max={rec['far_n_max']}"
            f" at_cap={rec['at_cap']}  ({t_b:.3f} ms; far "
            f"{tuple(lists.far.shape)})", flush=True)
        pos_s, vel_s, mass_s = sorted_state(lists, pos, vel, mass)
        ekw = eval_kw(cfg)
        rec["eval_ms"] = time_ms(lambda: bw.eval_accel_sorted(
            lists, pos_s, mass_s, DT, **ekw), REPS, device)
        out(f"L={L}: eval {rec['eval_ms']:.1f} ms  "
            f"({rec['eval_ms']:.4f})", flush=True)
        rec["refresh_ms"] = time_refresh(lists, pos_s, vel_s, mass_s,
                                         device)
        out(f"L={L}: refresh {rec['refresh_ms']:.0f} ms  "
            f"({rec['refresh_ms']:.3f})", flush=True)
        recs.append(rec)
        del lists, pos_s, vel_s, mass_s
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "quick_metrics")
    n = bodies_of(a)
    print(device_line(dev), flush=True)
    run(n, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
