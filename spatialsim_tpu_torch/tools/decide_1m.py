"""The 1M decision matrix on dense lists: rebuild, far_n tail, eval,
refresh and sampled force error for five (near groups K, list cap L,
worklist budget B) variants (port of ``scripts/decide_1m.py``).

    python -m spatialsim_tpu_torch.tools.decide_1m [n] [--device cuda|cpu]

The galaxy (seed 0) at ``n`` bodies (default 1M) at the script's
configuration (theta 0.8, skin 2, rebuild interval 48, drift off),
resolved, with each variant's K, L and B.  Every variant builds dense
lists (``pool_tile=0``), as the script means to: its line that sets
``pool_tile`` is dedented out of the variant loop, so the script does not
compile.  Per variant: the rebuild (the fastest of 3 after a warm-up,
host clock ended by a synchronise), far_n's mean, p99, max and groups at
the cap, one eval (kernel 3, the row form, with the K near groups; CUDA
events, the mean of 3), one moment refresh of the dense lists, and the
force error on ``--sample`` bodies (the script's 1,024 from
``default_rng(1)``) against the direct sum of
:mod:`~spatialsim_tpu_torch.tools.oracle` (kernel 1's targets-and-sources
mode on the card): |da|/|a| and |da|/rms|a|, the sorted accelerations
mapped back through ``lists.inv_order`` as the script maps them.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.eval_ab import (
    device_line, time_build_ms, time_ms)
from spatialsim_tpu_torch.tools.oracle import (
    add_bodies, bodies_of, device_of, exact_accel_at, initial_conditions,
    sample_ids)

DT = 0.02
TAU_CLAMP = 24.0
REPS = 3
SAMPLE = 1024
# (tag, K, L, worklist budget B): the script's variants.
VARIANTS = (
    ("K0_L6144_B0", 0, 6144, 0),
    ("K0_L8192_B8M", 0, 8192, 8_000_000),
    ("K8_L6144_B0", 8, 6144, 0),
    ("K8_L8192_B8M", 8, 8192, 8_000_000),
    ("K8_L2048_B0", 8, 2048, 0),
)


def matrix_config(n: int) -> NBodyConfig:
    """The configuration of ``scripts/decide_1m.py`` and
    ``scripts/quick_metrics.py``, resolved for ``n``."""
    return resolve_config(NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, damping=1.0,
        spawn_radius=500.0, distribution="galaxy", engine="window",
        skin=2.0, rebuild_interval=48, rebuild_drift_mode="off"), n)


def dense_kw(cfg: NBodyConfig) -> dict:
    """``build_lists``' arguments with the dense layout."""
    return {**bw._build_kw(cfg), "pool_tile": 0}


def far_stats(far_n, L) -> dict:
    """far_n's mean, p90, p99, max and groups at the list cap (>= L-1)."""
    fn = far_n.cpu().numpy()
    return dict(far_n_mean=float(fn.mean()),
                far_n_p90=float(np.percentile(fn, 90)),
                far_n_p99=float(np.percentile(fn, 99)),
                far_n_max=int(fn.max()),
                at_cap=int((fn >= L - 1).sum()))


def sorted_state(lists, pos, vel, mass):
    o = lists.order[:pos.shape[1]].long()
    return (pos[:, o].contiguous(), vel[:, o].contiguous(),
            mass[o].contiguous())


def eval_kw(cfg: NBodyConfig) -> dict:
    """The scripts' eval arguments (the JAX default tau clamp, 24)."""
    return dict(G=cfg.G, softening=cfg.softening,
                group_size=cfg.group_size, window_groups=cfg.window_groups)


def time_refresh(lists, pos_s, vel_s, mass_s, device):
    acc0 = torch.zeros_like(pos_s)
    return time_ms(lambda: bw.refresh_lists(lists, pos_s, vel_s, mass_s,
                                            acc0, DT, TAU_CLAMP), REPS,
                   device)


def run(n=1_000_000, device="cuda", sample=SAMPLE, variants=None,
        out=print):
    """The matrix; returns one record a variant (times in ms, the error
    statistics unrounded)."""
    device = torch.device(device)
    base = matrix_config(n)
    out(f"n={n:,} device={device.type}", flush=True)
    pos, vel, mass = initial_conditions("galaxy", n, base.spawn_radius,
                                        base.G, device)
    idx = torch.as_tensor(sample_ids(n, min(sample, n)), device=device)
    exact = exact_accel_at(pos[:, idx], pos, mass, base.G,
                           base.softening).double().cpu().numpy()
    mag = np.linalg.norm(exact, axis=0)
    rms_mag = float(np.sqrt((mag ** 2).mean()))
    out("exact oracle ready", flush=True)
    recs = []
    for tag, K, L, B in variants or VARIANTS:
        cfg = base.replace(list_capacity=L, near_groups=K, worklist_budget=B)
        t_b, lists = time_build_ms(pos, vel, mass, dense_kw(cfg), REPS,
                                   device)
        pos_s, vel_s, mass_s = sorted_state(lists, pos, vel, mass)
        ekw = eval_kw(cfg)
        t_e = time_ms(lambda: bw.eval_accel_sorted(lists, pos_s, mass_s, DT,
                                                   **ekw), REPS, device)
        t_r = time_refresh(lists, pos_s, vel_s, mass_s, device)
        acc = bw.eval_accel_sorted(lists, pos_s, mass_s, DT, **ekw)
        acc_o = acc[:, lists.inv_order.long()[idx]].double().cpu().numpy()
        aerr = np.linalg.norm(acc_o - exact, axis=0)
        err = aerr / np.maximum(mag, 1e-12)
        errn = aerr / rms_mag
        rec = dict(cfg=tag, rebuild_ms=t_b, eval_ms=t_e, refresh_ms=t_r,
                   **far_stats(lists.far_n, L),
                   err_med=float(np.median(err)),
                   err_p99=float(np.percentile(err, 99)),
                   errn_med=float(np.median(errn)),
                   errn_p99=float(np.percentile(errn, 99)),
                   errn_rms=float(np.sqrt((errn ** 2).mean())),
                   far_shape=tuple(lists.far.shape))
        out(f"{tag}: rebuild {t_b:.0f} ms | eval {t_e:.1f} ms"
            f" | refresh {t_r:.0f} ms | far_n mean={rec['far_n_mean']:.0f}"
            f" p99={rec['far_n_p99']:.0f} max={rec['far_n_max']}"
            f" at_cap={rec['at_cap']}"
            f" | err med={rec['err_med']:.4f} p99={rec['err_p99']:.3f}"
            f" | err/rms med={rec['errn_med']:.4f}"
            f" p99={rec['errn_p99']:.3f} rms={rec['errn_rms']:.4f}"
            f" | far {rec['far_shape']}, ms {t_b:.3f} / {t_e:.4f} /"
            f" {t_r:.3f}", flush=True)
        recs.append(rec)
        del lists, acc, pos_s, vel_s, mass_s
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--sample", type=int, default=SAMPLE)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide_1m")
    n = bodies_of(a)
    print(device_line(dev), flush=True)
    run(n, dev, a.sample)
    return 0


if __name__ == "__main__":
    sys.exit(main())
