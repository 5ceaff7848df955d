"""The 10M force-error tail split by its suspected causes (port of
``scripts/decide20.py``).

    python -m spatialsim_tpu_torch.tools.decide20 [n] [--device cuda|cpu]

The cluster (seed 0) at ``n`` bodies (default 10M) at the script's
configuration (theta 0.8, G 0.08, softening 3, spawn radius 700, drift
off, resolved), the direct sum at 2,048 sampled bodies
(``default_rng(1)``; :mod:`~spatialsim_tpu_torch.tools.oracle`, kernel
1's targets-and-sources mode on a card), then ``calibrate_config`` and
the script's three variants: ``prod_uncal`` (the resolved configuration),
``calibrated`` and ``cal_L16k`` (calibrated, list cap 16,384).  For each,
the build (host clock ended by a synchronise), far_n's mean and p99, the
groups at the list cap, the residual mass (every rangeless pool entry of
a group, summed in one fixed order: ``torch.segment_reduce`` over the
tiles' sorted group ids, in float64) as a share of the total, one eval of
the original-order state (``eval_accel``: kernel 2 on a card for pooled
lists, kernel 3 for dense ones), and |da|/|a|'s median, p99 and rms: of
every sample, of the samples whose group is at the cap or not, of those
whose group's residual mass lies above the 90th percentile of the nonzero
ones or is zero, and of the lowest tenth of |F| and the rest; beside it
the rms of |da| over the median |F|.  A variant that raises prints the
script's ``FAILED`` line and the next one runs.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time

import numpy as np
import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.chain import sync
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import (
    add_bodies, bodies_of, device_of, exact_accel_at, initial_conditions,
    sample_ids)

SAMPLE = 2048
# The script's variants: (tag, None = the resolved configuration, else
# the calibrated one replaced by these fields).
VARIANTS = (("prod_uncal", None), ("calibrated", {}),
            ("cal_L16k", {"list_capacity": 16384}))


def cluster_config(n: int) -> NBodyConfig:
    """The script's configuration, resolved for ``n``."""
    return resolve_config(NBodyConfig(
        num_bodies=n, theta=0.8, G=0.08, softening=3.0, damping=1.0,
        spawn_radius=700.0, distribution="cluster", engine="window",
        rebuild_drift_mode="off"), n)


def residual_mass(pool, pstart, ng) -> torch.Tensor:
    """Each group's residual mass, float64 ``(ng,)``: the mass of its pool
    entries without a body range (start == end), summed over the tiles of
    the group in one fixed order.  A tile's group is the last whose
    ``pstart`` is at or before it (the script's ``searchsorted``); tile
    indices are formed in int64."""
    ct, _, tile = pool.shape
    fs, fe = bw._pool_ranges(pool)
    pm = pool.transpose(0, 1).reshape(bw.POOL_ROWS, ct * tile)[6]
    t_idx = torch.arange(ct * tile, dtype=torch.int64,
                         device=pool.device) // tile
    g_of = torch.searchsorted(pstart.long(), torch.arange(
        ct, dtype=torch.int64, device=pool.device), right=True) - 1
    g_flat = g_of[t_idx].clamp(0, ng - 1)
    resm = torch.where((fs == fe) & (pm > 0), pm, torch.zeros_like(pm))
    lengths = torch.bincount(g_flat, minlength=ng)
    return torch.segment_reduce(resm.double(), "sum", lengths=lengths)


def quantiles(x) -> str:
    """The script's ``q``: count, median, p99 and rms, or ``n=0``."""
    if x.size == 0:
        return "n=0"
    return (f"n={x.size} med={np.median(x):.4f} "
            f"p99={np.percentile(x, 99):.4f} "
            f"rms={np.sqrt((x ** 2).mean()):.4f}")


def splits(err, aerr, mag, smp_cap, smp_res, res_g):
    """The script's split of the errors: ``{name: samples' errors}``
    (``abs``: |da| over the median |F|)."""
    hi = (smp_res > np.percentile(res_g[res_g > 0], 90)
          if (res_g > 0).any() else np.zeros_like(smp_cap))
    low = mag < np.percentile(mag, 10)
    return {"all": err, "abs": aerr, "at-cap": err[smp_cap],
            "not-cap": err[~smp_cap], "hi-res": err[hi],
            "zero-res": err[smp_res == 0], "lowF": err[low],
            "highF": err[~low]}


def variant(tag, cfg, pos, vel, mass, idx_np, exact, device, out):
    """One variant's lines; returns its record."""
    kw = bw._build_kw(cfg)
    sync(device)
    t0 = time.perf_counter()
    lists = bw.build_lists(pos, vel, mass, **kw)
    sync(device)
    t_build = time.perf_counter() - t0
    fn = lists.far_n.cpu().numpy()
    ng = fn.shape[0]
    at_cap = fn >= cfg.list_capacity - 1
    if lists.pool is not None:
        res_g = residual_mass(lists.pool, lists.pstart, ng).cpu().numpy()
    else:
        res_g = np.zeros(ng)
    t0 = time.perf_counter()
    acc = bw.eval_accel(lists, pos, mass, 0.0, G=cfg.G,
                        softening=cfg.softening, group_size=cfg.group_size,
                        window_groups=cfg.window_groups)
    a = acc[:, torch.as_tensor(idx_np, device=device)].double().cpu().numpy()
    t_eval = time.perf_counter() - t0
    del acc
    mag = np.linalg.norm(exact, axis=0)
    d = np.linalg.norm(a - exact, axis=0)
    err = d / np.maximum(mag, 1e-12)
    aerr = d / np.median(mag)
    g_smp = lists.inv_order.cpu().numpy()[idx_np] // cfg.group_size
    mtot = float(mass.double().sum())
    sp = splits(err, aerr, mag, at_cap[g_smp], res_g[g_smp], res_g)
    rec = dict(tag=tag, build_s=t_build, eval_s=t_eval,
               far_mean=float(fn.mean()), far_p99=float(np.percentile(fn, 99)),
               at_cap=int(at_cap.sum()), groups=ng,
               res_mass_frac=float(res_g.sum() / mtot),
               splits={k: v.tolist() for k, v in sp.items()})
    out(f"[{tag}] build={t_build:.0f}s eval={t_eval:.1f}s "
        f"far_n mean={fn.mean():.0f} p99={np.percentile(fn, 99):.0f} "
        f"at_cap={rec['at_cap']}/{ng} "
        f"res_mass_frac={rec['res_mass_frac']:.3f}  "
        f"(build {t_build * 1e3:.3f} ms, eval {t_eval * 1e3:.3f} ms)",
        flush=True)
    out(f"  all      rel {quantiles(err)} | abs-norm rms="
        f"{np.sqrt((aerr ** 2).mean()):.4f}", flush=True)
    for name in ("at-cap", "not-cap", "hi-res", "zero-res"):
        out(f"  {name:<8s} rel {quantiles(sp[name])}", flush=True)
    out(f"  lowF     rel {quantiles(sp['lowF'])} | "
        f"highF rel {quantiles(sp['highF'])}", flush=True)
    return rec


def run(n=10_000_000, device="cuda", out=print):
    """The oracle, the calibration and the variants; returns one record a
    variant that ran."""
    device = torch.device(device)
    base = cluster_config(n)
    pos, vel, mass = initial_conditions("cluster", n, base.spawn_radius,
                                        base.G, device)
    idx_np = sample_ids(n, SAMPLE)
    t0 = time.perf_counter()
    exact = exact_accel_at(pos[:, torch.as_tensor(idx_np, device=device)],
                           pos, mass, base.G, base.softening)
    exact = exact.double().cpu().numpy()
    mag = np.linalg.norm(exact, axis=0)
    out(f"oracle: {time.perf_counter() - t0:.0f} s | "
        f"|F| median={np.median(mag):.4g} p10={np.percentile(mag, 10):.4g}",
        flush=True)
    t0 = time.perf_counter()
    cal = bw.calibrate_config(base, pos, vel, mass)
    out(f"calibrate: {time.perf_counter() - t0:.0f} s "
        f"wl_caps={list(cal.wl_caps) or 'default'}", flush=True)
    recs = []
    for tag, over in VARIANTS:
        try:
            cfg = base if over is None else cal.replace(**over)
            recs.append(variant(tag, cfg, pos, vel, mass, idx_np, exact,
                                device, out))
        except Exception as ex:  # noqa: BLE001 -- one variant's OOM must
            # not end the others: the script's FAILED line.
            out(f"[{tag}] FAILED {type(ex).__name__}: {str(ex)[:300]}",
                flush=True)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    out("done", flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 10_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide20")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
