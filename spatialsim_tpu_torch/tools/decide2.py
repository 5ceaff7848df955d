"""Group size, window and list cap at 1M: rebuild, eval, refresh and the
fresh lists' force error (port of ``scripts/decide2.py``).

    python -m spatialsim_tpu_torch.tools.decide2 [n] [--device cuda|cpu]

The galaxy (seed 0) at ``n`` bodies (default 1M) at the round-3 sweeps'
configuration (:func:`~spatialsim_tpu_torch.tools.eval_ab.ab_config`),
for each of the script's (group size, window groups, list cap) variants:
the build with zero accelerations (the configuration's layout: pooled
at these sizes), one eval of the sorted state (``eval_accel_sorted``:
kernel 2 on a card for pooled lists, kernel 3 for dense ones) and one
refresh (``refresh_lists``), each the fastest of 3 after a warm-up (host
clock ended by a synchronise; CUDA events at the line's end); far_n's
mean, p99, max and groups at the cap; the pairs a body (window plus mean
far_n); and |da|/|a| and |da|/rms|F| on 1,024 sampled bodies
(``default_rng(1)``) against the direct sum of
:mod:`~spatialsim_tpu_torch.tools.oracle` (kernel 1's targets-and-sources
mode on a card).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools import round3 as r3
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of

SAMPLE = 1024
# The script's (tag, group size, window groups, list cap).
VARIANTS = (("G128_W2_L6144", 128, 2, 6144),
            ("G128_W1_L6144", 128, 1, 6144),
            ("G256_W1_L6144", 256, 1, 6144),
            ("G128_W2_L4096", 128, 2, 4096),
            ("G64_W2_L4096", 64, 2, 4096))


def measure(cfg, pos, vel, mass, ora, device, use_cols=()):
    """Build, evals (one a ``use_cols`` value, the first also the error's;
    none: the script's one eval) and refresh of one configuration: a
    record of times ((host, device) ms), far_n statistics and errors."""
    idx, exact, mag, rms_mag = ora
    kw = bw._build_kw(cfg)
    acc0 = torch.zeros_like(pos)
    built = []
    t_b = r3.timed(lambda: built.append(
        bw.build_lists(pos, vel, mass, acc0, **kw)), device)
    lists = built[-1]
    del built
    fn = lists.far_n.cpu().numpy()
    pos_s, vel_s, mass_s = r3.sorted_state(lists, pos, vel, mass)
    ekw = r3.eval_kw(cfg)
    evals, accs = {}, {}
    for cols in use_cols or (False,):
        evals[cols] = r3.timed(lambda: bw.eval_accel_sorted(
            lists, pos_s, mass_s, r3.DT, use_cols=cols, **ekw), device)
        accs[cols] = bw.eval_accel_sorted(lists, pos_s, mass_s, r3.DT,
                                          use_cols=cols, **ekw)
    t_r = r3.timed(lambda: bw.refresh_lists(
        lists, pos_s, vel_s, mass_s, acc0, r3.DT, 24.0), device)
    acc = accs[(use_cols or (False,))[-1]]
    err, errn = r3.errors(acc, lists, idx, exact, mag, rms_mag)
    L, gsz, wg = cfg.list_capacity, cfg.group_size, cfg.window_groups
    rec = dict(rebuild=t_b, evals=evals, refresh=t_r,
               far_mean=float(fn.mean()), far_p99=float(np.percentile(fn, 99)),
               far_max=int(fn.max()), at_cap=int((fn >= L - 1).sum()),
               pairs=float((2 * wg + 1) * gsz + fn.mean()),
               err_med=float(np.median(err)),
               err_p99=float(np.percentile(err, 99)),
               errn_med=float(np.median(errn)),
               errn_p99=float(np.percentile(errn, 99)),
               errn_rms=float(np.sqrt((errn ** 2).mean())),
               kernel=r3.eval_kernel(lists))
    if len(accs) == 2:
        old = accs[False]
        rec["kern_dev"] = float((accs[True] - old).abs().max()
                                / max(float(old.abs().max()), 1e-30))
    return rec


def tail(rec) -> str:
    """The script's fields after the times, shared by decide2 and 3."""
    return (f" | refresh {rec['refresh'][0]:.0f} ms"
            f" | far_n mean={rec['far_mean']:.0f}"
            f" p99={rec['far_p99']:.0f} max={rec['far_max']}"
            f" at_cap={rec['at_cap']}"
            f" | pairs/body={rec['pairs']:.0f}"
            f" | err med={rec['err_med']:.4f} p99={rec['err_p99']:.3f}"
            f" | err/rms med={rec['errn_med']:.4f}"
            f" p99={rec['errn_p99']:.3f} rms={rec['errn_rms']:.4f}")


def run(n=1_000_000, device="cuda", out=print):
    """The sweep; returns ``{tag: record}``."""
    device = torch.device(device)
    base = r3.ab_config(n)
    out(f"n={n:,} platform={device.type}", flush=True)
    pos, vel, mass = r3.initial_state(base, device)
    ora = r3.oracle(pos, mass, base, min(SAMPLE, n), device)
    out("exact oracle ready", flush=True)
    recs = {}
    for tag, gsz, wg, L in VARIANTS:
        cfg = base.replace(group_size=gsz, window_groups=wg,
                           list_capacity=L)
        rec = recs[tag] = measure(cfg, pos, vel, mass, ora, device)
        t_e = rec["evals"][False]
        out(f"{tag}: rebuild {rec['rebuild'][0]:.0f} ms"
            f" | eval {t_e[0]:.1f} ms" + tail(rec)
            + f" | host ms {rec['rebuild'][0]:.3f} / {t_e[0]:.4f} / "
            f"{rec['refresh'][0]:.3f}; rebuild {r3.dev_text(rec['rebuild'])}"
            f", eval {r3.dev_text(t_e)}, refresh "
            f"{r3.dev_text(rec['refresh'])}; {rec['kernel']}", flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide2")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
