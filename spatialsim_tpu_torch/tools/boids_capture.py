"""Boids window capture at production scale: the share of the true
neighbour pairs that one Morton window pass and two passes see (port of
``scripts/boids_capture.py``).

    python -m spatialsim_tpu_torch.tools.boids_capture [--boids 100000]
        [--sample 4000] [--device cuda|cpu]

At the default config for ``--boids`` agents (the script's 100K): a
uniform flock and a clustered one (200 centres, normal spread 4), both
from ``default_rng(7)`` as the script draws them; for each, the first
pass (``ops/boids_ops._window_pass``: kernel 4 on a card) on the grid
cells' Morton codes and the dedup'd second pass on the codes shifted by
3/7 of the grid, each boid's neighbour count, and on ``--sample``
sampled boids (``default_rng(0)``) the share of the exact pair count
(a chunked float64 brute force on the host) each form captures.  Fails
if two passes count a pair twice.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from spatialsim_tpu_torch.config.boids import BoidsConfig
from spatialsim_tpu_torch.ops import boids_ops as B
from spatialsim_tpu_torch.ops.morton import _spread3
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import device_of

N = 100_000
SAMPLE = 4000
CENTRES = 200


def sampled_exact_counts(pos_np, idx, radius, chunk=512):
    """Each sampled boid's neighbours within ``radius`` (excluding
    itself and exact overlaps), in float64."""
    p = pos_np.astype(np.float64)
    out = np.zeros(len(idx), np.int64)
    for k in range(0, len(idx), chunk):
        tgt = p[:, idx[k:k + chunk]]
        d2 = ((tgt[:, :, None] - p[:, None, :]) ** 2).sum(axis=0)
        out[k:k + chunk] = ((d2 > 0.0001) & (d2 < radius ** 2)).sum(axis=1)
    return out


def _code(c):
    return _spread3(c[0]) | (_spread3(c[1]) << 1) | (_spread3(c[2]) << 2)


def capture(pos_np, cfg, gsz, wg, sh, wgb, sample=SAMPLE, device="cpu"):
    """(single-pass share, two-pass share, exact pairs) on the sample."""
    n = pos_np.shape[1]
    pos = torch.as_tensor(pos_np.astype(np.float32), device=device)
    vel = torch.zeros_like(pos)
    col = torch.zeros_like(pos)
    c = B.cell_coords(pos, cfg.cell_size, cfg.grid_dim,
                      cfg.bounds + cfg.cell_size)

    def kw(w, pwg=None):
        return dict(n=n, gsz=gsz, wg=w, prev_wg=pwg,
                    perception_sq=float(cfg.perception_radius ** 2),
                    separation_sq=float(cfg.separation_radius ** 2))

    rows1, grp = B._window_pass(pos, vel, col, None, _code(c), **kw(wg))
    rows2, _ = B._window_pass(pos, vel, col, grp, _code(c + sh),
                              **kw(wgb, wg))
    nb_one = rows1[13].cpu().numpy().astype(np.int64)
    nb_two = nb_one + rows2[13].cpu().numpy().astype(np.int64)
    idx = np.random.default_rng(0).choice(n, sample, replace=False)
    nbe = sampled_exact_counts(pos_np, idx, cfg.perception_radius)
    tot = max(int(nbe.sum()), 1)
    if not (nb_two[idx] <= nbe).all():
        raise AssertionError("double counting!")
    return nb_one[idx].sum() / tot, nb_two[idx].sum() / tot, tot


def run(n=N, sample=SAMPLE, device="cuda", out=print):
    """Both distributions; returns ``{"uniform": (s1, s2, tot),
    "clustered": ...}``."""
    if n % CENTRES:
        raise ValueError(f"{n} boids: the clustered flock puts n // "
                         f"{CENTRES} boids at each of {CENTRES} centres; "
                         f"give a multiple of {CENTRES}")
    rng = np.random.default_rng(7)
    cfg = BoidsConfig(num_boids=n)
    gd = cfg.grid_dim
    gsz, wg = cfg.group_size, cfg.window_groups
    sh = max(1, (gd * 3) // 7)
    tag = f"{n // 1000}k" if n % 1000 == 0 else str(n)
    res = {}
    uni = (rng.random((3, n)) - 0.5) * 2 * cfg.bounds
    s1, s2, tot = res["uniform"] = capture(uni, cfg, gsz, wg, sh, wg,
                                           sample, device)
    out(f"uniform{tag} grid={gd} shift={sh} pairs~{tot}: "
        f"single={s1:.4f} two={s2:.4f}", flush=True)
    centers = (rng.random((3, CENTRES)) - 0.5) * 2 * (cfg.bounds - 20)
    clu = (np.repeat(centers, n // CENTRES, axis=1)
           + rng.normal(size=(3, n)) * 4.0)
    clu = clu.clip(-cfg.bounds, cfg.bounds)
    s1, s2, tot = res["clustered"] = capture(clu, cfg, gsz, wg, sh, wg,
                                             sample, device)
    out(f"clustered{tag} pairs~{tot}: single={s1:.4f} two={s2:.4f}",
        flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--boids", type=int, default=N)
    ap.add_argument("--sample", type=int, default=SAMPLE)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "boids_capture")
    print(device_line(dev), flush=True)
    run(a.boids, a.sample, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
