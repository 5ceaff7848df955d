"""A/B of the dense window eval's three forms, and the list rebuild with
and without near groups (port of ``scripts/eval_ab.py``).

    python -m spatialsim_tpu_torch.tools.eval_ab --device cuda

Set-up: the galaxy (seed 0) at 1M bodies, at that script's config (theta
0.8, G 0.1, softening 2, spawn radius 500, skin 2, rebuild interval 48,
drift off) with the dense layout (``pool_tile=0``), built with zero
accelerations (R = 10 rows).  It times the rebuild at K = 0 and at K =
``--near-groups`` (8), and the row, column and matrix kernels on both sets
of lists, and prints the lists' ``far_n`` means.  On a card the times are
CUDA events and the first line is ``nvidia-smi``'s name and power limit;
``--device cpu`` runs the plain versions on a host clock, for a tiny smoke
test only.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from spatialsim_tpu_torch import distributions
from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
from spatialsim_tpu_torch.ops import bh_window as bw

DT = 0.02
# The eval's forms: ``window_eval``'s (use_cols, use_mxu), and the plain
# version of the kernel that each selects.
FORMS = {
    "row": ((False, False), ek.window_eval_reference),
    "cols": ((True, False), ek.window_eval_cols_reference),
    "mxu": ((False, True), ek.window_eval_mxu_reference),
}
# FP32 operations a pair, counted from each kernel's body (FMA as 2, the
# rsqrt and the gate not counted).
OPS_PER_PAIR = {"row": 18.0, "cols": 18.0, "mxu": 20.0}


def ab_config(n: int) -> NBodyConfig:
    """``scripts/eval_ab.py``'s configuration, resolved for ``n``."""
    return resolve_config(NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, damping=1.0,
        spawn_radius=500.0, distribution="galaxy", engine="window", skin=2.0,
        rebuild_interval=48, rebuild_drift_mode="off"), n)


def initial_state(cfg: NBodyConfig, device, seed: int = 0):
    """(pos, vel, mass) of the galaxy on ``device``, ``(3, n)``/``(n,)``."""
    p, v, m = distributions.generate_distribution(
        "galaxy", cfg.num_bodies, cfg.spawn_radius, cfg.G, seed=seed)
    return tuple(torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                 device=device) for a in (p.T, v.T, m))


def build_kw(cfg: NBodyConfig, near_groups: int = 0) -> dict:
    """The rebuild's keyword arguments: dense layout, ``near_groups``."""
    return dict(bw._build_kw(cfg), pool_tile=0, near_groups=near_groups)


def sorted_inputs(lists, pos, mass):
    """Original-order state -> the sorted, padded ``(3, npad)``/``(npad,)``
    eval inputs of ``lists``."""
    n = pos.shape[1]
    o = lists.order[:n].long()
    pad = lists.order.shape[0] - n
    s_pos = torch.cat([pos[:, o], pos[:, o[-1:]].expand(3, pad)], 1)
    s_mass = torch.cat([mass[o], mass.new_zeros(pad)])
    return s_pos.contiguous(), s_mass


def eval_kw(cfg: NBodyConfig) -> dict:
    return dict(G=cfg.G, softening=cfg.softening, group_size=cfg.group_size,
                window_groups=cfg.window_groups,
                tau_clamp=float(cfg.advance_tau_clamp))


def run_form(form, lists, s_pos, s_mass, cfg, steps_since=0, plain=False):
    """One eval of ``form`` on the dense ``lists``: through ``window_eval``
    (the kernel on a card), or its plain version with ``plain``."""
    (use_cols, use_mxu), reference = FORMS[form]
    args = (s_pos, s_mass, lists.far, lists.far_n, lists.near, steps_since,
            DT)
    kw = eval_kw(cfg)
    tile = dict(far_tile=cfg.eval_far_tile) if form != "row" else {}
    if plain:
        return reference(*args, **kw, **tile)
    return ek.window_eval(*args, use_cols=use_cols, use_mxu=use_mxu,
                          far_tile=cfg.eval_far_tile, **kw)


def form_work(form, lists, cfg):
    """(pairs, FP32 operations, bytes) that one eval of ``form`` needs:
    every in-range window group and valid near group is gsz x gsz pairs,
    every live far entry (``far_n``) gsz pairs.  The column and matrix
    kernels read whole tiles, but the slots past ``far_n`` hold zero mass
    and add nothing, so they are not counted.  Bytes: the bodies, the live
    far entries, far_n and the near table read once, the accelerations
    written once."""
    gsz, wg = cfg.group_size, cfg.window_groups
    far_n = lists.far_n.long()
    ng, R, L = lists.far.shape
    g = torch.arange(ng, device=far_n.device)
    n_src = torch.clamp(g + wg, max=ng - 1) - torch.clamp(g - wg, min=0) + 1
    if lists.near is not None:
        n_src = n_src + ((lists.near >= 0) & (lists.near < ng)).sum(1)
    slots = int(far_n.clamp(0, L).sum())
    pairs = int(n_src.sum()) * gsz * gsz + slots * gsz
    nbytes = 4 * (ng * gsz * (4 + 3) + R * slots + ng
                  + (0 if lists.near is None else lists.near.numel()))
    return pairs, OPS_PER_PAIR[form] * pairs, nbytes


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps, device):
    """Mean milliseconds a call after one warm-up: CUDA events on a card,
    the host clock on the CPU."""
    fn()
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def time_build_ms(pos, vel, mass, kw, reps, device):
    """Fastest of ``reps`` rebuilds after one warm-up (host clock, each
    ended by a synchronise), and the lists."""
    acc0 = torch.zeros_like(pos)
    lists = bw.build_lists(pos, vel, mass, acc0, **kw)
    best = float("inf")
    for _ in range(reps):
        _sync(device)
        t = time.perf_counter()
        lists = bw.build_lists(pos, vel, mass, acc0, **kw)
        _sync(device)
        best = min(best, (time.perf_counter() - t) * 1e3)
    return best, lists


def device_line(device) -> str:
    if device.type != "cuda":
        return "device cpu (plain versions, host clock: no device times)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return f"{smi} | {torch.cuda.get_device_name(device)}"


def run(n=1_000_000, near_groups=8, reps=3, device="cuda", seed=0,
        out=print):
    """The A/B.  Returns ``{"cfg", "pos", "mass", "lists": {K: lists},
    "build_ms": {K: ms}, "eval_ms": {(K, form): ms}}``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("eval_ab: device cuda requested but "
                           "torch.cuda.is_available() is False")
    out(device_line(device))
    cfg = ab_config(n)
    pos, vel, mass = initial_state(cfg, device, seed)
    res = dict(cfg=cfg, pos=pos, mass=mass, lists={}, build_ms={},
               eval_ms={})
    out(f"n={n:,} group {cfg.group_size} depth {cfg.max_depth} list cap "
        f"{cfg.list_capacity} far tile {cfg.eval_far_tile}")
    for K in (0, near_groups):
        ms, lists = time_build_ms(pos, vel, mass, build_kw(cfg, K), reps,
                                  device)
        res["build_ms"][K], res["lists"][K] = ms, lists
        out(f"rebuild K={K}: {ms:.3f} ms  far {tuple(lists.far.shape)}")
        s_pos, s_mass = sorted_inputs(lists, pos, mass)
        for form in FORMS:
            t = time_ms(lambda: run_form(form, lists, s_pos, s_mass, cfg),
                        reps, device)
            res["eval_ms"][(K, form)] = t
            pairs = form_work(form, lists, cfg)[0]
            out(f"K={K} {form}: {t:.4f} ms  {pairs:.4e} pairs  "
                f"{pairs / t / 1e6:.1f} Gpairs/s")
    fm = {K: float(lists.far_n.float().mean())
          for K, lists in res["lists"].items()}
    out("far_n mean: " + ", ".join(f"K={K} {v:.1f}" for K, v in fm.items()))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bodies", type=int, default=1_000_000)
    ap.add_argument("--near-groups", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    run(a.bodies, a.near_groups, a.reps, a.device, a.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
