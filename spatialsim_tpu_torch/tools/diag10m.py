"""Memory and time at 10M bodies, one phase at a time (port of
``scripts/diag10m.py``).

    python -m spatialsim_tpu_torch.tools.diag10m [n] [budget] [pool_tile]
        [--skip-calibrate] [--device cuda|cpu]

The Plummer ``cluster`` (seed 0) at ``n`` bodies (default 10M) at the
script's configuration (theta 0.8, rebuild interval 24; ``budget`` and
``pool_tile`` override the worklist budget and the pool tile), resolved,
then calibrated on the initial conditions (``--skip-calibrate`` skips
that, as the script's ``EXTREME_SKIP_CALIBRATE=1`` does).  The phases run
the engine's own path one at a time, each ended by a synchronise and
timed by the host clock: the initial conditions, the calibration, the
first build (``init_window_state``), four dispatches of 24 steps
(``make_step_fn``; each after the first crosses a rebuild), then the
sustained rate over two more.  After each, the device memory: the peak
that PyTorch allocated (``torch.cuda.max_memory_allocated``), the card's
total (``torch.cuda.mem_get_info``) and an analytic ledger of the
port's own tensors (:func:`ledger`), in GB (1e9 bytes).  The script's
ledger counts the JAX engine's buffers against a TPU's HBM; this one
counts what the port allocates.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.models.nbody import make_step_fn
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.ops.bh_eval_kernel import POOL_ROWS
from spatialsim_tpu_torch.ops.octree import level_capacity
from spatialsim_tpu_torch.tools.eval_ab import _sync, device_line
from spatialsim_tpu_torch.tools.oracle import (
    add_bodies, bodies_of, device_of, initial_conditions)

DT = 0.02
CHAIN = 24
GB = 1e9


def diag_config(n, budget=0, pool_tile=-1) -> NBodyConfig:
    cfg = NBodyConfig(num_bodies=n, theta=0.8, G=0.1, softening=2.0,
                      damping=1.0, spawn_radius=500.0,
                      distribution="cluster", engine="window",
                      rebuild_interval=24)
    if budget:
        cfg = cfg.replace(worklist_budget=budget)
    if pool_tile >= 0:
        cfg = cfg.replace(pool_tile=pool_tile)
    return resolve_config(cfg, n)


def dense_rows(cfg) -> int:
    """R of the dense far tensor the build makes for ``cfg``."""
    quad = getattr(cfg, "use_quadrupole", False)
    acc = getattr(cfg, "advance_order", 2) >= 2
    return (16 if acc else 13) if quad else (10 if acc else 8)


def ledger(cfg, n) -> dict:
    """Bytes of the port's tensors at ``cfg``: ``state`` (sorted pos, vel,
    acc with the second-order advance, the reference positions, mass,
    order and inverse order), ``lists`` (the pool ``(ct, 16, tile)`` with
    pstart and far_n, or the dense ``(ng, R, L)`` far tensor with far_n and
    its ``(ng, 2, L)`` int32 ranges), ``worklists`` (the build's int64
    group and cell ids on the two largest consecutive levels) and
    ``emission`` (the traversal's int64 cell ids, or two int64 range ends,
    ``ng x L``)."""
    kw = bw._build_kw(cfg)
    gsz = kw["group_size"]
    npad = -(-n // gsz) * gsz
    ng = npad // gsz
    n_levels = kw["max_depth"] - 2 + 1
    bud = kw["worklist_budget"] or bw._auto_budget(npad)
    wl_caps = (tuple(kw["wl_caps"]) or bw._default_wl_caps(
        ng, n_levels, bud, c0=level_capacity(2, npad)))
    acc = getattr(cfg, "advance_order", 2) >= 2
    L, tile = kw["list_cap"], kw["pool_tile"]
    out = {"state": 4.0 * (3 * n * (3 + acc) + n + npad + n)}
    if tile:
        ct = kw["pool_cap"] or bw.pool_cap_tiles(
            bud, ng, tile, npad, caps_total=sum(wl_caps) if kw["wl_caps"]
            else 0)
        out["lists"] = 4.0 * (ct * POOL_ROWS * tile + 2 * ng)
        out["pool_tiles"] = ct
    else:
        out["lists"] = 4.0 * (ng * dense_rows(cfg) * L + ng + 2 * ng * L)
    pairs = [a + b for a, b in zip(wl_caps, wl_caps[1:])] or list(wl_caps)
    out["worklists"] = 16.0 * max(pairs)
    out["emission"] = 8.0 * ng * L * (1 if tile else 2)
    return out


def memory_line(device, led) -> str:
    parts = " ".join(f"{k}={v / GB:.3f}" for k, v in led.items()
                     if k != "pool_tiles")
    total = sum(v for k, v in led.items() if k != "pool_tiles")
    line = f"ledger GB: {parts} sum={total / GB:.3f}"
    if device.type != "cuda":
        return line + " | device memory: not measured on the CPU"
    peak = torch.cuda.max_memory_allocated(device) / GB
    card = torch.cuda.mem_get_info(device)[1] / GB
    return f"{line} | peak allocated {peak:.3f} of the card's {card:.3f}"


def run(n=10_000_000, budget=0, pool_tile=-1, skip_calibrate=False,
        device="cuda", out=print):
    """The phases; returns ``{"cfg", "ledger", "phases": [(label, s,
    peak GB or None)], "steps_per_s"}``."""
    device = torch.device(device)
    t0 = time.perf_counter()
    cfg = diag_config(n, budget, pool_tile)
    phases = []

    def phase(label, t1):
        _sync(device)
        peak = (torch.cuda.max_memory_allocated(device) / GB
                if device.type == "cuda" else None)
        phases.append((label, time.perf_counter() - t1, peak))
        out(f"[{time.perf_counter() - t0:7.1f}s] {label} OK "
            f"{time.perf_counter() - t1:.3f}s | "
            + memory_line(device, ledger(cfg, n)), flush=True)

    out(f"device={device.type} n={n:,} depth={cfg.max_depth} "
        f"gsz={cfg.group_size} L={cfg.list_capacity} pool={cfg.pool_tile} "
        f"emit={cfg.traversal_emit} adv={cfg.advance_order}", flush=True)
    t1 = time.perf_counter()
    pos, vel, mass = initial_conditions("cluster", n, cfg.spawn_radius,
                                        cfg.G, device)
    phase("ICs on device", t1)
    if skip_calibrate:
        out(f"[{time.perf_counter() - t0:7.1f}s] calibrate skipped "
            f"(EXTREME)", flush=True)
    else:
        t1 = time.perf_counter()
        cfg = bw.calibrate_config(cfg, pos, vel, mass)
        phase("calibrate", t1)
    out(f"  tree_caps={list(cfg.tree_caps or ())}", flush=True)
    out(f"  wl_caps={list(cfg.wl_caps or ())}", flush=True)
    led = ledger(cfg, n)
    if "pool_tiles" in led:
        out(f"  pool cap_tiles={led['pool_tiles']}", flush=True)

    step = make_step_fn(cfg, n, substeps=CHAIN, engine="window")
    t1 = time.perf_counter()
    state = bw.init_window_state(pos, vel, mass, cfg)
    phase("init_window_state", t1)
    del pos, vel, mass
    for i in range(4):
        label = ("eval-chain" if state.lists.steps_build < CHAIN
                 else "rebuild+chain")
        t1 = time.perf_counter()
        state = step(state, DT)
        phase(f"dispatch {i} ({label})", t1)
    _sync(device)
    t1 = time.perf_counter()
    for _ in range(2):
        state = step(state, DT)
    _sync(device)
    rate = 2 * CHAIN / (time.perf_counter() - t1)
    out(f"[{time.perf_counter() - t0:7.1f}s] sustained {rate:.2f} steps/s "
        f"({1000.0 / rate:.0f} ms/step; {1000.0 / rate:.3f}); "
        f"{step.rebuilds} rebuilds in {6 * CHAIN} steps", flush=True)
    return dict(cfg=cfg, ledger=led, phases=phases, steps_per_s=rate)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 10_000_000)
    ap.add_argument("budget", type=lambda x: int(float(x)), nargs="?",
                    default=0)
    ap.add_argument("pool_tile", type=int, nargs="?", default=-1)
    ap.add_argument("--skip-calibrate", action="store_true",
                    help="the script's EXTREME_SKIP_CALIBRATE=1")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "diag10m")
    print(device_line(dev), flush=True)
    run(bodies_of(a), a.budget, a.pool_tile, a.skip_calibrate, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
