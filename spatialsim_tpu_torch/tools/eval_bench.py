"""Eval cost through chains of steps with no rebuild, at production scale
(port of ``scripts/eval_bench.py``).

    python -m spatialsim_tpu_torch.tools.eval_bench [n] [variant] [--all]
        [--device cuda|cpu]

The galaxy (seed 0) at ``n`` bodies (default 1M) at the script's base
configuration (depth 8, group 256, window 2, list cap 6,144, skin 6, no
rebuild, no drift check, monopole), changed by one of the script's 12
variants.  A dispatch of 16 substeps (no rebuild inside) runs once to
warm up, then 3 times, each ended by a synchronise; the line is the
fastest dispatch's ms a step, as the script prints it.  Without a
variant it runs the first, as the script does; ``--all`` runs all 12,
one process each (the script's rule).

Two of the script's knobs are the TPU's program layout, which the card's
kernels do not read: ``eval_far_tile`` (the far list's VMEM tile; the
stepper's row and pooled kernels stage one batch of entries a thread)
and ``eval_groups_per_program`` (groups a Pallas program; the card runs
a block a group).  A variant's line names the knobs it sets that have no
effect here, so two lines that time one program say so.  ``xla_fallback``
(``use_pallas_eval=False``: dense lists, the plain eval) runs the dense
kernel's plain version on the card (:func:`plain_step`), asked for by
name; its line says so.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.ops.bh_eval_kernel import window_eval_reference
from spatialsim_tpu_torch.ops.integrator import integrate
from spatialsim_tpu_torch.tools.eval_ab import _sync, device_line
from spatialsim_tpu_torch.tools.oracle import (
    add_bodies, bodies_of, device_of, initial_conditions)

SUB = 16
DT = 0.02
VARIANTS = {
    "tile512_wg2": {},
    "tile256_wg2": {"eval_far_tile": 256},
    "tile128_wg2": {"eval_far_tile": 128},
    "tile256_wg1": {"eval_far_tile": 256, "window_groups": 1},
    "tile256_quad": {"eval_far_tile": 256, "use_quadrupole": True,
                     "quad_accept_scale": 1.0},
    "xla_fallback": {"use_pallas_eval": False},
    # Timing-only probes (physics-breaking list truncation is fine here).
    "probe_L1024": {"list_capacity": 1024},
    "probe_L2048": {"list_capacity": 2048},
    "probe_wg1": {"window_groups": 1},
    "probe_gpp1": {"eval_groups_per_program": 1},
    "probe_gpp8": {"eval_groups_per_program": 8},
    "probe_adv1": {"advance_order": 1},
}
# The TPU program layout's knobs: no kernel of the card reads them.
INERT = ("eval_far_tile", "eval_groups_per_program")


def base_config(n: int) -> NBodyConfig:
    return NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, spawn_radius=500.0,
        distribution="galaxy", engine="window", max_depth=8, group_size=256,
        window_groups=2, list_capacity=6144, skin=6.0,
        rebuild_interval=10 ** 6, rebuild_drift_mode="off",
        use_quadrupole=False)


def note(tag: str) -> str:
    """What a variant's line says beside its time: its knobs that have no
    effect on the card, and the plain version where it runs."""
    over = VARIANTS[tag]
    parts = []
    inert = [k for k in INERT if k in over]
    if inert:
        parts.append("no effect on the card: " + ", ".join(inert))
    if over.get("use_pallas_eval") is False:
        parts.append("the kernels' plain versions, by name")
    return f"  ({'; '.join(parts)})" if parts else ""


def plain_step(config, n: int, substeps: int):
    """``xla_fallback``'s chain: ``make_window_step``'s substep on dense
    lists with the eval taken by the dense kernel's plain version
    (``window_eval_reference``), on any device.  The base configuration
    never rebuilds or refreshes, so neither does this step (a
    configuration that would raises)."""
    cfg = resolve_config(config, n)
    if (cfg.rebuild_interval < 10 ** 6 or cfg.rebuild_drift_mode != "off"
            or cfg.refresh_interval):
        raise ValueError("plain_step: a chain with no rebuild and no "
                         "refresh only")
    ekw = bw._eval_kw(cfg)
    advance2 = cfg.advance_order >= 2

    def substep(st, dt):
        lists = st.lists
        pad = lists.order.shape[0] - n
        s_pos = torch.cat([st.pos, st.pos[:, -1:].expand(3, pad)], 1)
        s_mass = torch.cat([st.mass, st.mass.new_zeros(pad)])
        acc = window_eval_reference(
            s_pos, s_mass, lists.far, lists.far_n, lists.near,
            lists.steps_since, dt, **ekw)[:, :n]
        pos, vel = integrate(st.pos, st.vel, acc, dt, cfg.damping)
        lists = lists._replace(steps_since=lists.steps_since + 1,
                               steps_build=lists.steps_build + 1)
        return bw.WindowBHState(pos, vel, st.mass, lists,
                                acc if advance2 else None)

    def step(st, dt):
        for _ in range(substeps):
            st = substep(st, float(dt))
        return st

    step.rebuilds = 0
    return step


def bench(n=1_000_000, tag="tile512_wg2", device="cuda", out=print):
    """One variant's chain; returns its ms a step (the fastest of 3
    dispatches of ``SUB`` steps)."""
    device = torch.device(device)
    base = base_config(n)
    over = VARIANTS[tag]
    cfg = base.replace(**over)
    pos, vel, mass = initial_conditions("galaxy", n, base.spawn_radius,
                                        base.G, device)
    st = bw.init_window_state(pos, vel, mass, cfg)
    step = (plain_step if over.get("use_pallas_eval") is False
            else bw.make_window_step)(cfg, n, SUB)
    st = step(st, DT)
    _sync(device)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        st = step(st, DT)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    ms = min(ts) / SUB * 1000
    layout = "pooled" if st.lists.pool is not None else \
        f"dense R={st.lists.far.shape[1]}"
    out(f"{tag:14s}: {ms:6.1f} ms/step  ({ms:.4f}; {layout}, "
        f"{step.rebuilds} rebuilds){note(tag)}", flush=True)
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("variant", nargs="?", default=None,
                    choices=sorted(VARIANTS))
    ap.add_argument("--all", action="store_true",
                    help="every variant, one process each")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quiet", action="store_true",
                    help="omit the card's line (--all prints it once)")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "eval_bench")
    n = bodies_of(a)
    if not a.quiet:
        print(device_line(dev), flush=True)
    if not a.all:
        bench(n, a.variant or next(iter(VARIANTS)), dev)
        return 0
    root = Path(__file__).resolve().parents[2]
    for tag in VARIANTS:
        proc = subprocess.run(
            [sys.executable, "-m", "spatialsim_tpu_torch.tools.eval_bench",
             str(n), tag, "--device", a.device, "--quiet"],
            cwd=root, capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stdout.flush()
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
