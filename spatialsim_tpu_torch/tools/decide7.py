"""Stage decomposition of the dense eval kernel by ablation (port of
``scripts/decide7.py``).

    python -m spatialsim_tpu_torch.tools.decide7 [n] [--device cuda|cpu]

The 1M galaxy (seed 0) at the script's configuration (theta 0.8, skin 2,
rebuild interval 48, list cap 6,144), its dense lists built with zero
accelerations (R = 10), evaluated by kernel 3 (``window_eval``, the row
form) with stages switched off one at a time (``dbg``,
:func:`~spatialsim_tpu_torch.ops.bh_eval_kernel.dbg_flags`): the rows

    base       everything on
    nofar      far_n = 0
    now        + the window loop off
    nost       + staging off (the card stages window and far sources in
               the same batches: no stage of its own, so ``now`` again)
    notg       + targets replaced by a constant
    notg_uttr  + the output's layout replaced by block sums
    nouttr     far_n = 0, only the output's layout replaced
    base_uttr  the far lists kept, the output's layout replaced

at (group size, window groups) = (256, 1) and (512, 1).  The script's
``groups_per_program`` (8, 4) is a TPU program width: the card runs one
block a group, and the line says it is ignored.  Each row is timed by CUDA
events (3 calls after a warm-up; the host clock on the CPU, where the
plain version runs), beside its pairs and its bound: max(18 FP32
operations a pair / 67 TFLOP/s, bytes / 3.35 TB/s), the bytes each input
read once and the output written once, as ``PERF.md`` section 6 reckons
kernel 3's.  One process.
"""

from __future__ import annotations

import argparse
import sys

import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.ops.bh_eval_kernel import dbg_flags, window_eval
from spatialsim_tpu_torch.tools.eval_ab import (
    device_line, sorted_inputs, time_ms)
from spatialsim_tpu_torch.tools.oracle import (
    PEAK_BYTES, PEAK_FP32, add_bodies, bodies_of, device_of,
    initial_conditions)

DT = 0.02
REPS = 3
OPS_PER_PAIR = 18.0     # the monopole law, as PERF.md counts kernel 3's
# The script's rows: (tag, far lists kept, dbg).
ROWS = (
    ("base", True, ""),
    ("nofar", False, ""),
    ("now", False, "nowin"),
    ("nost", False, "nowin,nostage"),
    ("notg", False, "nowin,nostage,notgt"),
    ("notg_uttr", False, "nowin,nostage,notgt,nouttr"),
    ("nouttr", False, "nouttr"),
    ("base_uttr", True, "nouttr"),
)
# The script's (group size, window groups, groups_per_program).
GEOMETRIES = ((256, 1, 8), (512, 1, 4))


def ablation_config(n: int, gsz: int, wg: int) -> NBodyConfig:
    """The script's configuration, resolved for ``n``, then its group
    size, window and list cap."""
    base = resolve_config(NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, damping=1.0,
        spawn_radius=500.0, distribution="galaxy", engine="window",
        skin=2.0, rebuild_interval=48, rebuild_drift_mode="off"), n)
    return base.replace(group_size=gsz, window_groups=wg,
                        list_capacity=6144)


def row_work(far_n, R, gsz, wg, keep, dbg):
    """(pairs, FP32 operations, bytes) of one row: the in-range window
    groups (gsz x gsz pairs each) unless ``nowin``, the live far entries
    (gsz pairs each) when kept.  Bytes: the window bodies (x, y, z, m)
    when summed, the targets (x, y, z) unless ``notgt``, the live far
    entries' R rows, far_n, and the (3, npad) output written once."""
    flags = dbg_flags(dbg)
    ng = far_n.shape[0]
    g = torch.arange(ng, device=far_n.device)
    n_win = int((torch.clamp(g + wg, max=ng - 1)
                 - torch.clamp(g - wg, min=0) + 1).sum())
    live = int(far_n.long().sum()) if keep else 0
    win = 0 if "nowin" in flags else n_win * gsz * gsz
    pairs = win + live * gsz
    npad = ng * gsz
    nbytes = 4 * ((0 if "nowin" in flags else 4 * npad)
                  + (0 if "notgt" in flags else 3 * npad)
                  + R * live + ng + 3 * npad)
    return pairs, OPS_PER_PAIR * pairs, nbytes


def bound_ms(ops, nbytes):
    """(ms, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def note(tag, dbg):
    """What a row's line says of ``nostage``, which the card's kernel has
    no stage for."""
    if tag == "nost":
        return "  (the same program as now on the card)"
    if "nostage" in dbg_flags(dbg):
        return "  (nostage: no effect on the card)"
    return ""


def run(n, gsz, wg, gpp, device="cuda", out=print, pos_vel_mass=None):
    """The rows at one geometry; returns ``{tag: {"ms", "pairs",
    "bound_ms", "bound_by"}}`` and prints the script's lines."""
    device = torch.device(device)
    cfg = ablation_config(n, gsz, wg)
    pos, vel, mass = pos_vel_mass or initial_conditions(
        "galaxy", n, cfg.spawn_radius, cfg.G, device)
    lists = bw.build_lists(pos, vel, mass, torch.zeros_like(pos),
                           **{**bw._build_kw(cfg), "pool_tile": 0})
    s_pos, s_mass = sorted_inputs(lists, pos, mass)
    fz = torch.zeros_like(lists.far_n)
    R = lists.far.shape[1]
    out(f"n={n:,} gsz={gsz} wg={wg} gpp={gpp} "
        f"far_mean={float(lists.far_n.float().mean()):.0f}  "
        f"(groups_per_program is a TPU program width: ignored on the card; "
        f"R={R}, device={device.type})", flush=True)
    kw = bw._eval_kw(cfg)
    res = {}
    for tag, keep, dbg in ROWS:
        far_n = lists.far_n if keep else fz

        def call():
            return window_eval(s_pos, s_mass, lists.far, far_n, None,
                               lists.steps_since, DT, dbg=dbg, **kw)
        ms = time_ms(call, REPS, device)
        pairs, ops, nbytes = row_work(lists.far_n, R, gsz, wg, keep, dbg)
        b_ms, b_by = bound_ms(ops, nbytes)
        res[tag] = dict(ms=ms, pairs=pairs, bound_ms=b_ms, bound_by=b_by)
        share = (f"{b_ms / ms:.1%} of it" if device.type == "cuda"
                 else "host clock: no share")
        out(f"  {tag}: {ms:.3f} ms  {pairs:.4e} pairs  bound {b_ms:.4f} ms "
            f"({b_by}; {share}){note(tag, dbg)}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "decide7")
    n = bodies_of(a)
    print(device_line(dev), flush=True)
    cfg = ablation_config(n, 256, 1)
    ics = initial_conditions("galaxy", n, cfg.spawn_radius, cfg.G, dev)
    for gsz, wg, gpp in GEOMETRIES:
        run(n, gsz, wg, gpp, dev, pos_vel_mass=ics)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
