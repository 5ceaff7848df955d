"""The sharded rebuild's sample sort against the replicated fallback (port
of ``scripts/distsort_bench.py``).

    python -m spatialsim_tpu_torch.tools.distsort_bench [n] [--device cuda]
    python -m spatialsim_tpu_torch.tools.distsort_bench 4096 --device cpu

The galaxy (seed 0, spawn radius 300) at ``n`` bodies (default 131,072)
at the script's configuration (depth 7, group 256, window 2, list cap
2,048, skin 2, a rebuild every substep, drift off) through the sharded
window step (``parallel/sharded.make_sharded_window_step``, two substeps
a call): one call to warm up, then 3 calls (6 substeps, 6 rebuilds)
timed on the host clock, the slowest rank's ms a substep.  Two variants,
as the script's: "distributed", the sample sort's bins at ``cap_factor``
2.0 (the step's default), and "replicated", at 1e-9, which overflows
every bin, so that every rebuild sorts the gathered state on every rank.
Beside each, the step's ``fallbacks`` (rebuilds that fell back to the
replicated sort, equal on every rank) of its ``rebuilds``, in all and in
the timed calls: whether the "distributed" variant ran distributed.

On a card the ranks are the card: world size 1 (NCCL).  ``--device cpu``
runs ``RANKS`` gloo ranks (8, the script's D), one process and one thread
each (``parallel/launch.spawn``); ``n`` must divide into two groups or
more a rank.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from spatialsim_tpu_torch import distributions
from spatialsim_tpu_torch.config.nbody import NBodyConfig
from spatialsim_tpu_torch.parallel import launch
from spatialsim_tpu_torch.parallel.mesh import make_mesh
from spatialsim_tpu_torch.parallel.sharded import make_sharded_window_step
from spatialsim_tpu_torch.tools.chain import sync
from spatialsim_tpu_torch.tools.eval_ab import device_line
from spatialsim_tpu_torch.tools.oracle import add_bodies, bodies_of, device_of

DT = 0.01
CALLS = 3
# The script's variants: (tag, the sample sort's bin capacity factor).
VARIANTS = (("distributed", 2.0), ("replicated", 1e-9))
RANK_TIMEOUT = 900.0
RANKS = 8               # the script's D: the gloo ranks on the CPU


def bench_config(n: int) -> NBodyConfig:
    """The script's configuration."""
    return NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, damping=1.0,
        spawn_radius=300.0, distribution="galaxy", engine="window",
        max_depth=7, group_size=256, window_groups=2, list_capacity=2048,
        skin=2.0, rebuild_interval=1, rebuild_drift_mode="off")


def galaxy(cfg: NBodyConfig):
    """The script's bodies, ``(3, n)`` / ``(n,)`` float32 CPU tensors."""
    p, v, m = distributions.generate_distribution(
        "galaxy", cfg.num_bodies, cfg.spawn_radius, cfg.G, seed=0)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 for a in (p.T, v.T, m))


def bench_job(mesh, cfg, pos, vel, mass, cap_factor, calls=CALLS):
    """One variant on this rank: ``{"ms": ms a substep, "rebuilds",
    "fallbacks", "timed_rebuilds", "timed_fallbacks"}``."""
    n = pos.shape[1]
    dev = mesh.device
    step, init = make_sharded_window_step(cfg, n, mesh, substeps=2,
                                          cap_factor=cap_factor)
    st = init(pos.to(dev), vel.to(dev), mass.to(dev))
    st = step(st, DT)                    # the first pair
    sync(dev)
    r0, f0 = step.rebuilds, step.fallbacks
    t0 = time.perf_counter()
    for _ in range(calls):
        st = step(st, DT)
    sync(dev)
    ms = (time.perf_counter() - t0) / (2 * calls) * 1e3
    return dict(ms=ms, rebuilds=step.rebuilds, fallbacks=step.fallbacks,
                timed_rebuilds=step.rebuilds - r0,
                timed_fallbacks=step.fallbacks - f0)


def _variants(mesh, cfg, pos, vel, mass, variants):
    return [bench_job(mesh, cfg, pos, vel, mass, cap)
            for _, cap in variants]


def run(n=131_072, device="cuda", out=print):
    """Both variants; returns ``{tag: {"ms" (the slowest rank's),
    "rebuilds", "fallbacks", "timed_rebuilds", "timed_fallbacks",
    "ranks"}}``."""
    device = torch.device(device)
    D = 1 if device.type == "cuda" else RANKS
    cfg = bench_config(n)
    pos, vel, mass = galaxy(cfg)
    out(f"platform={device.type} n={n:,} ranks={D} "
        f"({'nccl' if device.type == 'cuda' else 'gloo'})", flush=True)
    if D == 1:
        fresh = not torch.distributed.is_initialized()
        try:
            per_rank = [_variants(make_mesh(1, device=device), cfg, pos,
                                  vel, mass, VARIANTS)]
        finally:
            if fresh and torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            per_rank = launch.spawn(_variants, D,
                                    (cfg, pos, vel, mass, VARIANTS),
                                    workdir=tmp, timeout=RANK_TIMEOUT)
    res = {}
    for i, (tag, cap) in enumerate(VARIANTS):
        rows = [r[i] for r in per_rank]
        counts = {k: rows[0][k] for k in ("rebuilds", "fallbacks",
                                          "timed_rebuilds",
                                          "timed_fallbacks")}
        if any({k: r[k] for k in counts} != counts for r in rows):
            raise RuntimeError(f"{tag}: the ranks' counts differ: {rows}")
        res[tag] = dict(counts, ms=max(r["ms"] for r in rows), ranks=D,
                        cap_factor=cap)
        out(f"  {tag} rebuild-every-substep: {res[tag]['ms']:.0f} "
            f"ms/substep ({res[tag]['ms']:.3f}; cap_factor {cap:g}; "
            f"fallbacks {counts['fallbacks']} of {counts['rebuilds']} "
            f"rebuilds, timed {counts['timed_fallbacks']} of "
            f"{counts['timed_rebuilds']})", flush=True)
    where = f"{D}-rank {device.type} mesh"
    if res["distributed"]["ms"] < res["replicated"]["ms"]:
        ratio = res["replicated"]["ms"] / res["distributed"]["ms"]
        out(f"distributed sample-sort rebuild beats replicated by "
            f"{ratio:.2f}x on the {where}", flush=True)
    else:
        out(f"WARNING: distributed path not faster on this {where}",
            flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bodies(ap, 131_072)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = device_of(a.device, "distsort_bench")
    print(device_line(dev), flush=True)
    run(bodies_of(a), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
