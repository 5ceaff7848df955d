"""One sharded step of each engine over the bodies axis: the ring
all-pairs, sharded Barnes-Hut, the sharded window engine and the sharded
boids step (the counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m spatialsim_tpu_torch.parallel.dryrun            # one card
    torchrun --nproc-per-node=4 -m spatialsim_tpu_torch.parallel.dryrun
    python -m spatialsim_tpu_torch.parallel.dryrun --device cpu   # gloo

``--check BODIES`` then holds the sharded sample sort, ring, window engine
and boids step to the unsharded ones at BODIES bodies a rank
(:func:`check`).

The functions below take the bodies axis first and the WHOLE inputs in
original order, run the sharded code on this rank's part and return this
rank's results: the dry run, the tests' gloo ranks
(:func:`~spatialsim_tpu_torch.parallel.launch.spawn`) and ``chip_smoke.py``
drive the engines through them.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from spatialsim_tpu_torch import distributions
from spatialsim_tpu_torch.config.boids import BoidsConfig
from spatialsim_tpu_torch.config.nbody import NBodyConfig
from spatialsim_tpu_torch.models.nbody import NBodyState
from spatialsim_tpu_torch.parallel import distsort
from spatialsim_tpu_torch.parallel.mesh import make_mesh
from spatialsim_tpu_torch.parallel.sharded import (
    _local, make_sharded_boids_step, make_sharded_step,
    make_sharded_window_step, ring_allpairs_accel, shard_state)


def galaxy(n, seed):
    """``(pos, vel, mass)`` of the galaxy distribution (spawn radius 200,
    G 0.1, as ``tests/test_sharded.py`` makes it), ``(3, n)`` / ``(n,)``
    float32 CPU tensors in original order."""
    p, v, m = distributions.generate_distribution("galaxy", n, 200.0, 0.1,
                                                  seed=seed)
    return (torch.from_numpy(np.ascontiguousarray(p.T, np.float32)),
            torch.from_numpy(np.ascontiguousarray(v.T, np.float32)),
            torch.from_numpy(m.astype(np.float32)))


def sample_sort(mesh, codes, rows_f, rows_i, cap_factor=2.0):
    """:func:`~spatialsim_tpu_torch.parallel.distsort.sample_sort_local` on
    this rank's block of the whole ``codes``/``rows_f``/``rows_i``; returns
    its ``(codes, rows_f, rows_i, ok)`` on the CPU."""
    c, f, i, ok = distsort.sample_sort_local(
        _local(codes, mesh), _local(rows_f, mesh), _local(rows_i, mesh), mesh,
        cap_factor=cap_factor)
    return c.cpu(), f.cpu(), i.cpu(), ok


def ring_accel(mesh, pos, mass, G, softening):
    """The ring's accelerations of this rank's block of bodies (CPU)."""
    return ring_allpairs_accel(_local(pos, mesh), _local(mass, mesh), mesh,
                               G, softening).cpu()


def sharded_steps(mesh, config, pos, vel, mass, *, engine, substeps=1,
                  calls=1, dt=0.02):
    """``calls`` calls of :func:`make_sharded_step`'s step from the whole
    original-order state; returns this rank's ``NBodyState`` (CPU)."""
    n = pos.shape[1]
    step = make_sharded_step(config, n, mesh, substeps=substeps,
                             engine=engine)
    st = shard_state(NBodyState(pos, vel, mass), mesh)
    for _ in range(calls):
        st = step(st, dt)
    return NBodyState(*(a.cpu() for a in st))


def window_steps(mesh, config, pos, vel, mass, *, substeps=1, calls=1,
                 dt=0.02, cap_factor=2.0):
    """``calls`` calls of :func:`make_sharded_window_step`'s step from the
    whole original-order state.  Returns a dict: this rank's sorted-layout
    ``pos``/``vel`` shard, the whole ``inv_order`` (original id -> sorted
    slot) and the step's ``rebuilds``, ``fallbacks`` and ``refreshes``;
    tensors on the CPU."""
    n = pos.shape[1]
    step, init = make_sharded_window_step(config, n, mesh, substeps=substeps,
                                          cap_factor=cap_factor)
    st = init(pos, vel, mass)
    for _ in range(calls):
        st = step(st, dt)
    return dict(pos=st.pos.cpu(), vel=st.vel.cpu(),
                inv_order=st.lists.inv_order.cpu(), rebuilds=step.rebuilds,
                fallbacks=step.fallbacks, refreshes=step.refreshes)


def flock_state(config, seed=0):
    """``(pos, vel, col)`` of ``Flock(config=config, seed=seed)`` on the
    CPU, ``(3, n)`` float32 in original boid order."""
    from spatialsim_tpu_torch.models.boids import Flock
    flock = Flock(config=config, seed=seed, device="cpu")
    inv = flock.state.inv1
    return tuple(a[:, inv].contiguous() for a in (
        flock.state.pos, flock.state.vel, flock.state.col))


def boids_steps(mesh, config, pos, vel, col, *, substeps=1, calls=1,
                dt=1.0 / 30.0):
    """``calls`` calls of :func:`make_sharded_boids_step`'s step from the
    whole original-order state.  Returns a dict: this rank's sorted-layout
    ``pos``/``vel``/``col`` shard, the whole ``inv1`` (original id ->
    sorted slot) and the step's ``resorts``; tensors on the CPU."""
    n = pos.shape[1]
    step, init = make_sharded_boids_step(config, n, mesh, substeps=substeps)
    st = init(pos, vel, col)
    for _ in range(calls):
        st = step(st, dt)
    return dict(pos=st.pos.cpu(), vel=st.vel.cpu(), col=st.col.cpu(),
                inv1=st.inv1.cpu(), resorts=step.resorts)


def boids_config(n, **kw):
    """``tests/test_sharded.py``'s boids configuration at ``n`` boids:
    window mode, group 64, window groups 2 then 1, a re-sort every 3."""
    base = dict(num_boids=n, neighbor_mode="window", group_size=64,
                window_groups=2, pass2_window_groups=1, resort_interval=3)
    return BoidsConfig(**dict(base, **kw))


def _require(cond, what):
    if not cond:
        raise RuntimeError(f"dryrun check failed: {what}")


def run(mesh, bodies_per_rank=128):
    """The dry run: one sharded step (2 substeps) of the ring, Barnes-Hut,
    the window engine and the boids step at ``bodies_per_rank * size``
    bodies; returns a line saying what ran."""
    n = bodies_per_rank * mesh.size
    cfg = NBodyConfig(num_bodies=n, theta=0.8, G=0.1, softening=2.0,
                      max_depth=6, group_size=64, frontier_capacity=512,
                      near_capacity=1024, leaf_size=8)
    pos, vel, mass = galaxy(n, 0)
    for engine in ("barnes_hut", "allpairs"):
        out = sharded_steps(mesh, cfg, pos, vel, mass, engine=engine,
                            substeps=2)
        _require(out.pos.shape == (3, n // mesh.size)
                 and bool(torch.isfinite(out.pos).all()), engine)
    wcfg = cfg.replace(list_capacity=512, window_groups=1,
                       rebuild_interval=2, rebuild_drift_mode="off")
    out = window_steps(mesh, wcfg, pos, vel, mass, substeps=2)
    _require(out["pos"].shape == (3, n // mesh.size)
             and bool(torch.isfinite(out["pos"]).all()), "window")
    bcfg = boids_config(n, resort_interval=2)
    out = boids_steps(mesh, bcfg, *flock_state(bcfg), substeps=2)
    _require(out["pos"].shape == (3, n // mesh.size)
             and bool(torch.isfinite(out["pos"]).all()), "boids")
    return (f"dryrun({mesh.size} ranks, {mesh.device}) OK: ring all-pairs "
            f"+ sharded Barnes-Hut + sharded window engine + sharded boids, "
            f"{n} bodies")


def check(mesh, bodies_per_rank):
    """The sharded results gathered and held, on every rank, to the
    unsharded ones at ``bodies_per_rank * size`` galaxy bodies: the sample
    sort of random codes equal to one stable sort; the ring within 2e-4 of
    the all-pairs engine; the window engine (3 calls of 2 substeps, a
    rebuild at substep 4) within 2e-4 of the unsharded dense step; the
    boids step (3 calls of 2 substeps, a re-sort at substep 4) within 2e-4
    of the unsharded window step.  Returns the lines to print."""
    from spatialsim_tpu_torch.ops import bh_window as bw
    from spatialsim_tpu_torch.ops.allpairs import allpairs_accel
    from spatialsim_tpu_torch.parallel.collectives import all_gather
    n = bodies_per_rank * mesh.size
    dev = mesh.device
    lines = []
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 1 << 30, n).astype(np.int32))
    ids = torch.arange(n, dtype=torch.int32)[None, :]
    c, _, i, ok = distsort.sample_sort_local(
        _local(codes, mesh), _local(codes[None].float(), mesh),
        _local(ids, mesh), mesh)
    c, i = all_gather(c, mesh).cpu(), all_gather(i, mesh, axis=1).cpu()
    o = torch.argsort(codes, stable=True).to(torch.int32)
    _require(ok and torch.equal(c, codes[o]) and torch.equal(i[0], o),
             "sample sort")
    lines.append(f"sample sort of {n:,} codes on {mesh.size} ranks: equal "
                 f"to one stable sort")
    pos, vel, mass = galaxy(n, 0)
    G, eps = 0.1, 2.0
    ring = all_gather(ring_allpairs_accel(_local(pos, mesh),
                                          _local(mass, mesh), mesh, G, eps),
                      mesh, axis=1)
    ref = allpairs_accel(pos.to(dev), mass.to(dev), G, eps)
    _require(torch.allclose(ring, ref, rtol=2e-4, atol=2e-5), "ring")
    lines.append(f"ring at {n:,}: max|da| "
                 f"{float((ring - ref).abs().max()):.3e} against the "
                 f"all-pairs engine")
    # Worklist caps that hold the whole traversal: a rank traverses a D-th
    # of the pairs under the same caps, so where the whole build's caps
    # overflow (it emits cells coarsely instead of opening them) the two
    # builds differ, as in the JAX package.
    cfg = NBodyConfig(num_bodies=n, theta=0.8, G=G, softening=eps,
                      max_depth=8, group_size=64, list_capacity=512,
                      window_groups=2, skin=4.0, rebuild_interval=3,
                      rebuild_drift_mode="off", pool_tile=0,
                      worklist_budget=max(4_000_000, 64 * n))
    for substeps, calls in ((1, 1), (2, 3)):
        out = window_steps(mesh, cfg, pos, vel, mass, substeps=substeps,
                           calls=calls)
        got = all_gather(out["pos"].to(dev), mesh, axis=1)[
            :, out["inv_order"].to(dev).long()]
        ustep = bw.make_window_step(cfg, n, substeps=substeps)
        ust = bw.init_window_state(pos.to(dev), vel.to(dev), mass.to(dev),
                                   cfg)
        for _ in range(calls):
            ust = ustep(ust, 0.02)
        want = ust.pos[:, ust.lists.inv_order.long()]
        d = (got - want).abs()
        off = int((d > 2e-4 + 2e-4 * want.abs()).any(0).sum())
        line = (f"window engine at {n:,}, {calls * substeps} substeps: "
                f"rebuilds {out['rebuilds']} (unsharded {ustep.rebuilds}), "
                f"replicated fallbacks {out['fallbacks']}; max|dpos| "
                f"{float(d.max()):.3e} against the unsharded dense step, "
                f"{off} bodies past rtol/atol 2e-4")
        _require(off == 0, line)
        lines.append(line)
    lines.append(check_boids(mesh, n))
    return lines


def check_boids(mesh, n):
    """The sharded boids step against the unsharded frozen-order window
    step at ``n`` boids (:func:`boids_config`), 3 calls of 2 substeps
    across a re-sort, on every rank; returns the line to print."""
    from spatialsim_tpu_torch.models.boids import (
        init_boids_window_state, make_step_fn)
    from spatialsim_tpu_torch.parallel.collectives import all_gather
    dev = mesh.device
    cfg = boids_config(n)
    pos, vel, col = flock_state(cfg)
    out = boids_steps(mesh, cfg, pos, vel, col, substeps=2, calls=3)
    ustep = make_step_fn(cfg, substeps=2)
    ust = init_boids_window_state(pos.to(dev), vel.to(dev), col.to(dev), cfg)
    for _ in range(3):
        ust = ustep(ust, 1.0 / 30.0)
    worst, off = 0.0, 0
    for f in ("pos", "vel", "col"):
        got = all_gather(out[f].to(dev), mesh, axis=1)[
            :, out["inv1"].to(dev)]
        want = getattr(ust, f)[:, ust.inv1]
        d = (got - want).abs()
        worst = max(worst, float(d.max()))
        off += int((d > 2e-4 + 2e-4 * want.abs()).any(0).sum())
    line = (f"boids step at {n:,}, 6 substeps: re-sorts {out['resorts']} "
            f"(unsharded {ustep.resorts}); max|d| {worst:.3e} against the "
            f"unsharded window step, {off} boids past rtol/atol 2e-4")
    _require(off == 0 and out["resorts"] == ustep.resorts, line)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: NCCL, one card a rank; cpu: gloo")
    ap.add_argument("--bodies-per-rank", type=int, default=128)
    ap.add_argument("--check", type=int, default=0, metavar="BODIES",
                    help="then hold the sharded sort, ring, window engine "
                         "and boids step to the unsharded ones at BODIES a "
                         "rank")
    args = ap.parse_args(argv)
    mesh = make_mesh(device=args.device)
    lines = [run(mesh, args.bodies_per_rank)]
    if args.check:
        lines += check(mesh, args.check)
    if mesh.rank == 0:
        print("\n".join(lines), flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
