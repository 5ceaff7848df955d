"""Run a function on several gloo ranks on the CPU, one process a rank.

    results = spawn(dryrun.window_steps, 4, (config, pos, vel, mass),
                    dict(substeps=2), workdir=tmp)

Each rank joins the group through a ``file://`` store in ``workdir`` (no
port, so concurrent jobs cannot collide), calls ``fn(mesh, *args)`` with
the bodies axis of :func:`~spatialsim_tpu_torch.parallel.mesh.make_mesh`
(and ``**kwargs``),
and writes its result there; :func:`spawn` returns the results in rank
order.  ``fn`` must be importable by name (a module-level function), since
the ranks start fresh interpreters.  A rank that raises fails the call
with its traceback; a job that outlasts ``timeout`` (a collective waiting
on a rank that never comes) is killed and raises ``TimeoutError``.
"""

from __future__ import annotations

import datetime
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, fn, world_size, workdir, args, kwargs, timeout):
    from spatialsim_tpu_torch.parallel.mesh import make_mesh
    # One thread a rank: the ranks share the host's cores.
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(make_mesh(world_size, device="cpu"), *args, **kwargs)
        torch.save(out, Path(workdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size, args=(), kwargs=None, *, workdir, timeout=120.0):
    """``fn(mesh, *args, **kwargs)`` on ``world_size`` gloo ranks, one CPU
    thread each; returns their results in rank order."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    for f in workdir.glob("rank*.pt"):
        f.unlink()
    (workdir / "rendezvous").unlink(missing_ok=True)
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, str(workdir), tuple(args),
                          dict(kwargs or {}), float(timeout)),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, min(5.0,
                                            deadline - time.monotonic()))):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{getattr(fn, '__name__', fn)} on "
                               f"{world_size} ranks: not done in "
                               f"{timeout} s")
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(world_size)]


def sequence(mesh, *calls):
    """Run ``calls`` -- ``(fn, args, kwargs)`` triples, each ``fn(mesh,
    *args, **kwargs)`` -- one after the other on the same group; returns
    their results.  ``spawn(sequence, D, calls)`` pays one start of the
    ranks for several jobs."""
    return [fn(mesh, *args, **kwargs) for fn, args, kwargs in calls]
