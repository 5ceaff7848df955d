"""The pieces the rebuild and boids decomposition tools share (the ports
of ``scripts/decide12-27.py``, ``gather_bench.py`` and
``boids_capture.py``).

The scripts time a chain of ``k`` dependent calls inside one jitted
``lax.scan`` and report the chained marginal ``(t3 - t1) / 2``: the cost
of one more call with the dispatch and transfer floor taken out.  The
port runs eagerly, so a chain is ``k`` calls in a row, and each marginal
is reported twice: on the host clock (the calls ended by a synchronise,
what a caller waits) and in device time (CUDA events around the same
calls, what the card works).  The port's rebuild is bound by the host,
so the gap between the two is the host's share -- as far as the events
see it: an event interval also spans the stream's idle gaps while the
host prepares the next kernel, so on a host-bound chain the two agree.
:func:`busy_line` gives the device's busy time under ``torch.profiler``
beside the wall.  On the CPU there are no device times: those fields say
"not measured".
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig, resolve_config
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.ops.octree import build_octree
from spatialsim_tpu_torch.tools.oracle import initial_conditions


class Marginal(NamedTuple):
    """A chained marginal and its one-call chain, in ms: host clock, and
    device time (None on the CPU)."""

    host: float
    t1: float
    device: Optional[float]
    d1: Optional[float]

    def line(self) -> str:
        """``X ms (t1 Y); device X ms (t1 Y)``: the scripts' fields, then
        the device time."""
        return f"{self.host:.3f} ms (t1 {self.t1:.3f}); {self.dev_text()}"

    def dev_text(self) -> str:
        if self.device is None:
            return "device not measured"
        return f"device {self.device:.3f} ms (t1 {self.d1:.3f})"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def chain_ms(fn, k: int, device, reps: int = 3):
    """Fastest of ``reps`` runs of ``k`` calls of ``fn`` in a row, after
    one warm-up run: (host ms, device ms or None)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    for _ in range(k):
        fn()
    sync(device)
    host = dev = float("inf")
    for _ in range(reps):
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t = time.perf_counter()
        for _ in range(k):
            fn()
        if cuda:
            e1.record()
        sync(device)
        host = min(host, (time.perf_counter() - t) * 1e3)
        if cuda:
            dev = min(dev, e0.elapsed_time(e1))
    return host, (dev if cuda else None)


def marginal(fn, device, reps: int = 3, k: int = 3) -> Marginal:
    """The chained marginal ``(t_k - t_1) / (k - 1)`` of ``fn``."""
    h1, d1 = chain_ms(fn, 1, device, reps)
    hk, dk = chain_ms(fn, k, device, reps)
    return Marginal((hk - h1) / (k - 1), h1,
                    None if d1 is None else (dk - d1) / (k - 1), d1)


def busy_ms(fn, device):
    """One call of ``fn`` under ``torch.profiler``: (the device's busy ms,
    the union of its kernels' and copies' intervals; the wall ms), or
    None on the CPU.  Unlike a CUDA-event interval, the busy time leaves
    out the stream's idle gaps."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync(device)
        wall = (time.perf_counter() - t) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, wall


def busy_line(calls, device) -> str:
    """``device busy ...`` of each ``(name, fn)``: one call each under the
    profiler (the line starts unindented, apart from the scripts' lines).
    """
    if torch.device(device).type != "cuda":
        return "device busy: not measured"
    parts = []
    for name, fn in calls:
        busy, wall = busy_ms(fn, device)
        parts.append(f"{name} {busy:.3f} of {wall:.3f} ms "
                     f"({1 - busy / wall:.1%} idle)")
    return "device busy (torch.profiler, one call each): " + "; ".join(parts)


def peak_text(device) -> str:
    """The device's peak allocation since the last reset, and a reset."""
    device = torch.device(device)
    if device.type != "cuda":
        return "peak not measured"
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    return f"peak {peak:.3f} GB"


def galaxy_config(n: int) -> NBodyConfig:
    """The rebuild scripts' configuration (decide21-27), resolved."""
    return resolve_config(NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, damping=1.0,
        spawn_radius=500.0, distribution="galaxy", engine="window"), n)


def galaxy_bodies(cfg: NBodyConfig, n: int, device, seed: int = 1):
    """(pos, vel, mass, acc) of the scripts' galaxy (seed 1), acc zero."""
    pos, vel, mass = initial_conditions("galaxy", n, cfg.spawn_radius,
                                        cfg.G, device, seed=seed)
    return pos, vel, mass, torch.zeros_like(pos)


def presort(pos, vel, mass, acc, kw):
    """The scripts' ``presort``: ``bw._sort_state`` of the build."""
    return bw._sort_state(pos, vel, mass, acc, kw["max_depth"],
                          kw["group_size"])


def octree(kw, sorted_state, tree_caps=(), with_acc=True):
    """The build's octree over a presorted state."""
    half, _, _, s_codes, s_pos, s_vel, s_mass, s_acc = sorted_state
    return build_octree(s_codes, s_pos, s_mass, half,
                        max_depth=kw["max_depth"], start_level=2,
                        n=s_pos.shape[1], sorted_vel=s_vel,
                        sorted_acc=s_acc if with_acc else None,
                        level_caps=tuple(tree_caps))


def traversal_inputs(kw, sorted_state, tree_caps=(), with_acc=True):
    """The octree and ``_traverse_global``'s arguments of a ranges build
    (no near groups), as the scripts make them: returns ``(tree, bbox_min,
    bbox_max, ng, tkw, budget)``."""
    s_pos = sorted_state[4]
    gsz = kw["group_size"]
    npad = s_pos.shape[1]
    ng = npad // gsz
    tree = octree(kw, sorted_state, tree_caps, with_acc)
    n_levels = len(tree.levels)
    budget = kw["worklist_budget"] or bw._auto_budget(npad)
    gpos = s_pos.reshape(3, ng, gsz)
    tkw = dict(
        theta=float(kw["theta"]), soft_sq=float(kw["softening"]) ** 2,
        skin=float(kw["skin"]), gsz=gsz,
        intervals=bw._covered_intervals(
            torch.zeros((ng, 0), dtype=torch.int32, device=s_pos.device),
            kw["window_groups"], gsz),
        list_cap=kw["list_cap"], n_levels=n_levels,
        wl_caps=bw._default_wl_caps(ng, n_levels, budget,
                                    c0=tree.levels[0].code.shape[0]),
        with_acc=with_acc, emit_values=False)
    return (tree, gpos.amin(dim=2).T, gpos.amax(dim=2).T, ng, tkw, budget)


def build_kw(kw, **extra) -> dict:
    """The scripts' ``bkw``: ``build_lists``' arguments of a ranges-capable
    pooled build, without the emission mode and caps."""
    keys = ("theta", "softening", "skin", "max_depth", "group_size",
            "window_groups", "list_cap", "pool_tile", "near_groups")
    return dict({k: kw[k] for k in keys}, with_ranges=True, **extra)
