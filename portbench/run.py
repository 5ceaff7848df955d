"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload million_stars.record --seed 7 \\
        --seconds 30 --trace 0

A run builds the cell's initial conditions (one disk for every run;
``--seed`` draws the bodies the reference judges), hands them to
``spatialsim_tpu_torch``'s ``NBodySimulation.from_state`` (the recorder's
resume path) with the preset's configuration, and records frames as the
recorder does (:mod:`portbench.frames`).  Set-up is everything up to the
first timed frame: the kernels' build (a checkout's first run), the
initial conditions, the simulation's calibration and first build, and
the warm-up, which runs two whole list cycles and the rebuild that ends
the second.  The window then records whole list cycles until
``--seconds`` have passed.  With ``--trace 1`` the profiler then records
at least :data:`TRACE_MIN_CYCLES` further cycles and
:data:`TRACE_MIN_S` seconds.  After them, untimed, the run steps on to
the stalest frame of a cycle.  Three frames are judged by the plain
reference (:mod:`portbench.reference`), once the program is freed, on
4,096 bodies drawn from ``--seed``: the first (from the benchmark's own
initial conditions), the stalest frame of the warm-up's second cycle,
and the stalest frame after the window (its closure and colours).
``accel_err_rms_pct`` is the warm-up's stalest frame judged on a fixed
draw of bodies: the same simulated time and bodies in every run.

The last line of standard output is the result; the numbers that decide
``correct`` are printed beside their limits as the last lines of
standard error and under ``checks``, the result's last key.  Without a
card, or with fewer than the cell asks for, the run prints no result and
exits 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "spatialsim_tpu")
TRACE_MIN_S = 1.5
TRACE_MIN_CYCLES = 2
PRESET_FIELDS = ("num_bodies", "theta", "G", "softening", "damping",
                 "spawn_radius", "distribution")


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    setup_s: float = 0.0
    window_s: float = 0.0
    frame_ms: list = field(default_factory=list)
    capture_ms: list = field(default_factory=list)
    rebuilt: list = field(default_factory=list)
    peak_bytes: int = 0
    setup_seconds: dict = field(default_factory=dict)
    build_s: Optional[float] = None
    readings: dict = field(default_factory=dict)
    trace: object = None
    eval_bound_s: Optional[float] = None
    eval_steps: int = 0
    frames: dict = field(default_factory=dict)    # the judged frames
    sample: object = None
    masses: object = None


def forbidden_modules(modules) -> list:
    """Top-level names among ``modules`` that the benchmark may not load,
    compared whole (``spatialsim_tpu_torch`` is not ``spatialsim_tpu``)."""
    return sorted({name.split(".")[0] for name in modules}
                  & set(FORBIDDEN))


def nbody_config(cfg: dict):
    """The preset's physics as the recorder maps it (``config_from_preset``);
    the engine fields resolve by body count in the program.  An
    ``engine`` object in ``cfg`` sets further fields (the tests' small
    runs)."""
    from spatialsim_tpu_torch.config.nbody import NBodyConfig
    kw = {k: cfg[k] for k in PRESET_FIELDS}
    kw.update(cfg.get("engine", {}))
    return NBodyConfig(**kw)


def make_sim(cfg: dict, device):
    """(simulation, x0, v0, masses): the initial conditions as handed to
    the program, ``(n, 3)`` / ``(n,)`` float32 on the host."""
    from spatialsim_tpu_torch.models.nbody import NBodySimulation

    from portbench.galaxy import BASE_SEED, galaxy
    if cfg["distribution"] != "galaxy":
        raise ValueError(f"no generator for {cfg['distribution']!r}")
    pos, vel, mass = galaxy(int(cfg["num_bodies"]),
                            float(cfg["spawn_radius"]), float(cfg["G"]),
                            BASE_SEED, device)
    x0, v0, m = (t.float().cpu() for t in (pos, vel, mass))
    del pos, vel, mass
    sim = NBodySimulation.from_state(
        x0.numpy(), v0.numpy(), m.numpy(), config=nbody_config(cfg),
        substeps=int(cfg["substeps"]), device=device)
    return sim, x0, v0, m


def _cycles(loop, min_s: float, min_cycles: int = 1):
    """Whole list cycles from just after a rebuild until ``min_s`` seconds
    and ``min_cycles`` cycles have passed: (start mark, frames, seconds)."""
    from portbench.frames import Mark
    limit = loop.cycle_frames()
    start, t0 = Mark(loop.cuda), time.perf_counter()
    frames, since = [], 0
    while True:
        frames.append(loop.frame())
        since = 0 if frames[-1].rebuilt else since + 1
        if since > limit:
            raise RuntimeError(f"no rebuild in {limit} frames")
        cycles = sum(f.rebuilt for f in frames)
        if (frames[-1].rebuilt and cycles >= min_cycles
                and time.perf_counter() - t0 >= min_s):
            break
    loop.drain()
    return start, frames, time.perf_counter() - t0


def _frame_times(start, frames):
    ms, prev = [], start
    for f in frames:
        ms.append(f.end.ms_since(prev))
        prev = f.end
    return ms


def _cycle_tenths(run):
    """Mean milliseconds of a list cycle in each tenth of the window's
    cycles: how the frame time moves as the simulation evolves."""
    cycles, acc = [], 0.0
    for ms, rebuilt in zip(run.frame_ms, run.rebuilt):
        acc += ms
        if rebuilt:
            cycles.append(acc)
            acc = 0.0
    k = max(1, len(cycles) // 10)
    return [round(sum(cycles[i:i + k]) / len(cycles[i:i + k]), 3)
            for i in range(0, len(cycles), k)]


def _eval_bound(loop, first_far_n, frames):
    """Seconds of kernel 2's bound over the traced steps, and the steps:
    each step on the lists it evaluated (a rebuild frame's first
    ``substeps - steps_since`` steps on the lists before it)."""
    from portbench.kernel2 import step_bound_s
    cfg = loop.sim.config
    cache = {}

    def bound(far_n):
        key = id(far_n)
        if key not in cache:
            cache[key] = step_bound_s(far_n.numel(), cfg.group_size,
                                      cfg.window_groups,
                                      int(far_n.long().sum()))
        return cache[key]

    total, steps, cur = 0.0, 0, first_far_n
    for f in frames:
        if f.rebuilt:
            new = min(f.steps_since, loop.substeps)
            total += (loop.substeps - new) * bound(cur) + new * bound(
                f.far_n)
            cur = f.far_n
        else:
            total += loop.substeps * bound(cur)
        steps += loop.substeps
    return total, steps


def _traced(loop, run):
    """Profile whole cycles after the window (per-layer figures)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import summarize
    acts = [ProfilerActivity.CPU]
    if loop.cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    first = loop.sim.state.lists.far_n
    loop.keep_far_n = True
    with profile(activities=acts) as prof:
        _, frames, seconds = _cycles(loop, TRACE_MIN_S, TRACE_MIN_CYCLES)
    loop.keep_far_n = False
    run.trace = summarize(prof.events(), seconds)
    run.eval_bound_s, run.eval_steps = _eval_bound(loop, first, frames)


def numbers(readings: dict) -> dict:
    """The numbers that decide ``correct``, from the judged frames: the
    colour and closure gaps of all three, and the median force error of
    the two at fixed simulated times (the first frame, on fresh lists,
    and the warm-up's stalest)."""
    closures = [r["closure_ulp"] for r in readings.values()
                if r["closure_ulp"] is not None]
    return {
        "colour_gap": max(r["colour_gap"] for r in readings.values()),
        "closure_ulp": max(closures) if closures else None,
        "force_start_med_pct":
            100 * max(readings["start"]["force"]["check"]["median"]),
        "force_stale_med_pct":
            100 * max(readings["stale"]["force"]["check"]["median"]),
    }


def decide(nums: dict, limits: dict):
    """(correct, checks): every number with a limit is finite and within
    it; ``checks`` holds each number beside its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = nums.get(name)
        good = (value is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def run_cell(cat, workload: str, seed: int, seconds: float, trace: bool,
             device, cfg: Optional[dict] = None, out=print) -> dict:
    """One run of ``workload``; returns the result's fields, ``checks``
    last.  ``cfg`` replaces the cell's configuration (the tests' small
    runs)."""
    import torch

    from portbench.frames import FrameLoop
    from portbench.reference import judge
    cell = cat.workload(workload)
    cfg = cfg or cat.config(cell["config"])
    traffic = cat.traffic(cell["traffic"])
    lim = cat.limits(workload)
    cuda = device.type == "cuda"
    run = Run()
    if cuda:
        from spatialsim_tpu_torch import _kernels
        _kernels.library()
        run.build_s = _kernels.build_info.get("seconds")
        torch.cuda.reset_peak_memory_stats()

    sim, x0, v0, masses = make_sim(cfg, device)
    run.setup_seconds = dict(sim.setup_seconds)
    loop = FrameLoop(sim, float(cfg["dt_per_frame"]), int(cfg["substeps"]),
                     float(traffic["max_speed_color"]))
    frames = {"start": loop.check_frame(x0, v0)}
    loop.to_rebuild()
    frames["stale"] = loop.to_check_frame()
    loop.to_rebuild()
    loop.drain()
    from portbench.peaks import clocks_line
    clocks_before = clocks_line() if cuda else ""

    run.setup_s = time.perf_counter() - T_START
    start, window, run.window_s = _cycles(loop, seconds)
    run.frame_ms = _frame_times(start, window)
    run.capture_ms = [f.end.ms_since(f.capture_start) for f in window]
    run.rebuilt = [f.rebuilt for f in window]
    run.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    clocks_after = clocks_line() if cuda else ""

    if trace:
        _traced(loop, run)
    frames["end"] = loop.to_check_frame()
    del loop, sim
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    from portbench.galaxy import BASE_SEED, judged_rows
    n, count = x0.shape[0], lim["sample_bodies"]
    sample = judged_rows(n, count, seed)
    run.frames, run.sample, run.masses = frames, sample, masses
    phys = (float(cfg["G"]), float(cfg["softening"]),
            float(traffic["max_speed_color"]))
    # The accuracy metric judges the same bodies in every run; the checks,
    # the seed's; the frame after the window, no forces (not compared).
    fixed = judged_rows(n, count, BASE_SEED)
    wanted = {"start": {"check": sample},
              "stale": {"check": sample, "fixed": fixed}, "end": {}}
    for name, fr in frames.items():
        run.readings[name] = judge(fr, masses, *phys, wanted[name], device)
    nums = numbers(run.readings)
    correct, checks = decide(nums, lim["limits"])
    ref_s = time.perf_counter() - t_ref

    out(f"frames: window {len(window)} in {run.window_s:.6f} s, "
        f"rebuilds in the window {sum(run.rebuilt)}; set-up "
        f"{run.setup_s:.6f} s ({json.dumps(run.setup_seconds)}; kernel "
        f"build {run.build_s} s)")
    out(f"clocks before the window: {clocks_before} | after: "
        f"{clocks_after}")
    out(f"cycle ms by tenth of the window: {_cycle_tenths(run)}")
    out(f"reference: {ref_s:.3f} s for the judged frames")
    for name, r in run.readings.items():
        out(f"judged frame {name}: tau {r['tau']}, colour gap "
            f"{r['colour_gap']:.6e}, closure {r['closure_ulp']} ulp, "
            f"force {json.dumps(r['force'])}")
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cat.metrics(kind, workload):
        value = cat.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(0) if cuda else device.type,
           "count": int(cell["chips"]), "memory_peak_bytes": run.peak_bytes}
    result = {"correct": correct, "attempted": len(window), "failed": 0,
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    result["_run"] = run
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.catalog import Catalog
    cat = Catalog()
    chips = int(cat.workload(args.workload)["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    from portbench.peaks import card_line
    print(f"card: {card_line()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | python {sys.version.split()[0]}",
          flush=True)
    result = run_cell(cat, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda"))
    result.pop("_run")
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
