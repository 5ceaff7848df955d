"""The readings that the correctness limits are set from.  Not part of a
benchmark run.

    python3 -m portbench.control --workload extreme_10m_galaxy.record \\
        --seeds 11,12,13,14,15,16,17,18,19,20,21,22 --controls 3

In one process, for each seed, a whole run of the cell (the window at
``run_seconds`` unless ``--seconds``) and the numbers that decide
``correct``.  For the first ``--controls`` seeds also

* ``bfloat16``: the reference put in the program's place in bfloat16 on
  the same three frames (:func:`portbench.reference.control_frame`),
* ``guarantee``: the program with the configuration's opening angle
  doubled: a cell is taken whole at twice the size over distance that
  the configuration allows,

each judged as the program is.  One JSON line each, then a summary: per
number the largest of the program's readings and the smallest of each
control's.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench.catalog import Catalog
from portbench.reference import control_frame, judge
from portbench.run import numbers, run_cell


def _quiet(*_a, **_k):
    pass


def bf16_numbers(run, cfg, max_speed, device) -> dict:
    readings = {}
    for name, frame in run.frames.items():
        ctl = control_frame(frame, run.masses, float(cfg["G"]),
                            float(cfg["softening"]), max_speed, run.sample,
                            device)
        readings[name] = judge(ctl, run.masses, float(cfg["G"]),
                               float(cfg["softening"]), max_speed,
                               {"check": run.sample}, device)
    return numbers(readings), readings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cat = Catalog()
    cell = cat.workload(args.workload)
    cfg = cat.config(cell["config"])
    max_speed = float(cat.traffic(cell["traffic"])["max_speed_color"])
    seconds = (args.seconds if args.seconds is not None
               else float(cat.bench["run_seconds"]))
    broken = dict(cfg, theta=2 * float(cfg["theta"]))
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []

    def emit(seed, variant, nums, readings):
        row = {"seed": seed, "variant": variant, "numbers": nums,
               "readings": readings}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for i, seed in enumerate(seeds):
        run = run_cell(cat, args.workload, seed, seconds, False, dev,
                       out=_quiet)["_run"]
        emit(seed, "program", numbers(run.readings), run.readings)
        if i < args.controls:
            emit(seed, "bfloat16", *bf16_numbers(run, cfg, max_speed, dev))
            del run
            run = run_cell(cat, args.workload, seed, seconds, False, dev,
                           cfg=broken, out=_quiet)["_run"]
            emit(seed, "guarantee", numbers(run.readings), run.readings)
        del run
    summary = {}
    for variant in ("program", "bfloat16", "guarantee"):
        got = [r["numbers"] for r in rows if r["variant"] == variant]
        if not got:
            continue
        pick = max if variant == "program" else min
        summary[variant] = {k: pick(g[k] for g in got if g[k] is not None)
                            for k in got[0] if got[0][k] is not None}
    print(json.dumps({"summary": summary, "theta": broken["theta"],
                      "seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
