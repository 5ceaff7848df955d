"""What the harness finds by name.

``BENCHMARK.json`` at the checkout's root lists the cells, configurations
and metrics.  The rest is found by the names it gives, one file each, so
a new cell, configuration, traffic mix or metric is added by adding
files and entries, never by editing a file:

* a configuration: the ``file`` its entry names (``portbench/configs/``);
* a traffic mix: ``portbench/traffic/<traffic>.json``;
* a cell's correctness limits: ``portbench/limits/<workload>.json``;
* a metric: ``portbench/metrics/<name>.py``, whose ``read(run)`` returns
  the value or None where the run has nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Catalog:
    def __init__(self, root: Path = ROOT, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self._metrics = {}

    def _named(self, key, name):
        for entry in self.bench[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._named("configs", name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json")
                          .read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.dir / "limits" / f"{workload}.json")
                          .read_text())

    def metrics(self, kind: str, workload: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries a cell reports."""
        return [m for m in self.bench[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, name: str):
        """``read(run)`` of ``metrics/<name>.py``."""
        if name not in self._metrics:
            path = self.dir / "metrics" / f"{name}.py"
            spec = importlib.util.spec_from_file_location(
                f"portbench_metric_{len(self._metrics)}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._metrics[name] = mod.read
        return self._metrics[name]
