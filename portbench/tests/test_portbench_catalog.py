"""The harness finds cells, configurations, traffic, limits and metrics by
name: files added in a copy are found, and no file there changes."""

import hashlib
import json
import shutil
from pathlib import Path

from portbench.catalog import ROOT, Catalog


def _digests(root: Path) -> dict:
    out = {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
           for p in (root / "portbench").rglob("*")
           if p.is_file() and "__pycache__" not in p.parts}
    return out


def test_every_named_file_is_found():
    cat = Catalog()
    for w in cat.bench["workloads"]:
        cfg = cat.config(w["config"])
        assert cfg["num_bodies"] > 0 and cat.traffic(w["traffic"])
        assert cat.limits(w["name"])["limits"]
        for kind in ("end_to_end", "per_layer"):
            for m in cat.metrics(kind, w["name"]):
                assert callable(cat.reader(m["name"]))


def test_added_files_are_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)
    d = root / "portbench"
    (d / "configs" / "tiny.json").write_text(json.dumps(
        dict(json.loads((d / "configs" / "million_stars.json").read_text()),
             num_bodies=4096)))
    (d / "traffic" / "burst.json").write_text('{"max_speed_color": 9.0}')
    (d / "limits" / "tiny.burst.json").write_text(
        '{"sample_bodies": 64, "limits": {"colour_gap": 1e-4}}')
    (d / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "s",
                             "file": "portbench/configs/tiny.json",
                             "reduced": ["num_bodies"], "why": "w"})
    bench["workloads"].append({"name": "tiny.burst", "config": "tiny",
                               "traffic": "burst", "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "entry", "moves": "setup_s",
                               "workloads": ["tiny.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cat = Catalog(root=root, bench_dir=d)
    assert cat.config("tiny")["num_bodies"] == 4096
    assert cat.traffic("burst")["max_speed_color"] == 9.0
    assert cat.limits("tiny.burst")["sample_bodies"] == 64
    names = [m["name"] for m in cat.metrics("per_layer", "tiny.burst")]
    assert names == ["new_metric"]
    assert cat.reader("new_metric")(None) == 42.0
    assert "new_metric" not in [m["name"] for m in cat.metrics(
        "per_layer", "million_stars.record")]
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
