"""The port's bench (``spatialsim_tpu_torch/tools/bench.py``) against the
root ``bench.py``, and the recorder's wall-clock estimate, on the CPU.

Metric names, budgets, the reference anchors and the N-body configs of
the 1m and 10m metrics must equal ``bench.py``'s (the root module is
imported here only; nothing in the port imports it); a small run on the
CPU prints one well-formed line.  ``record --estimate`` exits without a
session, takes the all-pairs branch at 8K and the window branch at 1M from
the H100 anchors, and reads no ``BENCH_r*.json`` (TPU records).
"""

import builtins
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bench as jax_bench
from spatialsim_tpu_torch.config import nbody as nbody_cfg
from spatialsim_tpu_torch.tools import bench
from spatialsim_tpu_torch.tools import record

ROOT = Path(__file__).resolve().parents[1]
JOBS = ("boids", "boids500k", "1m", "10m")


def test_constants_match_bench_py():
    assert bench.METRIC_TIMEOUT_S == jax_bench.METRIC_TIMEOUT_S
    assert bench.JOBS == JOBS
    assert bench.BOIDS_BASELINE_100K == jax_bench.BOIDS_BASELINE_100K
    for n in (10_000, 100_000, 1_000_000, 10_000_000):
        for theta in (0.5, 0.8, 1.5):
            assert (bench.reference_steps_per_sec(n, theta)
                    == jax_bench.reference_steps_per_sec(n, theta))


def _main_calls(module, argv, monkeypatch, capsys):
    """Run ``module.main(argv)`` with its bench functions recording their
    keyword arguments and returning 2.0; returns (kwargs, printed JSON)."""
    seen = {}

    def fake(name):
        def run(**kw):
            seen[name] = kw
            return 2.0
        return run
    monkeypatch.setattr(module, "bench_nbody", fake("nbody"))
    monkeypatch.setattr(module, "bench_boids", fake("boids"))
    capsys.readouterr()
    assert module.main(argv) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(lines) == 1
    return seen, lines[0]


@pytest.mark.parametrize("job", JOBS)
@pytest.mark.parametrize("extra", [[], ["--theta", "0.6", "--bodies",
                                        "20000", "--emit-mode", "compact"]])
def test_jobs_and_lines_match_bench_py(job, extra, monkeypatch, capsys):
    """Each job calls its bench function with bench.py's arguments (plus
    the device) and prints bench.py's line for the same rate."""
    want, want_line = _main_calls(jax_bench, ["--only", job] + extra,
                                  monkeypatch, capsys)
    got, got_line = _main_calls(bench, ["--only", job, "--device", "cpu"]
                                + extra, monkeypatch, capsys)
    assert got_line == want_line
    assert set(got) == set(want)
    for name, kw in got.items():
        assert kw.pop("device") == "cpu"
        assert kw == want[name]


class _Stop(Exception):
    pass


def _jax_bench_config(kw, monkeypatch):
    """The NBodyConfig bench.py's bench_nbody builds for ``kw``."""
    import spatialsim_tpu.config.nbody as jcfg
    import spatialsim_tpu.distributions as jdist
    made = []
    real = jcfg.NBodyConfig

    def spy(**fields):
        made.append(real(**fields))
        return made[-1]

    def stop(*a, **k):
        raise _Stop
    monkeypatch.setattr(jcfg, "NBodyConfig", spy)
    monkeypatch.setattr(jdist, "generate_distribution", stop)
    with pytest.raises(_Stop):
        jax_bench.bench_nbody(**kw)
    return made[-1]


@pytest.mark.parametrize("job", ["1m", "10m"])
def test_nbody_configs_match_bench_py(job, monkeypatch):
    """The port's config for the metric, field for field, and resolved at
    its body count (10M: depth 9, group 1024, list cap 8192, order-2
    advance, the pool on, cell-id emission)."""
    args = bench.parser().parse_args(["--only", job, "--device", "cpu"])
    kw = bench.job_kwargs(job, args)
    kw.pop("device")
    jc = _jax_bench_config(kw, monkeypatch)
    keys = ("n theta distribution engine group_size depth list_cap skin "
            "rebuild_interval drift_mode refresh_interval emit_mode "
            "pool_tile").split()
    tc = bench.nbody_config(**{k: kw[k] for k in keys if k in kw})
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    import spatialsim_tpu.config.nbody as jcfg
    n = kw["n"]
    rt, rj = nbody_cfg.resolve_config(tc, n), jcfg.resolve_config(jc, n)
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    if job == "10m":
        assert (rt.max_depth, rt.group_size, rt.list_capacity,
                rt.advance_order, rt.traversal_emit) == (9, 1024, 8192, 2,
                                                         "auto")
        assert rt.pool_tile > 0 and rt.distribution == "cluster"


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def _check_line(line, metric):
    rec = json.loads(line)
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == metric and rec["unit"] == "steps/s"
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    # Rounded to 2 decimals as bench.py does: 0.0 for a slow CPU run.
    assert math.isfinite(rec["vs_baseline"]) and rec["vs_baseline"] >= 0


def test_small_run_prints_one_line():
    """As a user runs it: the device line, then one JSON line, and the
    kernel launches (none on the CPU) on the standard error."""
    proc = subprocess.run(
        [sys.executable, "-m", "spatialsim_tpu_torch.tools.bench", "--only",
         "1m", "--bodies", "3000", "--steps", "4", "--chain", "2",
         "--device", "cpu"], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.splitlines()
    assert out[0] == "device: cpu" and len(out) == 2, out
    _check_line(out[1], "nbody_steps_per_sec_3k_theta0.8")
    assert '[bench] 1m kernel launches: {"allpairs": 0' in proc.stderr


def test_compact_emission_runs(capsys):
    assert bench.main(["--only", "1m", "--bodies", "3000", "--steps", "4",
                       "--chain", "2", "--emit-mode", "compact",
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    _check_line(lines[-1], "nbody_steps_per_sec_3k_theta0.8")


def test_cuda_without_a_card_exits():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        bench.main(["--only", "boids"])
    assert record.main(["--preset", "tiny_galaxy", "--estimate"]) == 1


def _est(n, frames, theta=0.8, substeps=1):
    return record.estimate_recording_time(dict(
        num_bodies=n, total_frames=frames, theta=theta, substeps=substeps))


def test_estimate_branches():
    """All-pairs at 8K (the pair rate or the step floor), the window
    engine's n log n scaling from the 1M anchor above the threshold."""
    n = 8_000
    assert _est(n, 30) == pytest.approx(30 * max(
        record._EST_STEP_FLOOR_S, n * n / record._EST_ALLPAIRS_PAIRS_PER_S))
    assert _est(32_768, 1) == pytest.approx(max(
        record._EST_STEP_FLOOR_S,
        32_768 ** 2 / record._EST_ALLPAIRS_PAIRS_PER_S))
    assert _est(1_000_000, 10, substeps=3) == pytest.approx(
        30 * record._EST_ANCHOR_STEP_S)
    assert _est(1_000_000, 10, theta=0.4) == pytest.approx(
        40 * record._EST_ANCHOR_STEP_S)
    big = _est(10_000_000, 1)
    assert big == pytest.approx(record._EST_ANCHOR_STEP_S * 10
                                * math.log(1e7) / math.log(1e6))


def test_estimate_cli_exits_without_a_session(tmp_path, monkeypatch,
                                              capsys):
    """``--estimate`` prints the estimate and exits 0; no session, and no
    BENCH_r*.json is read (a decoy in the working directory would change
    the anchor if it were)."""
    rec_root = tmp_path / "rec"
    monkeypatch.setenv("SPATIALSIM_RECORDINGS", str(rec_root))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "BENCH_r99.json").write_text(json.dumps({"tail": json.dumps(
        {"metric": "nbody_steps_per_sec_1000k_theta0.8", "value": 1e-6})}))
    real_open = builtins.open

    def guarded(file, *a, **k):
        assert "BENCH_r" not in str(file), file
        return real_open(file, *a, **k)
    monkeypatch.setattr(builtins, "open", guarded)
    monkeypatch.setattr(Path, "glob", lambda *a, **k: pytest.fail("glob"))
    for argv, n, frames in (
            (["--preset", "tiny_galaxy", "--bodies", "8k"], 8_000, None),
            (["--preset", "bar_galaxy", "--bodies", "1m"], 1_000_000,
             None)):
        capsys.readouterr()
        assert record.main(argv + ["--estimate", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert out.startswith("[Record] Estimated compute: ~"), out
        assert f"{n:,} bodies" in out and record.ESTIMATE_CARD in out
        assert "New session" not in out
    assert not rec_root.exists()
    assert "BENCH_r" not in Path(record.__file__).read_text()


def test_interactive_menu_shows_the_estimate(capsys):
    answers = iter(["0", "", "", "", "y"])
    cfg = record.select_preset_interactive(input_fn=lambda _: next(answers))
    out = capsys.readouterr().out
    est = record.format_time(record.estimate_recording_time(cfg))
    assert f"Estimated time: ~{est} ({record.ESTIMATE_CARD})" in out
