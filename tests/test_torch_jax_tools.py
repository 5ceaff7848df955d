"""The port's measurement tools against the JAX scripts they port, on the
same inputs: ``tools/nbody_error_scan.py``, ``nbody_error.py``,
``quad_scan.py`` (its frontier branch, n <= 4M), ``staleness_scan.py``
and ``extreme_run.py`` against ``scripts/`` of the same names.  Each
``main`` runs once a module at 2,048 bodies on the CPU (JAX with Pallas
in interpret mode; the port's wrappers take their plain versions), and
each of its records is a case, compared field by field.

Where a port departs from its script (stated in its docstring), the
script is given the port's configuration, so the two sides run one:
``nbody_error``, ``nbody_error_scan`` and ``quad_scan`` build dense lists
(the scripts' ``NBodyConfig`` patched to ``pool_tile=0``);
``staleness_scan`` and ``extreme_run`` calibrate on the initial
conditions (the script's resolve or calibrate step returns the port's
calibrated configuration, after checking that its own input equals the
port's).  The stale script samples sorted slots where the port maps
original ids through ``inv_order``: at 2,048 bodies its 2,048 samples
are every body, so both measure the same set; ``extreme_run``'s 1,024
samples are half the bodies, mapped through ``inv_order`` on both sides.

Tolerance: 1e-4 absolute on every error statistic (the scripts round
them to 5 places, the extreme run's printed lines to 4; a wrong depth,
theta, tau, skin, variant or sample moves them by 1e-3 and more), the
last printed place on the drifts, exact on counts and the list line;
host-clock times are not compared.
"""

import contextlib
import dataclasses
import io
import json
import re
import sys

import pytest
import torch

from scripts import extreme_run as jax_extreme
from scripts import nbody_error as jax_error
from scripts import nbody_error_scan as jax_scan
from scripts import quad_scan as jax_quad
from scripts import staleness_scan as jax_stale
from spatialsim_tpu.config import nbody as jax_nbody
from spatialsim_tpu.ops import bh_window as jax_bw
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools import (
    extreme_run, nbody_error, nbody_error_scan, quad_scan, staleness_scan)
from spatialsim_tpu_torch.tools.oracle import initial_conditions

N = 2048
TOL = 1e-4
TIMES = {"build_ms", "eval_ms"}
COUNTS = {"n", "depth", "budget", "list_cap", "gsz", "far_n_mean",
          "far_n_p99", "groups_at_cap", "wl_visited_M", "residual_frac"}
STALE_ARGS = [str(N), "6.0", "2", "256", "0", "0,8"]
EXTREME_ARGS = [str(N), "1", "1.2"]


@contextlib.contextmanager
def _quiet_cpu():
    """Two torch threads (the suite runs several workers at once) and
    stdout captured; yields the buffer."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield buf
    finally:
        torch.set_num_threads(before)


def _script(module, argv, patches=()):
    """The script's ``main`` on ``argv`` with ``patches`` (object, name,
    value) applied; its stdout."""
    with pytest.MonkeyPatch.context() as mp, _quiet_cpu() as out:
        for obj, name, value in patches:
            mp.setattr(obj, name, value)
        mp.setattr(sys, "argv", ["script"] + list(argv))
        module.main()
    return out.getvalue()


def _port(main, argv):
    with _quiet_cpu() as out:
        assert main(list(argv) + ["--device", "cpu"]) == 0
    return out.getvalue()


def _json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def _dense(module):
    return (module, "NBodyConfig", lambda **kw: dataclasses.replace(
        jax_nbody.NBodyConfig(**kw), pool_tile=0))


def _to_jax(cfg):
    """The port's configuration as the JAX package's (same fields)."""
    return jax_nbody.NBodyConfig(**{f.name: getattr(cfg, f.name)
                                    for f in dataclasses.fields(cfg)})


def _calibrated(cfg, distribution):
    with _quiet_cpu():
        pos, vel, mass = initial_conditions(
            distribution, N, cfg.spawn_radius, cfg.G, torch.device("cpu"))
        return bw.calibrate_config(cfg, pos, vel, mass)


def _by_cfg(recs):
    return {r["cfg"]: r for r in recs}


def _assert_same(got, want):
    assert set(want) <= set(got), (want, got)
    for key, x in want.items():
        if key in TIMES:
            continue
        if isinstance(x, str) or key in COUNTS:
            assert got[key] == x, (key, got, want)
        else:
            assert abs(got[key] - x) <= TOL, (key, got, want)


@pytest.fixture(scope="module")
def scan_runs():
    want = _json_lines(_script(jax_scan, [str(N)], [_dense(jax_scan)]))
    got = _json_lines(_port(nbody_error_scan.main, [str(N)]))
    return want, got


SCAN_CFGS = ["exact_bh_depth9"] + [t for t, _ in nbody_error_scan.VARIANTS]


@pytest.mark.parametrize("cfg", SCAN_CFGS)
def test_nbody_error_scan_matches_the_script(scan_runs, cfg):
    want, got = scan_runs
    assert [r["cfg"] for r in want] == [r["cfg"] for r in got] == SCAN_CFGS
    _assert_same(_by_cfg(got)[cfg], _by_cfg(want)[cfg])


def test_nbody_error_matches_the_script(scan_runs):
    # The scan's ``win_d8`` configuration: JAX reuses its compiled build.
    argv = [str(N), "--depth", "8"]
    (want,) = _json_lines(_script(jax_error, argv, [_dense(jax_error)]))
    (got,) = _json_lines(_port(nbody_error.main, argv))
    _assert_same(got, want)


@pytest.fixture(scope="module")
def quad_runs():
    want = _json_lines(_script(jax_quad, [str(N)], [_dense(jax_quad)]))
    got = _json_lines(_port(quad_scan.main, [str(N)]))
    return want, got


QUAD_CFGS = [t for t, _ in quad_scan.FRONTIER]


@pytest.mark.parametrize("cfg", QUAD_CFGS)
def test_quad_scan_frontier_matches_the_script(quad_runs, cfg):
    want, got = quad_runs
    assert [r["cfg"] for r in want] == [r["cfg"] for r in got] == QUAD_CFGS
    _assert_same(_by_cfg(got)[cfg], _by_cfg(want)[cfg])


def test_quad_scan_quadrupole_beats_monopole(quad_runs):
    by = _by_cfg(quad_runs[1])
    assert by["quad_d7_s1.0"]["median"] < by["mono_d7"]["median"]
    assert all(r["groups_at_cap"] == 0 for r in quad_runs[1])


@pytest.fixture(scope="module")
def stale_runs():
    cfg = staleness_scan.scan_config(N, 6.0, 2, 256, 0)
    resolved, calibrated = _to_jax(cfg), _to_jax(_calibrated(cfg, "galaxy"))
    original = jax_nbody.resolve_config
    hits = []

    def resolve(c, n):
        out = original(c, n)
        if out == resolved:    # the script's own configuration
            hits.append(n)
            return calibrated
        return out
    want = _json_lines(_script(jax_stale, STALE_ARGS,
                               [(jax_nbody, "resolve_config", resolve)]))
    assert hits == [N]         # the port's configuration is the script's
    got = _json_lines(_port(staleness_scan.main,
                            STALE_ARGS + ["--sample", str(N)]))
    return want, got


@pytest.mark.parametrize("i", [0, 1], ids=["tau0", "tau8"])
def test_staleness_scan_matches_the_script(stale_runs, i):
    want, got = stale_runs
    assert [r["tau"] for r in want] == [r["tau"] for r in got] == [0, 8]
    g, w = got[i], want[i]
    assert g["skin"] == w["skin"]
    for kind in ("stale", "fresh"):
        for stat in ("med", "p99", "rms"):
            assert abs(g[kind][stat] - w[kind][stat]) <= TOL, (kind, g, w)
    assert abs(g["drift_max"] - w["drift_max"]) <= 0.01 + 1e-9
    assert abs(g["drift_p95"] - w["drift_p95"]) <= 0.001 + 1e-9


def test_staleness_stale_equals_fresh_at_tau_0(stale_runs):
    # At tau 0 the lists are one step old (the warm-up's last build):
    # their error is the fresh lists' within 5%.
    r = stale_runs[1][0]
    s, f = r["stale"]["rms"], r["fresh"]["rms"]
    assert 0 < f < 0.05 and abs(s - f) <= 0.05 * f


def _line(text, marker):
    (line,) = [x for x in text.splitlines() if marker in x]
    return line


def _numbers(line):
    return [float(x) for x in re.findall(r"=(-?[\d.]+)", line)]


def test_extreme_run_matches_the_script():
    cfg = extreme_run.extreme_run_config(N, 1.2)
    resolved, calibrated = _to_jax(cfg), _to_jax(_calibrated(cfg, "cluster"))
    hits = []

    def calibrate(c, pos, vel, mass):
        assert c == resolved   # the port's configuration is the script's
        hits.append(pos.shape[1])
        return calibrated
    want = _script(jax_extreme, EXTREME_ARGS,
                   [(jax_bw, "calibrate_config", calibrate)])
    assert hits == [N]
    got = _port(extreme_run.main, EXTREME_ARGS)
    # The list line: far_n mean / p99 / max, groups at the cap and folded,
    # pool tiles.
    assert _line(got, "lists: far_n mean=").endswith(
        _line(want, "far_n mean="))
    marker = "force error (fresh lists, 1024 samples)"
    errs, mine = _numbers(_line(want, marker)), _numbers(_line(got, marker))
    assert len(errs) == len(mine) == 3
    assert all(abs(a - b) <= TOL + 1e-9 for a, b in zip(mine, errs))
    assert "state finite OK" in want and "state finite OK" in got
    assert "levels over their cap" in got and "sustained:" in got
