"""The port's ``tools/staleness_scan.py`` against
``scripts/staleness_scan.py`` on the same inputs: each ``main`` runs once
a module at 2,048 bodies on the CPU, and each tau's record is a case.

The port calibrates on the initial conditions (stated in its docstring):
the script's resolve step returns the port's calibrated configuration,
after checking that its own input equals the port's.  The script samples
sorted slots where the port maps original ids through ``inv_order``: at
2,048 bodies its 2,048 samples are every body, so both measure the same
set.  Drifts are compared to their last printed place.

Each file holds one ``main``'s records (its module-scoped run), so that
the suite's workers take them apart; ``tests/_jax_tools.py`` holds what
they share, with the tolerance.
"""

import pytest

from scripts import staleness_scan as jax_stale
from spatialsim_tpu.config import nbody as jax_nbody
from spatialsim_tpu_torch.tools import staleness_scan

from _jax_tools import (N, STALE_ARGS, TOL, _calibrated, _json_lines, _port,
                        _script, _to_jax)


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
