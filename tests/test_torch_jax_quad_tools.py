"""The port's ``tools/quad_scan.py`` (its frontier branch, n <= 4M)
against ``scripts/quad_scan.py`` on the same inputs: each ``main`` runs
once a module at 2,048 bodies on the CPU, and each of its records is a
case, compared field by field.  The port builds dense lists (stated in its
docstring), so the script's ``NBodyConfig`` is patched to
``pool_tile=0``.

Each file holds one ``main``'s records (its module-scoped run), so that
the suite's workers take them apart; ``tests/_jax_tools.py`` holds what
they share, with the tolerance.
"""

import pytest

from scripts import quad_scan as jax_quad
from spatialsim_tpu_torch.tools import quad_scan

from _jax_tools import (N, _assert_same, _by_cfg, _dense, _json_lines,
                        _port, _script)


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
