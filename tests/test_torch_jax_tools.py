"""The port's error-scan tools against the JAX scripts they port, on the
same inputs: ``tools/nbody_error_scan.py`` and ``nbody_error.py``
against ``scripts/`` of the same names.  ``nbody_error_scan``'s ``main``
runs once a module at 2,048 bodies on the CPU, and each of its records is
a case, compared field by field; ``nbody_error``'s one configuration is
the scan's ``win_d8``.

Both ports build dense lists (stated in their docstrings), so the
scripts' ``NBodyConfig`` is patched to ``pool_tile=0`` and the two sides
run one configuration.

Each file holds one ``main``'s records (its module-scoped run), so that
the suite's workers take them apart; ``tests/_jax_tools.py`` holds what
they share, with the tolerance.
"""

import pytest

from scripts import nbody_error as jax_error
from scripts import nbody_error_scan as jax_scan
from spatialsim_tpu_torch.tools import nbody_error, nbody_error_scan

from _jax_tools import (N, _assert_same, _by_cfg, _dense, _json_lines,
                        _port, _script)


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
