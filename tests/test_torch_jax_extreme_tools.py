"""The port's ``tools/extreme_run.py`` against ``scripts/extreme_run.py``
on the same inputs, at 2,048 bodies on the CPU: the list line exactly
and the 1,024-sample error line within the tolerance.  The port
calibrates on the initial conditions (stated in its docstring): the
script's calibrate step returns the port's calibrated configuration,
after checking that its own input equals the port's; its 1,024 samples
are half the bodies, mapped through ``inv_order`` on both sides.

Each file holds one ``main``'s records (its module-scoped run), so that
the suite's workers take them apart; ``tests/_jax_tools.py`` holds what
they share, with the tolerance.
"""

import re

from scripts import extreme_run as jax_extreme
from spatialsim_tpu.ops import bh_window as jax_bw
from spatialsim_tpu_torch.tools import extreme_run

from _jax_tools import (EXTREME_ARGS, N, TOL, _calibrated, _port, _script,
                        _to_jax)


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
