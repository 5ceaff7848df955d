"""What the tests of the port's measurement tools against the JAX scripts
share (``tests/test_torch_jax_tools.py``, ``test_torch_jax_quad_tools.py``,
``test_torch_jax_stale_tools.py``, ``test_torch_jax_extreme_tools.py``):
each runs a script's ``main`` and its port's at 2,048 bodies on the CPU
(JAX with Pallas in interpret mode; the port's wrappers take their plain
versions) and compares the records field by field.

Tolerance: 1e-4 absolute on every error statistic (the scripts round
them to 5 places, the extreme run's printed lines to 4; a wrong depth,
theta, tau, skin, variant or sample moves them by 1e-3 and more), exact
on counts and the list line; host-clock times are not compared.
"""

import contextlib
import dataclasses
import io
import json
import sys

import pytest
import torch

from spatialsim_tpu.config import nbody as jax_nbody
from spatialsim_tpu_torch.ops import bh_window as bw
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
