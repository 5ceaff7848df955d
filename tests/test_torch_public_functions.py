"""Two public functions of the JAX package on the PyTorch port, on the
CPU: ``ops/morton.cell_center`` (on the codes and sizes of
``tests/test_octree.py::test_morton_center_within_cell``, and on a
galaxy's codes at every level) and ``models/nbody.make_accel_fn`` with
its stateless engines, "allpairs" and "exact", on 2,048 bodies, and its
``ValueError`` for the stateful window engine.  Centres must be equal bit
for bit; accelerations within 1e-5 of max|a| ("allpairs": another
summation order; "exact": the bar of ``tests/test_torch_exact.py``).
And the last fifteen scripts of ``scripts/``: every top-level function of
each (its ``timeit`` aside) is a function of its port under
``spatialsim_tpu_torch/tools/``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu.config.nbody import NBodyConfig as JaxConfig
from spatialsim_tpu.models import nbody as jax_nbody
from spatialsim_tpu.ops import morton as jax_morton
from spatialsim_tpu_torch.config.nbody import NBodyConfig
from spatialsim_tpu_torch.models import nbody
from spatialsim_tpu_torch.ops import morton
from spatialsim_tpu_torch.ops.bounds import compute_bounds
from spatialsim_tpu_torch.tools.oracle import initial_conditions

N = 2048
TOL = 1e-5


def _centers_match(pos, depth, levels):
    half = compute_bounds(pos)
    codes = morton.morton_encode(pos, half, depth)
    jhalf = jnp.asarray(half.numpy())
    jcodes = jnp.asarray(codes.numpy())
    for level in levels:
        got = morton.cell_center(codes, level, depth, half)
        want = np.asarray(jax_morton.cell_center(jcodes, level, depth,
                                                 jhalf))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=level)
    return codes, half


def test_cell_center_matches_jax_on_the_octree_test_codes():
    pos = torch.tensor([[120.0, -3.0], [5.0, 44.0], [-80.0, 0.1]])
    codes, half = _centers_match(pos, 6, [6, 3, 0])
    side = 2 * float(half) / 2 ** 6
    centers = morton.cell_center(codes, 6, 6, half)
    assert bool(((centers - pos).abs() <= side / 2 + 1e-4).all())


def test_cell_center_matches_jax_at_every_level():
    pos, _, _ = initial_conditions("galaxy", N, 500.0, 0.1,
                                   torch.device("cpu"))
    _centers_match(pos, 10, range(11))


def _config(engine):
    kw = dict(num_bodies=N, theta=0.8, G=0.1, softening=2.0, damping=1.0,
              spawn_radius=500.0, distribution="galaxy", engine=engine)
    return NBodyConfig(**kw), JaxConfig(**kw)


@pytest.mark.parametrize("engine", ["allpairs", "exact"])
def test_make_accel_fn_matches_jax(engine):
    cfg, jcfg = _config(engine)
    pos, vel, mass = initial_conditions("galaxy", N, 500.0, 0.1,
                                        torch.device("cpu"))
    got = nbody.make_accel_fn(cfg, N)(nbody.NBodyState(pos, vel, mass))
    jstate = jax_nbody.NBodyState(*(jnp.asarray(t.numpy())
                                    for t in (pos, vel, mass)))
    want = np.asarray(jax_nbody.make_accel_fn(jcfg, N)(jstate))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert float(np.abs(got.numpy() - want).max()) <= TOL * scale


def test_make_accel_fn_refuses_the_window_engine():
    cfg, jcfg = _config("window")
    with pytest.raises(ValueError, match="stateful"):
        jax_nbody.make_accel_fn(jcfg, N)
    with pytest.raises(ValueError, match="stateful"):
        nbody.make_accel_fn(cfg, N)
    assert nbody.make_accel_fn(cfg, N, engine="allpairs") is not None


# The last fifteen scripts of scripts/ and their ports: every top-level
# function of a script (its ``timeit`` aside: the ports time through
# ``tools/chain.py``) is a function of the port of the same name.
LAST_SCRIPTS = ("decide20", "decide14", "distsort_bench", "seam_analysis",
                "nbody_scan2", "decide2", "decide3", "decide4", "decide5",
                "decide6", "decide19", "decide8", "decide9", "decide10",
                "decide11")


@pytest.mark.parametrize("name", LAST_SCRIPTS)
def test_script_functions_have_their_port(name):
    import ast
    import importlib
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py"
    defs = {node.name for node in ast.parse(src.read_text()).body
            if isinstance(node, ast.FunctionDef)} - {"timeit"}
    assert "main" in defs
    port = importlib.import_module(f"spatialsim_tpu_torch.tools.{name}")
    missing = [d for d in sorted(defs) if not callable(getattr(port, d,
                                                               None))]
    assert not missing, missing
