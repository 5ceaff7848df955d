"""The PyTorch port's exact engine (``ops/barnes_hut.py``) vs the JAX
package, on the CPU.

* ``barnes_hut_accel_impl`` at theta 0.3 and 0.8, and with frontier and
  near-list caps small enough to force monopoles: max|da| / max|a| <=
  1e-4 (rsqrt and sums in another order over ~4K sources a body);
* ``NBodySimulation(engine="exact")`` against the JAX model over three
  steps, and the engine against a direct sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu import distributions
from spatialsim_tpu.config.nbody import NBodyConfig
from spatialsim_tpu.ops.barnes_hut import barnes_hut_accel_impl as jbh
from spatialsim_tpu_torch.ops.barnes_hut import barnes_hut_accel_impl as tbh


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _bodies(n, dist, seed):
    p, _, m = distributions.generate_distribution(dist, n, 200.0, 0.1,
                                                  seed=seed)
    return np.ascontiguousarray(p.T, np.float32), m.astype(np.float32)


@pytest.mark.parametrize("case", [
    ("theta0.3", "galaxy", dict(theta=0.3)),
    ("theta0.8", "cluster", dict(theta=0.8)),
    ("caps", "cluster", dict(theta=0.5, frontier_cap=128, near_ranges=16)),
], ids=lambda c: c[0])
def test_barnes_hut_matches_jax(case):
    _, dist, extra = case
    pos, mass = _bodies(3000, dist, 2)
    kw = dict(G=0.1, softening=2.0, max_depth=7, leaf_size=8, group_size=64,
              frontier_cap=1024, near_ranges=256, group_chunk=16)
    kw.update(extra)
    want = np.asarray(jbh(jnp.asarray(pos), jnp.asarray(mass), **kw))
    got = tbh(torch.from_numpy(pos), torch.from_numpy(mass), **kw).numpy()
    assert got.shape == want.shape == (3, 3000)
    assert _rel(got, want) <= 1e-4


def test_exact_engine_simulation_matches_jax_model():
    from spatialsim_tpu.models.nbody import NBodySimulation as JaxSim
    from spatialsim_tpu_torch.models.nbody import NBodySimulation
    from spatialsim_tpu_torch.ops.allpairs import allpairs_accel_reference
    cfg = NBodyConfig(num_bodies=2000, engine="exact", group_size=64,
                      max_depth=7)
    js = JaxSim(config=cfg, seed=3)
    ts = NBodySimulation(config=cfg, seed=3, device="cpu")
    assert ts.engine == js.engine == "exact"
    for _ in range(3):
        js.update(0.02)
        ts.update(0.02)
    assert _rel(ts.get_positions(), js.get_positions()) <= 1e-5
    assert _rel(ts.get_velocities(), js.get_velocities()) <= 1e-4
    # Theta 0.8 against the direct sum: percent-level, as in the JAX suite.
    st = ts.state
    exact = allpairs_accel_reference(st.pos, st.mass, cfg.G, cfg.softening)
    from spatialsim_tpu_torch.ops.barnes_hut import barnes_hut_accel
    approx = barnes_hut_accel(st.pos, st.mass, cfg)
    err = (approx - exact).norm(dim=0) / exact.norm(dim=0).pow(2).mean().sqrt()
    assert float(err.median()) < 0.02
