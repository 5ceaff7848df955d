"""The PyTorch port's quadrupole option vs the JAX package, on the CPU.

* the octree's central second moments ``m2`` at every level (rtol 2e-5,
  atol 2e-4 of each level's scale, the bound of
  ``tests/test_quadrupole.py``), with full and with overflowing tree caps;
* values-emission ``build_lists`` with ``quadrupole=True`` (R = 13, 16);
* ``window_eval_reference`` on JAX-built quadrupole lists against
  ``pallas_window_eval`` in interpret mode (<= 1e-4 of max|a|);
* ``_build_kw`` and the window step across one rebuild with
  ``use_quadrupole=True``; ``NBodySimulation`` reaches the dense path.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu import distributions
from spatialsim_tpu.config.nbody import NBodyConfig
from spatialsim_tpu.ops import bh_window as jbw
from spatialsim_tpu.ops.bounds import compute_bounds as jbounds
from spatialsim_tpu.ops.morton import morton_encode as jmorton
from spatialsim_tpu.ops.octree import build_octree as jbuild
from spatialsim_tpu_torch.ops import bh_window as tbw
from spatialsim_tpu_torch.ops.octree import build_octree as tbuild

from test_torch_dense import (DENSE_STEP_CFG, _cluster, build_matches_jax,
                              jax_dense_eval_case, window_step_matches_jax)


def _sorted_cluster(n=12_000, depth=7, seed=5):
    p, _, m = distributions.generate_distribution("cluster", n, 200.0, 0.1,
                                                  seed=seed)
    pos = np.ascontiguousarray(p.T, np.float32)
    half = jbounds(jnp.asarray(pos))
    codes = np.asarray(jmorton(jnp.asarray(pos), half, depth))
    o = np.argsort(codes, kind="stable")
    return (codes[o], np.ascontiguousarray(pos[:, o]),
            m[o].astype(np.float32), np.array(half))


@pytest.mark.parametrize("tight", [False, True])
def test_octree_m2_matches_jax(tight):
    depth = 7
    codes, pos, mass, half = _sorted_cluster(depth=depth)
    caps = ()
    if tight:
        # Squeeze the two deepest levels below their occupancy: merged
        # tail cells and unopenable parents carry their moments too.
        full = jbuild(jnp.asarray(codes), jnp.asarray(pos),
                      jnp.asarray(mass), jnp.asarray(half), max_depth=depth)
        occ = [int(lv.n_cells) for lv in full.levels]
        caps = tuple(lv.code.shape[0] for lv in full.levels[:-2]) + (
            occ[-2] // 2, occ[-1] // 3)
    jt = jbuild(jnp.asarray(codes), jnp.asarray(pos), jnp.asarray(mass),
                jnp.asarray(half), max_depth=depth, start_level=2,
                with_quadrupole=True, level_caps=caps)
    tt = tbuild(torch.from_numpy(codes), torch.from_numpy(pos),
                torch.from_numpy(mass), torch.from_numpy(half),
                max_depth=depth, start_level=2, with_quadrupole=True,
                level_caps=caps)
    assert len(jt.levels) == len(tt.levels)
    for jl, tl in zip(jt.levels, tt.levels):
        want = np.asarray(jl.m2)
        got = tl.m2.numpy()
        assert got.shape == want.shape == (6, jl.code.shape[0])
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   atol=2e-4 * max(1.0, np.abs(want).max()))
    assert tbuild(torch.from_numpy(codes), torch.from_numpy(pos),
                  torch.from_numpy(mass), torch.from_numpy(half),
                  max_depth=depth).levels[0].m2 is None


@pytest.mark.parametrize("with_acc", [False, True])      # R = 13, 16
def test_build_lists_quadrupole_matches_jax(with_acc):
    build_matches_jax(with_acc, 16 if with_acc else 13, quadrupole=True)


def test_plain_quadrupole_eval_matches_pallas():
    """R = 16 (quadrupole + acceleration rows) at tau = 23 steps."""
    _, _, got, want = jax_dense_eval_case(True, 23, quadrupole=True)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4


def test_build_kw_quadrupole_matches_jax():
    cfg = NBodyConfig(num_bodies=5000, theta=0.8, use_quadrupole=True,
                      quad_accept_scale=1.25, max_depth=7, group_size=128,
                      list_capacity=512)
    got, want = tbw._build_kw(cfg), jbw._build_kw(cfg)
    assert got == {k: want[k] for k in got}
    assert got["pool_tile"] == 0 and got["theta"] == pytest.approx(1.0)
    with pytest.raises(ValueError, match="monopole-only"):
        pos, vel, mass = (torch.from_numpy(a) for a in _cluster(600, 1))
        tbw.build_lists(pos, vel, mass, theta=0.8, softening=2.0,
                        max_depth=5, group_size=64, list_cap=128,
                        quadrupole=True, pool_tile=64)


def test_window_step_quadrupole_across_rebuild_matches_jax():
    cfg = dataclasses.replace(DENSE_STEP_CFG, use_quadrupole=True,
                              pool_tile=512, traversal_emit="auto",
                              advance_order=2)
    window_step_matches_jax(cfg, 16)


def test_nbody_simulation_quadrupole_reaches_dense_path():
    from spatialsim_tpu_torch.models.nbody import NBodySimulation
    cfg = NBodyConfig(num_bodies=3000, engine="window", group_size=64,
                      max_depth=6, list_capacity=512, use_quadrupole=True)
    sim = NBodySimulation(config=cfg, seed=4, device="cpu")
    lists = sim.state.lists
    assert sim.engine == "window" and lists.pool is None
    assert tuple(lists.far.shape) == (47, 16, 512)
    sim.update(0.02)
    assert np.isfinite(sim.get_positions()).all()
    back = NBodySimulation.from_state(sim.get_positions(),
                                      sim.get_velocities(),
                                      sim.get_masses(), config=cfg,
                                      device="cpu")
    assert back.state.lists.far.shape[1] == 16
