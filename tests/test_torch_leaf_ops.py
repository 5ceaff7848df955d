"""PyTorch port vs the JAX package: bounds, Morton codes, integrator,
colours.  Same numpy inputs (seeded) through both; every output is
bit-exact (the same sequence of correctly rounded f32 operations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu import distributions
from spatialsim_tpu.ops import bounds as jbounds
from spatialsim_tpu.ops import colors as jcolors
from spatialsim_tpu.ops import integrator as jintegrator
from spatialsim_tpu.ops import morton as jmorton
from spatialsim_tpu_torch.ops import bounds as tbounds
from spatialsim_tpu_torch.ops import colors as tcolors
from spatialsim_tpu_torch.ops import integrator as tintegrator
from spatialsim_tpu_torch.ops import morton as tmorton


def _state(dist, n, seed):
    p, v, m = distributions.generate_distribution(dist, n, 300.0, 0.1,
                                                  seed=seed)
    return (np.ascontiguousarray(p.T, np.float32),
            np.ascontiguousarray(v.T, np.float32), m.astype(np.float32))


@pytest.mark.parametrize("dist,seed", [("galaxy", 0), ("cluster", 1),
                                       ("bar", 2)])
def test_compute_bounds_bitexact(dist, seed):
    pos, _, _ = _state(dist, 5000, seed)
    want = np.asarray(jbounds.compute_bounds(jnp.asarray(pos)))
    got = tbounds.compute_bounds(torch.from_numpy(pos)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth", [1, 7, 8, 10])
def test_morton_encode_bitexact(depth):
    pos, _, _ = _state("galaxy", 6000, 4)
    half = jbounds.compute_bounds(jnp.asarray(pos))
    want = np.asarray(jmorton.morton_encode(jnp.asarray(pos), half, depth))
    got = tmorton.morton_encode(torch.from_numpy(pos),
                                torch.tensor(np.asarray(half)), depth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_morton_rejects_bad_depth():
    with pytest.raises(ValueError):
        tmorton.morton_encode(torch.zeros((3, 4)), 1.0, 11)


@pytest.mark.parametrize("damping", [1.0, 0.995])
def test_integrate_bitexact(damping):
    rng = np.random.default_rng(7)
    pos, vel, acc = (rng.normal(size=(3, 4000)).astype(np.float32) * s
                     for s in (300.0, 5.0, 0.3))
    dt = 0.02
    jp, jv = jintegrator.integrate(jnp.asarray(pos), jnp.asarray(vel),
                                   jnp.asarray(acc), jnp.float32(dt),
                                   damping)
    tp, tv = tintegrator.integrate(torch.from_numpy(pos),
                                   torch.from_numpy(vel),
                                   torch.from_numpy(acc), dt, damping)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("scale", [1.0, 8.0, 40.0])
def test_colors_by_velocity_match(scale):
    # Speeds spread across every band of the gradient (and past the top).
    rng = np.random.default_rng(11)
    vel = (rng.normal(size=(3, 5000)) * scale).astype(np.float32)
    want = np.asarray(jcolors.colors_by_velocity(jnp.asarray(vel), 15.0))
    got = tcolors.colors_by_velocity(torch.from_numpy(vel), 15.0).numpy()
    assert got.shape == (3, 5000) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
