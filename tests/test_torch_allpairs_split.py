"""The all-pairs kernel's plan and summation order, on the CPU.

The kernel (``csrc/allpairs.cu``) runs only on a card; here its Python
side is held: ``allpairs_plan`` picks an instance for every N, the slices
cover every source exactly once with zero-mass padding, and a plain
float32 model of the kernel's order (tile partial, slice total, slices in
rank order) stays within 1e-5 of max|a| of the plain version and of the
JAX package's Pallas kernel (interpret mode on the CPU), the limit
``chip_smoke.py`` holds the kernel to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu import distributions
from spatialsim_tpu.ops.allpairs import allpairs_accel as jax_allpairs
from spatialsim_tpu_torch.ops.allpairs import (
    ALLPAIRS_TARGETS, ALLPAIRS_THREADS, ALLPAIRS_TILE, MAX_SLICES,
    allpairs_accel_reference, allpairs_launch, allpairs_plan,
    allpairs_sources, allpairs_split_reference, allpairs_staged)

TOL_ALLPAIRS = 1e-5


def _bodies(n, dist, seed):
    p, _, m = distributions.generate_distribution(dist, n, 200.0, 0.1,
                                                  seed=seed)
    return (torch.from_numpy(np.ascontiguousarray(p.T, np.float32)),
            torch.from_numpy(m.astype(np.float32)))


@pytest.mark.parametrize("n", [1, 255, 10_000, 15_000, 20_000, 30_001,
                               32_768, 1_000_000])
def test_plan_covers_every_source_once(n):
    threads, T, S = allpairs_plan(n)
    assert threads in ALLPAIRS_THREADS and T in ALLPAIRS_TARGETS
    tiles = -(-n // ALLPAIRS_TILE)
    assert 1 <= S <= min(MAX_SLICES, tiles)
    ids = allpairs_sources(n, S)
    assert ids.shape[0] == S and ids.shape[1] % ALLPAIRS_TILE == 0
    real = ids[ids >= 0]
    assert torch.equal(torch.sort(real).values, torch.arange(n))
    assert int((ids < 0).sum()) == ids.numel() - n
    # Each slice is a run of whole tiles; only the last tiles hold padding.
    flat = ids.reshape(-1)
    assert torch.equal(flat[:n], torch.arange(n))
    assert bool((flat[n:] == -1).all())
    if n >= 10_000:          # the presets' counts and up fill the card
        assert -(-n // (threads * T)) * S >= 2 * 132


def test_padding_sources_carry_zero_mass():
    pos, mass = _bodies(1000, "galaxy", 3)
    for S in (1, 3, 8):
        src = allpairs_staged(pos, mass, 0.1, S)
        pad = allpairs_sources(1000, S) < 0
        assert bool((src[3][pad] == 0).all())
        assert bool((src[:3][:, pad] == 1e18).all())
        np.testing.assert_allclose(src[3][~pad].sum(), 0.1 * mass.sum(),
                                   rtol=1e-6)


@pytest.mark.parametrize("slices", [1, 2, 3, 8])
@pytest.mark.parametrize("dist", ["galaxy", "cluster"])
def test_split_order_stays_within_the_kernel_limit(slices, dist):
    """The kernel's order on 3,000 bodies against the plain version and
    the JAX Pallas kernel (interpret mode), both within 1e-5 of max|a|."""
    pos, mass = _bodies(3000, dist, 5)
    got = allpairs_split_reference(pos, mass, 0.1, 2.0, slices)
    want = allpairs_accel_reference(pos, mass, 0.1, 2.0)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL_ALLPAIRS * scale
    jx = np.asarray(jax_allpairs(jnp.asarray(pos.numpy()),
                                 jnp.asarray(mass.numpy()), 0.1, 2.0))
    assert np.abs(got.numpy() - jx).max() <= TOL_ALLPAIRS * np.abs(jx).max()


def test_split_order_with_empty_slices_and_no_softening():
    """More slices than tiles (the last slices all padding), and
    softening 0 with two coincident bodies: the gate alone drops the
    self and coincident pairs; padding at 1e18 adds exactly 0."""
    pos, mass = _bodies(300, "galaxy", 7)
    pos[:, 1] = pos[:, 0]
    got = allpairs_split_reference(pos, mass, 0.1, 0.0, 4)
    want = allpairs_accel_reference(pos, mass, 0.1, 0.0)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TOL_ALLPAIRS * float(
        want.abs().max())


def test_launcher_refuses_cpu_tensors():
    pos, mass = _bodies(100, "galaxy", 1)
    with pytest.raises(ValueError):
        allpairs_launch(pos, mass, 0.1, 2.0, threads=128, targets=4,
                        slices=1)
