"""PyTorch port all-pairs vs the JAX Pallas kernel (interpret mode on CPU).

The port's CUDA kernel runs only on a card (tests/test_torch_cuda.py and
chip_smoke.py); here the wrapper takes its plain version because the
tensors lie on the CPU.  Tolerance: max|da| / max|a| <= 1e-5 -- the two
sum the same pairs in another order (Pallas tiles of 1024 vs one
broadcast row) and JAX folds G into each pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu import distributions
from spatialsim_tpu.ops.allpairs import allpairs_accel as jax_allpairs
from spatialsim_tpu_torch.ops.allpairs import (allpairs_accel,
                                               allpairs_accel_reference)


def _bodies(n, dist, seed):
    p, _, m = distributions.generate_distribution(dist, n, 200.0, 0.1,
                                                  seed=seed)
    return np.ascontiguousarray(p.T, np.float32), m.astype(np.float32)


@pytest.mark.parametrize("n,dist", [(1000, "galaxy"), (2048, "galaxy"),
                                    (2048, "cluster")])
def test_plain_allpairs_matches_jax_kernel(n, dist):
    pos, mass = _bodies(n, dist, 2)
    want = np.asarray(jax_allpairs(jnp.asarray(pos), jnp.asarray(mass),
                                   0.1, 2.0))
    got = allpairs_accel_reference(torch.from_numpy(pos),
                                   torch.from_numpy(mass), 0.1, 2.0).numpy()
    assert got.shape == (3, n)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


def test_cpu_wrapper_takes_plain_version_without_launching():
    pos, mass = _bodies(600, "galaxy", 5)
    before = allpairs_accel.launches
    got = allpairs_accel(torch.from_numpy(pos), torch.from_numpy(mass),
                         0.1, 2.0)
    want = allpairs_accel_reference(torch.from_numpy(pos),
                                    torch.from_numpy(mass), 0.1, 2.0)
    assert allpairs_accel.launches == before
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_plain_allpairs_chunking_is_exact(monkeypatch):
    """Target chunking (which bounds the pair temporaries at large N)
    changes no result: each target's row is summed the same way."""
    import spatialsim_tpu_torch.ops.allpairs as ap
    pos, mass = _bodies(777, "cluster", 9)
    full = allpairs_accel_reference(torch.from_numpy(pos),
                                    torch.from_numpy(mass), 0.1, 2.0)
    monkeypatch.setattr(ap, "_PAIRS_PER_CHUNK", 777 * 50)
    chunked = allpairs_accel_reference(torch.from_numpy(pos),
                                       torch.from_numpy(mass), 0.1, 2.0)
    np.testing.assert_array_equal(full.numpy(), chunked.numpy())


def test_coincident_bodies_excluded():
    # Two bodies at the same point feel nothing from each other (the
    # dist^2 > softening^2 gate), only from the third.
    pos = np.array([[0.0, 0.0, 10.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
                   np.float32)
    mass = np.ones(3, np.float32)
    a = allpairs_accel_reference(torch.from_numpy(pos),
                                 torch.from_numpy(mass), 1.0, 1.0).numpy()
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a[0, 0], a[0, 1])
    assert a[0, 0] > 0 and a[0, 2] < 0
