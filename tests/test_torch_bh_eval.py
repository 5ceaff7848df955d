"""PyTorch port pooled window eval vs the JAX Pallas kernel.

Lists are built by the JAX package and carried over with
``spatialsim_tpu_torch.convert``, so eval parity is held apart from build
parity.  The port's plain version (which its CUDA wrapper takes on CPU
tensors) against ``pallas_window_eval_pool`` in interpret mode:
max|da| / max|a| <= 1e-4, the bound the JAX suite uses between its pooled
and dense evals (sums over thousands of sources in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu.ops.bh_eval_kernel import pallas_window_eval_pool
from spatialsim_tpu.ops.bh_window import build_lists
from spatialsim_tpu_torch.convert import lists_from_numpy
from spatialsim_tpu_torch.ops import bh_eval_kernel as tek

EKW = dict(G=0.1, softening=2.0, group_size=256, window_groups=2)


@pytest.fixture(scope="module")
def jax_lists():
    rng = np.random.default_rng(1234)
    n = 4096
    pos = (rng.normal(size=(3, n)) * 100).astype(np.float32)
    vel = rng.normal(size=(3, n)).astype(np.float32)
    mass = (rng.random(n) + 0.5).astype(np.float32)
    acc = (rng.normal(size=(3, n)) * 0.5).astype(np.float32)
    jl = build_lists(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
                     jnp.asarray(acc), theta=0.8, softening=2.0, skin=2.0,
                     max_depth=6, group_size=256, window_groups=2,
                     list_cap=512, pool_tile=128)
    order = np.asarray(jl.order)
    return jl, pos[:, order], mass[order]


@pytest.mark.parametrize("steps_since", [0, 5])
def test_plain_window_eval_matches_pallas(jax_lists, steps_since):
    jl, s_pos, s_mass = jax_lists
    dt = 0.02
    want = np.asarray(pallas_window_eval_pool(
        jnp.asarray(s_pos), jnp.asarray(s_mass), jl.pool, jl.pstart,
        jl.far_n, steps_since, dt, **EKW))
    tl = lists_from_numpy(jl.order, jl.inv_order, jl.far_n, jl.ref_pos,
                          jl.pool, jl.pstart, steps_since)
    got = tek.window_eval_pool_reference(
        torch.from_numpy(s_pos), torch.from_numpy(s_mass), tl.pool,
        tl.pstart, tl.far_n, tl.steps_since, dt, **EKW).numpy()
    assert got.shape == want.shape == (3, 4096)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4


def test_cpu_wrapper_takes_plain_version_without_launching(jax_lists):
    jl, s_pos, s_mass = jax_lists
    tl = lists_from_numpy(jl.order, jl.inv_order, jl.far_n, jl.ref_pos,
                          jl.pool, jl.pstart)
    args = (torch.from_numpy(s_pos), torch.from_numpy(s_mass), tl.pool,
            tl.pstart, tl.far_n, 3, 0.02)
    before = tek.window_eval_pool.launches
    got = tek.window_eval_pool(*args, **EKW)
    assert tek.window_eval_pool.launches == before
    np.testing.assert_array_equal(
        got.numpy(), tek.window_eval_pool_reference(*args, **EKW).numpy())


def test_advance_coefficients_clamp():
    tau, c2 = tek.advance_coefs(30, 0.02, 24.0)
    tc = np.float32(24) * np.float32(0.02)
    assert tau == pytest.approx(0.6, rel=1e-6)
    assert c2 == pytest.approx(float(tc * np.float32(tau) - 0.5 * tc * tc),
                               rel=1e-6)
    assert tek.advance_coefs(0, 0.02, 24.0) == (0.0, 0.0)


def test_tile_index_clamped_to_pool(jax_lists):
    """A pstart past the pool's end reads the last tile, never beyond it
    (the TPU kernel's hard clamp); the plain version mirrors it."""
    jl, s_pos, s_mass = jax_lists
    tl = lists_from_numpy(jl.order, jl.inv_order, jl.far_n, jl.ref_pos,
                          jl.pool, jl.pstart)
    ct = tl.pool.shape[0]
    args = (torch.from_numpy(s_pos), torch.from_numpy(s_mass), tl.pool)
    past, last = tl.pstart.clone(), tl.pstart.clone()
    past[-1] = ct + 5
    last[-1] = ct - 1      # every tile index of the group clamps here
    got = tek.window_eval_pool_reference(*args, past, tl.far_n, 0, 0.02,
                                         **EKW)
    want = tek.window_eval_pool_reference(*args, last, tl.far_n, 0, 0.02,
                                          **EKW)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert torch.isfinite(got).all()
