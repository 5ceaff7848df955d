"""PyTorch port octree vs the JAX package on the same sorted bodies.

Per-level codes, counts, body starts and child runs are exact; masses and
centres of mass agree to 1e-5 relative (segment sums in another order).
The tight-cap case overflows two levels, exercising the merge-into-the-
last-slot rule and the unopenable parent.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu import distributions
from spatialsim_tpu.ops.bounds import compute_bounds as jbounds
from spatialsim_tpu.ops.morton import morton_encode as jmorton
from spatialsim_tpu.ops.octree import build_octree as jbuild
from spatialsim_tpu_torch.ops.octree import build_octree as tbuild
from spatialsim_tpu_torch.ops.octree import level_capacity


def _sorted_cluster(n=12_000, depth=7, seed=5):
    p, v, m = distributions.generate_distribution("cluster", n, 200.0, 0.1,
                                                  seed=seed)
    pos = np.ascontiguousarray(p.T, np.float32)
    half = jbounds(jnp.asarray(pos))
    codes = np.asarray(jmorton(jnp.asarray(pos), half, depth))
    o = np.argsort(codes, kind="stable")
    acc = np.random.default_rng(seed).normal(size=(3, n)).astype(np.float32)
    return (codes[o], np.ascontiguousarray(pos[:, o]),
            np.ascontiguousarray(v.T[:, o], np.float32),
            m[o].astype(np.float32), np.ascontiguousarray(acc[:, o]),
            np.asarray(half))


def _both(level_caps=(), depth=7):
    codes, pos, vel, mass, acc, half = _sorted_cluster(depth=depth)
    jt = jbuild(jnp.asarray(codes), jnp.asarray(pos), jnp.asarray(mass),
                jnp.asarray(half), max_depth=depth, start_level=2,
                sorted_vel=jnp.asarray(vel), sorted_acc=jnp.asarray(acc),
                level_caps=level_caps)
    tt = tbuild(torch.from_numpy(codes), torch.from_numpy(pos),
                torch.from_numpy(mass), torch.from_numpy(half),
                max_depth=depth, start_level=2,
                sorted_vel=torch.from_numpy(vel),
                sorted_acc=torch.from_numpy(acc), level_caps=level_caps)
    return jt, tt


def _compare(jt, tt):
    assert len(jt.levels) == len(tt.levels)
    for jl, tl in zip(jt.levels, tt.levels):
        for f in ("code", "count", "body_start", "child_start",
                  "child_count"):
            np.testing.assert_array_equal(
                getattr(tl, f).numpy(), np.asarray(getattr(jl, f)),
                err_msg=f)
        assert int(tl.n_cells) == int(jl.n_cells)
        m = np.asarray(jl.mass)
        np.testing.assert_allclose(tl.mass.numpy(), m, rtol=1e-5,
                                   atol=1e-5 * m.max())
        occ = m > 0
        for f in ("com", "vel", "acc"):
            want = np.asarray(getattr(jl, f))[:, occ]
            got = getattr(tl, f).numpy()[:, occ]
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= 1e-5 * scale, f


def test_octree_matches_jax_full_caps():
    jt, tt = _both()
    _compare(jt, tt)
    # Mass is conserved at every level.
    total = float(tt.levels[-1].mass.sum())
    for lv in tt.levels:
        assert abs(float(lv.mass.sum()) - total) <= 1e-5 * total


def test_octree_matches_jax_tight_cap_overflow():
    depth = 7
    full = [level_capacity(l, 12_000) for l in range(2, depth + 1)]
    jt, _ = _both()
    occ = [int(lv.n_cells) for lv in jt.levels]
    # Squeeze the two deepest levels below their occupancy.
    caps = tuple(full[:-2]) + (occ[-2] // 2, occ[-1] // 3)
    jt, tt = _both(level_caps=caps)
    _compare(jt, tt)
    deep = tt.levels[-1]
    assert deep.code.shape[0] == caps[-1]
    # Overflow merged tail cells into the last slot (mass kept) and left
    # some parent unopenable.
    assert int(deep.count[-1]) > 1
    assert (tt.levels[-2].child_count == 0).sum() > 0
    total = float(tt.levels[0].mass.sum())
    assert abs(float(deep.mass.sum()) - total) <= 1e-5 * total


@pytest.mark.parametrize("depth", [5, 8])
def test_octree_depths_match_jax(depth):
    jt, tt = _both(depth=depth)
    _compare(jt, tt)
