"""PyTorch port window-engine build vs the JAX package on the CPU.

``build_lists`` in cell-id mode (the default pooled path): the permutation,
per-group entry counts, tile starts and the packed integer body-range rows
(pool rows 10-13) must be EXACT; the moment rows agree to rtol 2e-5 /
atol 2e-3, the bound the JAX suite uses between its own emission modes
(segment sums in another association order).  ``calibrate_config`` must
grow the same tree, worklist and pool caps cap for cap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu import distributions
from spatialsim_tpu.config.nbody import NBodyConfig
from spatialsim_tpu.ops import bh_window as jbw
from spatialsim_tpu_torch.ops import bh_window as tbw


def _cluster(n, seed, spawn=200.0, G=0.1):
    p, v, m = distributions.generate_distribution("cluster", n, spawn, G,
                                                  seed=seed)
    return (np.ascontiguousarray(p.T, np.float32),
            np.ascontiguousarray(v.T, np.float32), m.astype(np.float32))


def _both_builds(arrays, **kw):
    jl = jbw.build_lists(*(jnp.asarray(a) for a in arrays),
                         emit_mode="cellid", **kw)
    tl = tbw.build_lists(*(torch.from_numpy(a) for a in arrays),
                         emit_mode="cellid", **kw)
    return jl, tl


def _assert_lists_match(jl, tl):
    for f in ("order", "inv_order", "far_n", "pstart"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), err_msg=f)
    jp, tp = np.asarray(jl.pool), tl.pool.numpy()
    assert jp.shape == tp.shape
    # Integer body ranges ride as exact 16-bit halves: bit for bit.
    np.testing.assert_array_equal(tp[:, 10:14], jp[:, 10:14])
    np.testing.assert_allclose(tp, jp, rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("seed", [5, 6])
def test_build_lists_cellid_matches_jax(seed):
    """The kwargs of the JAX suite's cell-id test: order-2 acc rows,
    list_cap overflow -> residual folds, window-straddle slivers."""
    n = 12_000
    pos, vel, mass = _cluster(n, seed)
    acc = (np.random.default_rng(1234).standard_normal((3, n)) * 0.1
           ).astype(np.float32)
    kw = dict(theta=0.6, softening=2.0, skin=2.0, max_depth=7,
              group_size=128, window_groups=2, list_cap=256, pool_tile=128,
              with_ranges=True)
    jl, tl = _both_builds((pos, vel, mass, acc), **kw)
    assert int(tl.far_n.max()) >= kw["list_cap"] - 1, \
        "config should force at least one overflow fold"
    _assert_lists_match(jl, tl)


def test_build_lists_pool_cap_fold_matches_jax():
    """A static pool_cap too small for the lists folds whole groups into
    their residuals; the port folds the same groups."""
    n = 12_000
    pos, vel, mass = _cluster(n, 7)
    kw = dict(theta=0.7, softening=2.0, skin=2.0, max_depth=7,
              group_size=128, window_groups=2, list_cap=512, pool_tile=64,
              with_ranges=True)
    ng = -(-n // kw["group_size"])
    jl, tl = _both_builds((pos, vel, mass), pool_cap=40 + ng + 1, **kw)
    assert (tl.far_n.numpy() == 1).any(), "cap should force group folds"
    _assert_lists_match(jl, tl)


def test_build_lists_unported_options_raise():
    """Only compact emission is left out (ROADMAP Queue 1 item 10); near
    groups and the pooled ranges and values finishes build."""
    pos, vel, mass = (torch.from_numpy(a) for a in _cluster(600, 1))
    kw = dict(theta=0.8, softening=2.0, max_depth=5, group_size=64,
              window_groups=2, list_cap=128)
    for mode in ("compact", "compact-mm"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tbw.build_lists(pos, vel, mass, pool_tile=64, emit_mode=mode,
                            **kw)
    near = tbw.build_lists(pos, vel, mass, pool_tile=0, near_groups=2, **kw)
    assert near.near.shape == (10, 2) and near.far is not None
    for mode in ("ranges", "values"):
        lists = tbw.build_lists(pos, vel, mass, pool_tile=64, emit_mode=mode,
                                **kw)
        assert lists.pool is not None and lists.far is None


def test_comp_prefix_matches_jax(rng):
    n = 50_000
    x = (rng.random((3, n)) * 100.0 + 1.0).astype(np.float32)
    x[1] *= np.sign(rng.normal(size=n)).astype(np.float32)
    s = np.array([0, n - 3, n // 2, 12345, n - 1])
    e = np.array([n, n - 1, n // 2 + 2, 12347, n])
    want = np.asarray(jbw._comp_seg(jbw._comp_prefix(jnp.asarray(x)),
                                    jnp.asarray(s), jnp.asarray(e)))
    got = tbw._comp_seg(tbw._comp_prefix(torch.from_numpy(x)),
                        torch.from_numpy(s), torch.from_numpy(e)).numpy()
    ref = np.concatenate([np.zeros((3, 1)),
                          np.cumsum(x.astype(np.float64), axis=1)], axis=1)
    exact = ref[:, e] - ref[:, s]
    # Both recover short segments of a long prefix to ~1e-6 relative.
    assert np.abs(got - exact).max() / np.abs(exact).max() < 1e-6
    assert np.abs(got - want).max() / np.abs(exact).max() < 1e-6


def test_calibrate_config_matches_jax():
    """A 12K Plummer cluster at group 32 overflows the galaxy-profiled
    worklist caps: both packages grow the same caps and pool cap."""
    n = 12_000
    pos, vel, mass = _cluster(n, 0, spawn=700.0, G=0.08)
    base = NBodyConfig(num_bodies=n, theta=0.8, G=0.08, softening=3.0,
                       spawn_radius=700.0, distribution="cluster",
                       engine="window", group_size=32, max_depth=7,
                       list_capacity=1024, pool_tile=128)
    cj = jbw.calibrate_config(base, jnp.asarray(pos), jnp.asarray(vel),
                              jnp.asarray(mass))
    ct = tbw.calibrate_config(base, torch.from_numpy(pos),
                              torch.from_numpy(vel), torch.from_numpy(mass))
    assert ct.wl_caps, "expected the cluster to grow the default caps"
    assert tuple(ct.tree_caps) == tuple(cj.tree_caps)
    assert tuple(ct.wl_caps) == tuple(cj.wl_caps)
    assert ct.pool_cap == cj.pool_cap


def test_calibrate_sizes_pool_where_jax_default_folds(monkeypatch):
    """Reference fault (ROADMAP.md Queue 3): when the worklist caps fit,
    the JAX calibration keeps the budget-derived pool, and where that pool
    is too small its capacity guard folds whole groups' far fields into
    one residual monopole (677 of 3907 groups at the 1M galaxy).  The
    port's calibration counts emissions and sizes the pool instead.  Here
    a shrunken default pool stands in for the 1M shortfall."""
    import spatialsim_tpu.ops.bh_window as jbw_mod
    import spatialsim_tpu_torch.ops.bh_window as tbw_mod
    n = 12_000
    p, v, m = distributions.generate_distribution("galaxy", n, 200.0, 0.1,
                                                  seed=3)
    pos, vel, mass = (np.ascontiguousarray(a, np.float32)
                      for a in (p.T, v.T, m))
    base = NBodyConfig(num_bodies=n, theta=0.8, G=0.1, softening=2.0,
                       engine="window", group_size=128, max_depth=7,
                       list_capacity=512, pool_tile=128)
    ng = -(-n // base.group_size)
    small = 40 + ng + 1
    monkeypatch.setattr(jbw_mod, "pool_cap_tiles", lambda *a, **k: small)
    monkeypatch.setattr(tbw_mod, "pool_cap_tiles", lambda *a, **k: small)

    cj = jbw.calibrate_config(base, jnp.asarray(pos), jnp.asarray(vel),
                              jnp.asarray(mass))
    ct = tbw.calibrate_config(base, torch.from_numpy(pos),
                              torch.from_numpy(vel), torch.from_numpy(mass))
    assert not cj.wl_caps and not ct.wl_caps, "caps should fit here"
    assert cj.pool_cap == 0 and ct.pool_cap > small
    jl = jbw.build_lists(jnp.asarray(pos), jnp.asarray(vel),
                         jnp.asarray(mass), **jbw._build_kw(cj))
    tl = tbw.build_lists(torch.from_numpy(pos), torch.from_numpy(vel),
                         torch.from_numpy(mass), **tbw._build_kw(ct))
    assert (np.asarray(jl.far_n) == 1).sum() > 0       # JAX folds groups
    assert (tl.far_n.numpy() == 1).sum() == 0          # the port does not
