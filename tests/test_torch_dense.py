"""The PyTorch port's dense far layout (monopole) vs the JAX package, on
the CPU.

* ``build_lists`` with ``pool_tile=0`` and ranges emission (the path above
  20.5M bodies): order, inv_order, far_n and far_range exact; far rows to
  rtol 2e-5 / atol 2e-3, the bound of ``test_torch_bh_window``'s
  ``_assert_lists_match`` (segment sums in another association order);
* the group-chunked ranges finish equals the one-shot finish;
* dense and pooled lists of one state share order and far_n, and their
  plain evals agree;
* ``window_eval_reference`` on JAX-built dense lists against
  ``pallas_window_eval`` in interpret mode, for R = 8 and 10 and a near
  table: max|da| / max|a| <= 1e-4 (the JAX suite's Pallas-vs-XLA bar);
* the window step across one rebuild on the 50M path's layout, and the
  EXTREME preset's resolution.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu import distributions
from spatialsim_tpu.config.nbody import NBodyConfig
from spatialsim_tpu.ops import bh_window as jbw
from spatialsim_tpu.ops.bh_eval_kernel import pallas_window_eval
from spatialsim_tpu_torch.convert import dense_lists_from_numpy
from spatialsim_tpu_torch.ops import bh_eval_kernel as tek
from spatialsim_tpu_torch.ops import bh_window as tbw

EKW = dict(G=0.1, softening=2.0, group_size=128, window_groups=2)


def _cluster(n, seed, spawn=200.0, G=0.1):
    p, v, m = distributions.generate_distribution("cluster", n, spawn, G,
                                                  seed=seed)
    return (np.ascontiguousarray(p.T, np.float32),
            np.ascontiguousarray(v.T, np.float32), m.astype(np.float32))


def assert_dense_lists_match(jl, tl):
    """Exact permutation, counts and ranges; far rows to rtol 2e-5 / atol
    2e-3, quadrupole rows (second moments, ~1e6 here) to rtol 2e-5 / atol
    2e-5 of their largest value."""
    for f in ("order", "inv_order", "far_n", "far_range"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), err_msg=f)
    jf, tf = np.asarray(jl.far), tl.far.numpy()
    assert jf.shape == tf.shape
    quad, _ = tek.far_layout(jf.shape[1])
    q = slice(7, 13) if quad else slice(0, 0)
    rows = [r for r in range(jf.shape[1]) if not q.start <= r < q.stop]
    np.testing.assert_allclose(tf[:, rows], jf[:, rows], rtol=2e-5,
                               atol=2e-3)
    if quad:
        np.testing.assert_allclose(tf[:, q], jf[:, q], rtol=2e-5,
                                   atol=2e-5 * np.abs(jf[:, q]).max())


BUILD_KW = dict(theta=0.6, softening=2.0, skin=2.0, max_depth=6,
                group_size=128, window_groups=2, list_cap=256, pool_tile=0)
N_BUILD = 12_000


@functools.lru_cache(maxsize=None)
def jax_build(with_acc, **build):
    """A 12K cluster (with order-2 accelerations when ``with_acc``) and
    the JAX package's dense lists for it at ``BUILD_KW``: one JAX build
    per configuration serves its build and its eval parity tests."""
    arrays = list(_cluster(N_BUILD, 5))
    if with_acc:
        arrays.append((np.random.default_rng(1234).standard_normal(
            (3, N_BUILD)) * 0.1).astype(np.float32))
    kw = dict(BUILD_KW, **build)
    return arrays, jbw.build_lists(*(jnp.asarray(a) for a in arrays), **kw)


def build_matches_jax(with_acc, n_rows, **build):
    arrays, jl = jax_build(with_acc, **build)
    tl = tbw.build_lists(*(torch.from_numpy(a) for a in arrays),
                         **dict(BUILD_KW, **build))
    assert tl.pool is None and tl.far.shape[1] == n_rows
    assert int(tl.far_n.max()) >= BUILD_KW["list_cap"] - 1, \
        "config should force at least one overflow fold"
    assert_dense_lists_match(jl, tl)


@pytest.mark.parametrize("with_acc", [False, True])      # R = 8, 10
def test_build_lists_ranges_matches_jax(with_acc):
    build_matches_jax(with_acc, 10 if with_acc else 8, emit_mode="ranges")


def test_ranges_finish_group_chunked_matches(monkeypatch):
    """At 50M bodies the moments are materialised ``_COMP_SEG_CHUNK // L``
    groups at a time; chunking changes no value."""
    pos, vel, mass = (torch.from_numpy(a) for a in _cluster(6000, 2))
    acc = torch.from_numpy((np.random.default_rng(7).standard_normal(
        (3, 6000)) * 0.1).astype(np.float32))
    kw = dict(BUILD_KW, emit_mode="ranges")
    ref = tbw.build_lists(pos, vel, mass, acc, **kw)
    monkeypatch.setattr(tbw, "_COMP_SEG_CHUNK", 3 * kw["list_cap"] + 17)
    chk = tbw.build_lists(pos, vel, mass, acc, **kw)
    for f in ("far_n", "far_range", "far"):
        torch.testing.assert_close(getattr(chk, f), getattr(ref, f),
                                   rtol=0, atol=0)


def jax_dense_eval_case(with_acc, steps_since, **build):
    """The Pallas kernel's accelerations (interpret mode) on the JAX-built
    dense lists of :func:`jax_build`, and the port's plain version on the
    same lists (carried over by ``dense_lists_from_numpy``)."""
    (pos, _, mass, *_), jl = jax_build(with_acc, **build)
    order = np.asarray(jl.order)
    s_pos = pos[:, order]
    s_mass = np.where(np.arange(order.size) < N_BUILD, mass[order], 0.0
                      ).astype(np.float32)
    K = jl.near.shape[1]
    want = np.asarray(pallas_window_eval(
        jnp.asarray(s_pos), jnp.asarray(s_mass), jl.far, jl.far_n,
        jl.near if K else None, steps_since, 0.02, **EKW))
    tl = dense_lists_from_numpy(jl.order, jl.inv_order, jl.far, jl.far_n,
                                jl.far_range, jl.near, jl.ref_pos,
                                steps_since)
    got = tek.window_eval_reference(
        torch.from_numpy(s_pos), torch.from_numpy(s_mass), tl.far,
        tl.far_n, tl.near, tl.steps_since, 0.02, **EKW).numpy()
    assert got.shape == want.shape == (3, order.size)
    return (s_pos, s_mass), tl, got, want


@pytest.mark.parametrize("case", [
    ("R8", False, 0, dict(emit_mode="ranges")),
    ("R10", True, 7, dict(emit_mode="ranges")),
    ("near2", False, 5, dict(near_groups=2)),
], ids=lambda c: c[0])
def test_plain_dense_eval_matches_pallas(case):
    name, with_acc, steps_since, build = case
    _, tl, got, want = jax_dense_eval_case(with_acc, steps_since, **build)
    if name == "near2":
        assert tl.near is not None and tl.near.shape[1] == 2
        assert (tl.near >= 0).any()
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4


def test_plain_dense_eval_groups_subset():
    """``groups=`` evaluates only those groups' bodies, as the whole."""
    (s_pos, s_mass), tl, got, _ = jax_dense_eval_case(
        True, 7, emit_mode="ranges")
    groups = torch.tensor([0, 5, 93, 17])
    sub = tek.window_eval_reference(
        torch.from_numpy(s_pos), torch.from_numpy(s_mass), tl.far,
        tl.far_n, None, 7, 0.02, groups=groups, **EKW).numpy()
    cols = (groups[:, None] * 128 + torch.arange(128)).reshape(-1).numpy()
    # The same sums, over a shorter zero-masked far slot range.
    assert np.abs(sub - got[:, cols]).max() <= 1e-6 * np.abs(got).max()


def test_dense_and_pooled_lists_agree():
    """One traversal, two finishes: the dense ranges lists and the pooled
    cell-id lists of the same state have the same order and far_n, and
    their plain evals agree to 1e-4 of max|a|."""
    pos, vel, mass = (torch.from_numpy(a) for a in _cluster(4000, 3))
    acc = torch.from_numpy((np.random.default_rng(9).standard_normal(
        (3, 4000)) * 0.1).astype(np.float32))
    kw = dict(BUILD_KW)
    del kw["pool_tile"]
    dense = tbw.build_lists(pos, vel, mass, acc, pool_tile=0,
                            emit_mode="ranges", **kw)
    pooled = tbw.build_lists(pos, vel, mass, acc, pool_tile=64,
                             pool_cap=32 * 8, **kw)
    np.testing.assert_array_equal(dense.order.numpy(), pooled.order.numpy())
    np.testing.assert_array_equal(dense.far_n.numpy(), pooled.far_n.numpy())
    o = dense.order.long()
    s_pos = pos[:, o].contiguous()
    s_mass = torch.where(torch.arange(o.numel()) < 4000, mass[o],
                         torch.zeros(()))
    a_dense = tek.window_eval_reference(s_pos, s_mass, dense.far,
                                        dense.far_n, None, 7, 0.02, **EKW)
    a_pool = tek.window_eval_pool_reference(
        s_pos, s_mass, pooled.pool, pooled.pstart, pooled.far_n, 7, 0.02,
        **EKW)
    assert _rel(a_dense.numpy(), a_pool.numpy()) <= 1e-4


@pytest.mark.parametrize("build", [dict(emit_mode="ranges"),
                                   dict(quadrupole=True)],
                         ids=["ranges", "values"])
def test_dense_lists_conserve_mass_per_group(build):
    """Window mass plus far-entry mass is the total for every group, each
    body in exactly one of window, entry, sliver or residual.  Masses of
    ~1e4 put most groups' residuals past 2^24, where float32 accumulation
    of the folded cells drifts by ~1e-6 of the total; the bound is two
    float32 roundings of the far mass."""
    n, gsz, wg = 6000, 64, 2
    pos, vel, _ = (torch.from_numpy(a) for a in _cluster(n, 2))
    mass = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5e4, 1.5e4, n).astype(np.float32))
    kw = dict(BUILD_KW, group_size=gsz, window_groups=wg, list_cap=128)
    lists = tbw.build_lists(pos, vel, mass, **kw, **build)
    ng, L = lists.far_n.shape[0], lists.far.shape[2]
    m64 = torch.zeros(ng * gsz, dtype=torch.float64)
    m64[:n] = mass[lists.order[:n].long()].double()
    gm = m64.reshape(ng, gsz).sum(1)
    c = torch.cat([gm.new_zeros(1), gm.cumsum(0)])
    g = torch.arange(ng)
    window = (c[torch.clamp(g + wg, max=ng - 1) + 1]
              - c[torch.clamp(g - wg, min=0)])
    live = torch.arange(L)[None, :] < lists.far_n.long()[:, None]
    far = torch.where(live, lists.far[:, 6], 0.0).sum(1, dtype=torch.float64)
    total = float(gm.sum())
    assert total > 2 ** 24 and int(lists.far_n.max()) == L
    assert float((window + far - total).abs().max()) <= 2e-7 * total


def test_cpu_dense_wrapper_takes_plain_version_without_launching():
    pos, vel, mass = (torch.from_numpy(a) for a in _cluster(4000, 3))
    lists = tbw.build_lists(pos, vel, mass, emit_mode="ranges", **BUILD_KW)
    o = lists.order.long()
    args = (pos[:, o].contiguous(), mass[o], lists.far, lists.far_n, None,
            4, 0.02)
    before = tek.window_eval.launches
    got = tek.window_eval(*args, **EKW)
    assert tek.window_eval.launches == before
    np.testing.assert_array_equal(
        got.numpy(), tek.window_eval_reference(*args, **EKW).numpy())


DENSE_STEP_CFG = NBodyConfig(
    num_bodies=4000, theta=0.8, G=0.1, softening=2.0, engine="window",
    max_depth=6, group_size=128, list_capacity=512, window_groups=2,
    skin=2.0, rebuild_interval=4, rebuild_drift_mode="off", pool_tile=0,
    traversal_emit="ranges", advance_order=1)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def window_step_matches_jax(cfg, n_rows):
    """Six steps of the port's and JAX's window steps from the same ICs,
    across one rebuild: equal permutations, positions and velocities to
    1e-4 of their largest value."""
    from spatialsim_tpu.ops import bh_window as jax_bw
    n = cfg.num_bodies
    p, v, m = distributions.generate_distribution("galaxy", n, 200.0, 0.1,
                                                  seed=3)
    pos, vel, mass = (np.ascontiguousarray(a, np.float32)
                      for a in (p.T, v.T, m))
    js = jax_bw.init_window_state(jnp.asarray(pos), jnp.asarray(vel),
                                  jnp.asarray(mass), cfg)
    jstep = jax_bw.make_window_step(cfg, n, 1)
    ts = tbw.init_window_state(torch.from_numpy(pos), torch.from_numpy(vel),
                               torch.from_numpy(mass), cfg)
    tstep = tbw.make_window_step(cfg, n, 1)
    assert ts.lists.pool is None and ts.lists.far.shape[1] == n_rows
    for _ in range(6):
        js = jstep(js, jnp.float32(0.02))
        ts = tstep(ts, 0.02)
    assert tstep.rebuilds == 1
    np.testing.assert_array_equal(ts.lists.order.numpy(),
                                  np.asarray(js.lists.order))
    assert _rel(ts.pos.numpy(), np.asarray(js.pos)) <= 1e-4
    assert _rel(ts.vel.numpy(), np.asarray(js.vel)) <= 1e-4


def test_window_step_dense_ranges_across_rebuild_matches_jax():
    """The 50M path's code at 4,000 bodies: pool off, ranges emission,
    first-order advance (R = 8)."""
    window_step_matches_jax(DENSE_STEP_CFG, 8)


def test_extreme_50m_preset_resolves_to_the_dense_path():
    from spatialsim_tpu_torch.config.nbody import resolve_config
    from spatialsim_tpu_torch.presets import get_preset_config
    from spatialsim_tpu_torch.tools.record import config_from_preset
    n = 50_000_000
    cfg = resolve_config(config_from_preset(
        get_preset_config("extreme_50m_galaxy")), n)
    assert (cfg.num_bodies, cfg.theta, cfg.G, cfg.softening,
            cfg.spawn_radius) == (n, 1.5, 0.04, 10.0, 3000.0)
    assert (cfg.max_depth, cfg.group_size, cfg.list_capacity,
            cfg.advance_order, cfg.pool_tile, cfg.traversal_emit) == \
        (8, 1024, 2048, 1, 0, "ranges")
    npad = -(-n // cfg.group_size) * cfg.group_size
    assert (npad // cfg.group_size, npad) == (48_829, 50_000_896)
    assert tbw._auto_budget(npad) == 24_000_000
    kw = tbw._build_kw(cfg)
    assert (kw["pool_tile"], kw["emit_mode"], kw["quadrupole"]) == \
        (0, "ranges", False)
