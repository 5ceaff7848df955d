"""The PyTorch port's window-engine options vs the JAX package, on the CPU:
near groups, moment refresh, the pooled ranges and values finishes, and
the one-shot and diagnostic entry points.

* ``_select_near_groups`` (ties included: ``jax.lax.top_k`` puts the lower
  id first) and ``_covered_intervals`` exact;
* ``build_lists`` with ``near_groups = K``: the near table, order, far_n
  and far_range exact, far rows to ``test_torch_dense``'s bound; every
  group's window + near + far + residual mass is the total, and the exact
  near field does not worsen the median force error (the JAX suite's
  ``test_near_groups_conserve_mass_and_improve_error``);
* ``refresh_lists`` on dense and pooled lists after a drift ``pos + 0.3
  vel``, residual rebase included: rows to rtol 2e-5 / atol 2e-3;
* the window step across a refresh and a rebuild (pooled, and dense with
  near groups) against ``make_window_step``: 1e-4 of the largest value;
* (slow) ``chip_smoke.py`` phase 15's refresh protocol and phase 14's
  near-group protocol at 20K bodies.

The pooled ranges and values finishes and the one-shot entry points are in
``test_torch_pooled_finishes.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu import distributions
from spatialsim_tpu.config.nbody import NBodyConfig
from spatialsim_tpu.ops import bh_window as jbw
from spatialsim_tpu_torch.convert import (dense_lists_from_numpy,
                                          lists_from_numpy)
from spatialsim_tpu_torch.ops import bh_window as tbw

from test_torch_bh_window import _assert_lists_match
from test_torch_dense import assert_dense_lists_match


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _galaxy(n, seed):
    p, v, m = distributions.generate_distribution("galaxy", n, 200.0, 0.1,
                                                  seed=seed)
    return tuple(np.ascontiguousarray(a, np.float32) for a in (p.T, v.T, m))


def _acc(n, seed=1234):
    return (np.random.default_rng(seed).standard_normal((3, n)) * 0.1
            ).astype(np.float32)


def test_select_near_groups_and_intervals_match_jax():
    """Boxes with exact ties (repeated boxes score equal): both keep the
    lower id first; then the merged covered intervals of random tables
    with empty (-1), repeated and window-adjacent ids."""
    rng = np.random.default_rng(3)
    ng, K, wg = 150, 6, 2
    lo = rng.uniform(-50, 50, (40, 3))
    bmin = lo[rng.integers(0, 40, ng)].astype(np.float32)
    bmax = (bmin + rng.uniform(1, 20, (40, 3))[rng.integers(0, 40, ng)]
            ).astype(np.float32)
    want = np.asarray(jbw._select_near_groups(
        jnp.asarray(bmin), jnp.asarray(bmax), K, wg, 0, ng))
    got = tbw._select_near_groups(torch.from_numpy(bmin),
                                  torch.from_numpy(bmax), K, wg, chunk=64)
    assert (want >= 0).sum() > ng and (want == -1).any()
    np.testing.assert_array_equal(got.numpy(), want)

    near = rng.integers(-1, ng, (ng, K)).astype(np.int32)
    g = np.arange(ng)
    near[:, 0] = np.clip(g + wg + 1, 0, ng - 1)          # touches the window
    near[:, 1] = near[:, 2]                               # repeated id
    for k_ in (0, K):
        nk = near[:, :k_]
        want = np.asarray(jbw._covered_intervals(jnp.asarray(nk), wg, 0, 64))
        got = tbw._covered_intervals(torch.from_numpy(nk), wg, 64)
        np.testing.assert_array_equal(got.numpy(), want)


NEAR_KW = dict(theta=0.8, softening=2.0, skin=2.0, max_depth=7,
               group_size=64, window_groups=2, list_cap=256, pool_tile=0)
N_NEAR = 4096


@functools.lru_cache(maxsize=None)
def near_arrays(with_acc):
    arrays = _galaxy(N_NEAR, 7)
    return arrays + ((_acc(N_NEAR),) if with_acc else ())


@pytest.mark.parametrize("case", [
    ("values", False, dict(near_groups=6)),
    ("ranges-acc", True, dict(near_groups=4, emit_mode="ranges")),
], ids=lambda c: c[0])
def test_near_group_build_matches_jax(case):
    _, with_acc, build = case
    arrays = near_arrays(with_acc)
    kw = dict(NEAR_KW, **build)
    jl = jbw.build_lists(*(jnp.asarray(a) for a in arrays), **kw)
    tl = tbw.build_lists(*(torch.from_numpy(a) for a in arrays), **kw)
    K = build["near_groups"]
    assert tl.near.shape == (N_NEAR // 64, K) and (tl.near >= 0).any()
    np.testing.assert_array_equal(tl.near.numpy(), np.asarray(jl.near))
    assert int(tl.far_n.max()) >= kw["list_cap"] - 1, "want overflow folds"
    assert_dense_lists_match(jl, tl)


def test_near_groups_conserve_mass_and_do_not_worsen_error():
    from spatialsim_tpu_torch.ops.allpairs import allpairs_accel_reference
    pos, vel, mass = (torch.from_numpy(a) for a in near_arrays(False))
    gsz, wg = 64, 2
    exact = allpairs_accel_reference(pos, mass, 0.1, 2.0)
    rms = exact.norm(dim=0).pow(2).mean().sqrt()
    errs = {}
    for K in (0, 6):
        cfg = NBodyConfig(theta=0.8, G=0.1, softening=2.0, max_depth=7,
                          group_size=gsz, list_capacity=4096,
                          window_groups=wg, skin=2.0, near_groups=K,
                          engine="window", pool_tile=0)
        lists = tbw.build_lists(pos, vel, mass, **tbw._build_kw(cfg))
        ng = lists.far_n.shape[0]
        m = torch.zeros(ng * gsz, dtype=torch.float64)
        m[:N_NEAR] = mass[lists.order[:N_NEAR].long()].double()
        gm = m.reshape(ng, gsz).sum(1)
        wmass = torch.stack([gm[max(0, i - wg):i + wg + 1].sum()
                             for i in range(ng)])
        nmass = torch.zeros(ng, dtype=torch.float64)
        if K:
            nb = lists.near.long()
            nmass = torch.where(nb >= 0, gm[nb.clamp(min=0)], 0.0).sum(1)
        live = torch.arange(lists.far.shape[2])[None, :] < \
            lists.far_n.long()[:, None]
        fmass = torch.where(live, lists.far[:, 6], 0.0).sum(1).double()
        total = float(gm.sum())
        assert float((wmass + nmass + fmass - total).abs().max()) \
            <= 1e-5 * total, K
        acc = tbw.window_bh_accel(pos, vel, mass, cfg)
        errs[K] = float(((acc - exact).norm(dim=0) / rms).median())
    assert errs[6] <= errs[0] * 1.05 + 1e-5, errs


REFRESH_KW = dict(theta=0.8, softening=2.0, skin=2.0, max_depth=6,
                  group_size=64, window_groups=2, list_cap=256)


@pytest.mark.parametrize("layout", ["dense", "pooled"])
def test_refresh_lists_matches_jax(layout):
    """Lists 5 steps old (so the residual's rebase moves it), refreshed on
    a drifted sorted state with accelerations."""
    pos, vel, mass = _galaxy(3000, 21)
    acc = _acc(3000, 5)
    kw = dict(REFRESH_KW, pool_tile=64 if layout == "pooled" else 0)
    jl = jbw.build_lists(*(jnp.asarray(a) for a in (pos, vel, mass, acc)),
                         **kw)
    jl = jl._replace(steps_since=jnp.int32(5))
    if layout == "pooled":
        tl = lists_from_numpy(jl.order, jl.inv_order, jl.far_n, jl.ref_pos,
                              jl.pool, jl.pstart, 5)
    else:
        tl = dense_lists_from_numpy(jl.order, jl.inv_order, jl.far, jl.far_n,
                                    jl.far_range, jl.near, jl.ref_pos, 5)
    o = np.asarray(jl.order)[:3000]
    moved = pos[:, o] + 0.3 * vel[:, o]
    state = (moved, vel[:, o], mass[o], acc[:, o])
    jr = jbw.refresh_lists(jl, *(jnp.asarray(a) for a in state), 0.02, 24.0)
    tr = tbw.refresh_lists(tl, *(torch.from_numpy(a) for a in state), 0.02,
                           24.0)
    assert tr.steps_since == 0 and tr.steps_build == 5
    if layout == "pooled":
        _assert_lists_match(jr, tr)
        want, before = np.asarray(jr.pool), np.asarray(jl.pool)
    else:
        assert_dense_lists_match(jr, tr)
        want, before = np.asarray(jr.far), np.asarray(jl.far)
    # The refresh moved the entries (and the rebased residuals).
    assert np.abs(want[:, 0:3] - before[:, 0:3]).max() > 0.1


STEP_CFG = NBodyConfig(num_bodies=2048, theta=0.8, G=0.1, softening=2.0,
                       engine="window", max_depth=7, group_size=64,
                       list_capacity=512, window_groups=2, skin=2.0,
                       rebuild_interval=5, refresh_interval=2,
                       rebuild_drift_mode="off", pool_tile=64)


@pytest.mark.parametrize("cfg", [STEP_CFG, STEP_CFG.replace(near_groups=4)],
                         ids=["pooled", "near4-dense"])
def test_window_step_across_refresh_and_rebuild_matches_jax(cfg):
    """Six steps: refreshes before steps 3 and 5, a rebuild before step 6
    (steps_build 5).  Equal permutations, positions and velocities to 1e-4
    of their largest value."""
    n = cfg.num_bodies
    pos, vel, mass = _galaxy(n, 3)
    js = jbw.init_window_state(jnp.asarray(pos), jnp.asarray(vel),
                               jnp.asarray(mass), cfg)
    jstep = jbw.make_window_step(cfg, n, 1)
    ts = tbw.init_window_state(torch.from_numpy(pos), torch.from_numpy(vel),
                               torch.from_numpy(mass), cfg)
    tstep = tbw.make_window_step(cfg, n, 1)
    assert (ts.lists.pool is None) == bool(cfg.near_groups)
    for _ in range(6):
        js = jstep(js, jnp.float32(0.02))
        ts = tstep(ts, 0.02)
    assert (tstep.refreshes, tstep.rebuilds) == (2, 1)
    assert ts.lists.steps_since == int(js.lists.steps_since) == 1
    np.testing.assert_array_equal(ts.lists.order.numpy(),
                                  np.asarray(js.lists.order))
    assert _rel(ts.pos.numpy(), np.asarray(js.pos)) <= 1e-4
    assert _rel(ts.vel.numpy(), np.asarray(js.vel)) <= 1e-4


@pytest.mark.slow
def test_refresh_protocol_matches_jax_at_20k():
    """``chip_smoke.py`` phase 15's protocol at 20K bodies (the default
    config, 5 warm-up steps at rebuild interval 4, then 22 frozen steps
    with and without a refresh every 12): the aged lists' force errors
    against a direct sum equal the JAX package's to 1e-5 relative, so the
    refresh's effect on the error tail is the JAX function's."""
    import dataclasses
    from spatialsim_tpu.config.nbody import NBodyConfig as JaxConfig
    from spatialsim_tpu.ops.allpairs import allpairs_accel_reference as jref
    from spatialsim_tpu_torch.config.nbody import NBODY, resolve_config
    from spatialsim_tpu_torch.ops.allpairs import allpairs_accel_reference
    n, dt = 20_000, 0.02
    cfg = resolve_config(NBODY.replace(num_bodies=n, engine="window"), n)
    p, v, m = distributions.generate_distribution(
        "galaxy", n, cfg.spawn_radius, cfg.G, seed=0)
    arrays = tuple(np.ascontiguousarray(a, np.float32) for a in (p.T, v.T, m))
    tarr = tuple(torch.from_numpy(a) for a in arrays)
    cal = tbw.calibrate_config(cfg, *tarr)

    def stats(acc, exact):
        e = np.linalg.norm(acc - exact, axis=0)
        a = np.linalg.norm(exact, axis=0)
        r = e / a
        return np.array([np.sqrt((r * r).mean()), np.median(r),
                         np.sqrt((e * e).mean() / (a * a).mean())])

    for riv in (0, 12):
        c = cal.replace(refresh_interval=riv)
        jc = JaxConfig(**dataclasses.asdict(c))
        js = jbw.init_window_state(*(jnp.asarray(a) for a in arrays), jc)
        js = jbw.make_window_step(jc.replace(rebuild_interval=4), n, 5)(
            js, jnp.float32(dt))
        js = jbw.make_window_step(jc.replace(rebuild_interval=10 ** 6), n,
                                  22)(js, jnp.float32(dt))
        ts = tbw.init_window_state(*tarr, c)
        ts = tbw.make_window_step(c.replace(rebuild_interval=4), n, 5)(ts, dt)
        ts = tbw.make_window_step(c.replace(rebuild_interval=10 ** 6), n,
                                  22)(ts, dt)
        assert ts.lists.steps_since == int(js.lists.steps_since) == \
            (11 if riv else 23)
        ekw = dict(G=c.G, softening=c.softening, group_size=c.group_size,
                   window_groups=c.window_groups)
        want = stats(
            np.asarray(jbw.eval_accel_sorted(js.lists, js.pos, js.mass,
                                             jnp.float32(dt), **ekw)),
            np.asarray(jref(js.pos, js.mass, c.G, c.softening)))
        got = stats(
            tbw.eval_accel_sorted(ts.lists, ts.pos, ts.mass, dt,
                                  **tbw._eval_kw(c)).numpy(),
            allpairs_accel_reference(ts.pos, ts.mass, c.G,
                                     c.softening).numpy())
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.slow
def test_near_groups_match_jax_at_20k():
    """``chip_smoke.py`` phase 14's protocol at 20K bodies (the default
    config, calibrated, ``near_groups`` 0 and 8): fresh dense lists of one
    warmed state (5 steps at rebuild interval 4), then each configuration's
    own lists aged 23 steps.  The rms and median of |da|/|a| and
    rms|da|/rms|a| against a direct sum equal the JAX package's to 1e-5
    relative, so what near groups do to the per-body rms is the JAX
    function's."""
    import dataclasses
    from spatialsim_tpu.config.nbody import NBodyConfig as JaxConfig
    from spatialsim_tpu.ops.allpairs import allpairs_accel_reference as jref
    from spatialsim_tpu_torch.config.nbody import NBODY, resolve_config
    from spatialsim_tpu_torch.ops.allpairs import allpairs_accel_reference
    n, dt = 20_000, 0.02
    cfg = resolve_config(NBODY.replace(num_bodies=n, engine="window"), n)
    p, v, m = distributions.generate_distribution(
        "galaxy", n, cfg.spawn_radius, cfg.G, seed=0)
    arrays = tuple(np.ascontiguousarray(a, np.float32) for a in (p.T, v.T, m))
    tarr = tuple(torch.from_numpy(a) for a in arrays)
    cal = tbw.calibrate_config(cfg, *tarr)

    def stats(acc, exact):
        e = np.linalg.norm(acc - exact, axis=0)
        a = np.linalg.norm(exact, axis=0)
        r = e / a
        return np.array([np.sqrt((r * r).mean()), np.median(r),
                         np.sqrt((e * e).mean() / (a * a).mean())])

    def jax_cfg(c):
        return JaxConfig(**dataclasses.asdict(c))

    def warmed(c):
        js = jbw.init_window_state(*(jnp.asarray(a) for a in arrays),
                                   jax_cfg(c))
        js = jbw.make_window_step(jax_cfg(c).replace(rebuild_interval=4), n,
                                  5)(js, jnp.float32(dt))
        ts = tbw.init_window_state(*tarr, c)
        ts = tbw.make_window_step(c.replace(rebuild_interval=4), n, 5)(ts, dt)
        return js, ts

    def ekw(c):
        return dict(G=c.G, softening=c.softening, group_size=c.group_size,
                    window_groups=c.window_groups)

    # Fresh lists: both packages build from the JAX package's warmed state.
    js, _ = warmed(cal)
    state = tuple(np.array(a) for a in (js.pos, js.vel, js.mass))
    exact = np.asarray(jref(*(jnp.asarray(a) for a in state[::2]), cal.G,
                            cal.softening))
    fresh = {}
    for K in (0, 8):
        c = cal.replace(near_groups=K)
        kw = dict(tbw._build_kw(c), pool_tile=0)
        jl = jbw.build_lists(*(jnp.asarray(a) for a in state), **kw)
        tl = tbw.build_lists(*(torch.from_numpy(a) for a in state), **kw)
        assert (tl.near is None) == (K == 0)
        want = stats(np.asarray(jbw.eval_accel(
            jl, jnp.asarray(state[0]), jnp.asarray(state[2]),
            jnp.float32(0.0), **ekw(c))), exact)
        got = stats(tbw.eval_accel(tl, torch.from_numpy(state[0]),
                                   torch.from_numpy(state[2]), 0.0,
                                   **tbw._eval_kw(c)).numpy(), exact)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        fresh[K] = got
        print(f"fresh K={K}: rms, median of |da|/|a|, rms|da|/rms|a| "
              f"{got} (JAX {want})")
    # The JAX bar (tests/test_bh_window.py:359): the median does not worsen.
    assert fresh[8][1] <= 1.05 * fresh[0][1] + 1e-5, fresh

    # Each configuration's own lists, aged 23 steps from the warmed state.
    for K in (0, 8):
        c = cal.replace(near_groups=K)
        js, ts = warmed(c)
        js = jbw.make_window_step(jax_cfg(c).replace(rebuild_interval=10 ** 6),
                                  n, 22)(js, jnp.float32(dt))
        ts = tbw.make_window_step(c.replace(rebuild_interval=10 ** 6), n,
                                  22)(ts, dt)
        assert ts.lists.steps_since == int(js.lists.steps_since) == 23
        assert (ts.lists.near is None) == (K == 0)
        want = stats(
            np.asarray(jbw.eval_accel_sorted(js.lists, js.pos, js.mass,
                                             jnp.float32(dt), **ekw(c))),
            np.asarray(jref(js.pos, js.mass, c.G, c.softening)))
        got = stats(
            tbw.eval_accel_sorted(ts.lists, ts.pos, ts.mass, dt,
                                  **tbw._eval_kw(c)).numpy(),
            allpairs_accel_reference(ts.pos, ts.mass, c.G,
                                     c.softening).numpy())
        np.testing.assert_allclose(got, want, rtol=1e-5)
        print(f"K={K} lists 23 steps old: rms, median of |da|/|a|, "
              f"rms|da|/rms|a| {got} (JAX {want})")
