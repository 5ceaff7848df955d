"""The PyTorch port's boids flock against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds and go through both packages;
JAX runs on the CPU with the Pallas kernel in interpret mode where it is
asked for, as the JAX package's own tests run it.  Tolerances:

* cell coordinates, Morton codes and the frozen build orders: exactly
  equal (stable sorts on both sides);
* the window accumulators of one pass: rtol = atol = 2e-4, the JAX
  package's own bar for its kernel against its XLA form;
* forces (window, frozen-window, grid): max|d| <= 1e-4 max|f|, with the
  neighbour counts exactly equal.  Steering normalizes each accumulator,
  so a boid whose separation sum nearly cancels turns a last-digit
  difference of summation order into ~1e-3 on a component of a force of
  ~20; measured against the largest force that is ~1e-5;
* colour targets: rtol = atol = 1e-4;
* one physics update: 1e-6;
* whole flocks over several steps: see each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu.config.boids import BoidsConfig as JaxBoidsConfig
from spatialsim_tpu.ops import boids_ops as jbo
from spatialsim_tpu_torch.config.boids import BoidsConfig
from spatialsim_tpu_torch.ops import boids_ops as tbo


def _t(a):
    return torch.tensor(np.asarray(a))


def _state(n, seed, bounds, speed=10.0):
    rng = np.random.default_rng(seed)
    pos = ((rng.random((3, n)) - 0.5) * 2 * bounds).astype(np.float32)
    vel = ((rng.random((3, n)) - 0.5) * speed).astype(np.float32)
    col = rng.random((3, n)).astype(np.float32)
    return pos, vel, col


def _grid_kw(cfg):
    return dict(cell_size=cfg.cell_size, grid_dim=cfg.grid_dim,
                offset=cfg.bounds + cfg.cell_size)


def _force_kw(cfg):
    return dict(perception_radius=cfg.perception_radius,
                separation_radius=cfg.separation_radius,
                separation_weight=cfg.separation_weight,
                alignment_weight=cfg.alignment_weight,
                cohesion_weight=cfg.cohesion_weight,
                max_speed=cfg.max_speed, max_force=cfg.max_force)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _close_to_max(got, want, tol):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_codes_and_orders_equal_jax_exactly():
    # bounds 30: 4096 boids in a 14^3 grid, so many share a cell and code.
    n = 4096
    cfg = BoidsConfig(num_boids=n, bounds=30.0)
    pos, _, _ = _state(n, 0, cfg.bounds)
    kw = _grid_kw(cfg)
    np.testing.assert_array_equal(
        tbo.cell_coords(_t(pos), **kw).numpy(),
        np.asarray(jbo.cell_coords(jnp.asarray(pos), **kw)))
    np.testing.assert_array_equal(
        tbo.cell_index(_t(pos), **kw).numpy(),
        np.asarray(jbo.cell_index(jnp.asarray(pos), **kw)))
    for second in (False, True):
        want = np.asarray(jbo.boids_codes(jnp.asarray(pos), second=second,
                                          **kw))
        assert len(np.unique(want)) < n // 2           # heavy sharing
        np.testing.assert_array_equal(
            tbo.boids_codes(_t(pos), second=second, **kw).numpy(), want)
    for gsz in (128, 100):                              # 100: ragged npad
        want = jbo.build_boids_orders(jnp.asarray(pos), group_size=gsz, **kw)
        got = tbo.build_boids_orders(_t(pos), group_size=gsz, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_rows(outs, pos):
    """The JAX accumulator tuple as the port's (14, npad) rows.  The JAX
    package sums neighbour positions, the port their offsets from the
    target: sum (p_s - p_t) = sum p_s - count * p_t (taken in float64)."""
    n = pos.shape[1]
    sep, sc, al, coh, cs, nc = (np.asarray(a) for a in outs)

    def rows3(a):
        return np.moveaxis(a, 1, 0).reshape(3, n)
    count = nc.reshape(1, n).astype(np.float64)
    offsets = rows3(coh).astype(np.float64) - count * pos
    return np.concatenate(
        [rows3(sep), rows3(al), offsets.astype(np.float32), rows3(cs),
         sc.reshape(1, n).astype(np.float32), count.astype(np.float32)])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dedup", [False, True])
def test_window_accumulate_reference_matches_jax(use_pallas, dedup):
    n, gsz, wg = 1024, 64, 2
    pos, vel, col = _state(n, 11, 60.0)
    grp = np.random.default_rng(12).integers(0, n // gsz, n).astype(
        np.float32)
    prev = 2 if dedup else None
    jgrp = jnp.asarray(grp)[None, :] if dedup else None
    want = _jax_rows(jbo._window_accumulate(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(col), jgrp,
        gsz=gsz, wg=wg, perception_sq=jnp.float32(25.0 ** 2),
        separation_sq=jnp.float32(10.0 ** 2), prev_wg=prev,
        use_pallas=use_pallas), pos)
    got = tbo.window_accumulate_reference(
        _t(pos), _t(vel), _t(col), _t(grp) if dedup else None, gsz=gsz,
        wg=wg, perception_sq=25.0 ** 2, separation_sq=10.0 ** 2,
        prev_wg=prev)
    assert want[13].sum() > 5 * n           # dense enough to mean something
    _close(got.numpy(), want, 2e-4)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    from spatialsim_tpu_torch.ops.boids_window_kernel import (
        boids_window_accumulate)
    n, gsz = 640, 64
    pos, vel, col = _state(n, 3, 40.0)
    pos[:, 600:] = 1e9                                   # padding slots
    grp = np.arange(n, dtype=np.float32)[::-1] // gsz
    kw = dict(gsz=gsz, wg=1, perception_sq=64.0, separation_sq=9.0,
              prev_wg=0)
    before = boids_window_accumulate.launches
    got = boids_window_accumulate(_t(pos), _t(vel), _t(col), _t(grp), **kw)
    want = tbo.window_accumulate_reference(_t(pos), _t(vel), _t(col),
                                           _t(grp), **kw)
    assert boids_window_accumulate.launches == before
    assert torch.equal(got, want)
    assert float(got[13, 600:].abs().max()) == 0.0       # pads never pair


def test_window_forces_match_jax():
    n = 6000
    cfg = BoidsConfig(num_boids=n)
    pos, vel, col = _state(n, 0, 60.0, speed=cfg.max_speed)
    kw = dict(group_size=128, window_groups=2, pass2_window_groups=1,
              return_counts=True, **_grid_kw(cfg), **_force_kw(cfg))
    jf, jc, jn = jbo.flocking_forces_window(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(col), **kw)
    tf, tc, tn = tbo.flocking_forces_window(_t(pos), _t(vel), _t(col), **kw)
    assert int(np.asarray(jn).sum()) > n
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _close_to_max(tf.numpy(), jf, 1e-4)
    _close(tc.numpy(), jc, 1e-4)


def test_frozen_window_forces_match_jax():
    from spatialsim_tpu.models.boids import init_boids_window_state
    n = 4096
    cfg = JaxBoidsConfig(num_boids=n, neighbor_mode="window", group_size=128)
    pos, vel, col = _state(n, 5, 60.0, speed=cfg.max_speed)
    st = init_boids_window_state(jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(col), cfg)
    kw = dict(group_size=128, window_groups=2,
              pass2_window_groups=cfg.pass2_window_groups,
              return_counts=True, **_force_kw(cfg))
    jf, jc, jn = jbo.flocking_forces_window_frozen(
        st.pos, st.vel, st.col, st.p21, st.s21, **kw)
    tf, tc, tn = tbo.flocking_forces_window_frozen(
        _t(np.asarray(st.pos)), _t(np.asarray(st.vel)),
        _t(np.asarray(st.col)), _t(np.asarray(st.p21)).long(),
        _t(np.asarray(st.s21)).long(), **kw)
    assert int(np.asarray(jn).sum()) > n
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _close_to_max(tf.numpy(), jf, 1e-4)
    _close(tc.numpy(), jc, 1e-4)


def test_grid_forces_match_jax():
    n = 6000
    cfg = BoidsConfig(num_boids=n)
    pos, vel, col = _state(n, 0, 60.0, speed=cfg.max_speed)
    kw = dict(cell_range=1, cell_capacity=32, **_grid_kw(cfg),
              **_force_kw(cfg))
    jf, jc = jbo.flocking_forces(jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(col), **kw)
    tf, tc = tbo.flocking_forces(_t(pos), _t(vel), _t(col), **kw)
    assert float(np.abs(np.asarray(jf)).max()) > 1.0
    _close_to_max(tf.numpy(), jf, 1e-4)
    _close(tc.numpy(), jc, 1e-4)


def test_boids_physics_matches_jax():
    n = 3000
    cfg = BoidsConfig(num_boids=n)
    rng = np.random.default_rng(7)
    pos, vel, col = _state(n, 7, cfg.bounds, speed=3 * cfg.max_speed)
    force = (rng.standard_normal((3, n)) * 50).astype(np.float32)
    avg = rng.random((3, n)).astype(np.float32)
    kw = dict(bounds=cfg.bounds, margin=cfg.wall_margin,
              wall_force=cfg.max_force * cfg.wall_weight,
              max_speed=cfg.max_speed, color_blend=0.5)
    want = jbo.boids_physics(*(jnp.asarray(a) for a in
                               (pos, vel, col, force, avg)),
                             dt=jnp.float32(1 / 30), **kw)
    got = tbo.boids_physics(*(_t(a) for a in (pos, vel, col, force, avg)),
                            dt=float(np.float32(1 / 30)), **kw)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-6)


def _flocks(cfg_kw, seed=0):
    from spatialsim_tpu.models.boids import Flock as JaxFlock
    from spatialsim_tpu_torch.models.boids import Flock
    return (JaxFlock(config=JaxBoidsConfig(**cfg_kw), seed=seed),
            Flock(config=BoidsConfig(**cfg_kw), seed=seed, device="cpu"))


def test_window_flock_matches_jax_across_resorts():
    jf, tf = _flocks(dict(num_boids=4096, neighbor_mode="window",
                          group_size=128))
    assert tf.neighbor_mode == jf.neighbor_mode == "window"
    for name in ("order1", "inv1", "p21", "s21"):
        np.testing.assert_array_equal(
            getattr(tf.state, name).numpy(),
            np.asarray(getattr(jf.state, name)))
    np.testing.assert_array_equal(tf.get_positions(), jf.get_positions())
    np.testing.assert_array_equal(tf.get_colors(), jf.get_colors())
    for _ in range(13):                # re-sorts before steps 7 and 13
        jf.update(1 / 30)
        tf.update(1 / 30)
    assert tf.resorts == 2 and tf.state.steps_since == int(
        jf.state.steps_since) == 1
    # 1e-3 absolute (positions span +-500, where one f32 ulp is 3e-5;
    # speeds 25): the two sum the same pairs in another order, which
    # compounds over 13 steps (measured 2e-4); a pair that flipped on a
    # radius would move a boid by far more.
    for get in ("get_positions", "get_velocities", "get_colors"):
        np.testing.assert_allclose(getattr(tf, get)(), getattr(jf, get)(),
                                   rtol=0, atol=1e-3)


def test_grid_flock_matches_jax():
    jf, tf = _flocks(dict(num_boids=1000), seed=3)
    assert tf.neighbor_mode == jf.neighbor_mode == "grid"
    for _ in range(5):
        jf.update(1 / 30)
        tf.update(1 / 30)
    assert tf.resorts == 0
    # Same pairs, same force law; sums in another order over 5 steps
    # (measured 7e-5 on velocities of 25), bounded as above.
    for get in ("get_positions", "get_velocities", "get_colors"):
        np.testing.assert_allclose(getattr(tf, get)(), getattr(jf, get)(),
                                   rtol=0, atol=1e-3)


def test_port_steps_a_jax_built_boids_state():
    from spatialsim_tpu.models.boids import (init_boids_window_state,
                                             make_step_fn as jax_step_fn)
    from spatialsim_tpu_torch.convert import boids_window_state_from_numpy
    from spatialsim_tpu_torch.models.boids import make_step_fn
    n = 3000
    cfg_kw = dict(num_boids=n, neighbor_mode="window", group_size=128,
                  resort_interval=3)
    pos, vel, col = _state(n, 9, 60.0, speed=25.0)
    js = init_boids_window_state(jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(col), JaxBoidsConfig(**cfg_kw))
    ts = boids_window_state_from_numpy(*js)
    assert ts.order1.dtype == torch.int64 and ts.steps_since == 0
    jstep = jax_step_fn(JaxBoidsConfig(**cfg_kw))
    tstep = make_step_fn(BoidsConfig(**cfg_kw))
    for _ in range(4):                 # one re-sort, before step 4
        js = jstep(js, jnp.float32(1 / 30))
        ts = tstep(ts, 1 / 30)
    assert tstep.resorts == 1
    np.testing.assert_array_equal(ts.order1.numpy(), np.asarray(js.order1))
    for name in ("pos", "vel", "col"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=0, atol=1e-4)


def test_flock_cuda_without_card_raises():
    from spatialsim_tpu_torch.models.boids import Flock
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    with pytest.raises(RuntimeError, match="cuda"):
        Flock(num_boids=100, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Flock(num_boids=100)                     # the default device
