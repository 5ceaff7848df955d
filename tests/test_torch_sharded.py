"""The port's ``parallel/`` on ``torch.distributed``, and kernel 3's
``haloed`` and ``local_slice`` modes, against the JAX package on the CPU.

* the modes' plain versions (row, column and matrix forms) against
  ``pallas_window_eval(haloed=True)`` and ``(local_slice=...)`` in
  interpret mode, on JAX-built dense lists fed to the port through
  ``convert.sharded_window_state_from_numpy``: 1e-4 of max|a| (the
  dense-eval bar of ``test_torch_dense.py``), and the shards' concatenation
  against the unsharded plain version at the same bar (each shard sums its
  own far slots, so the float32 sums run in another grouping);
* ``build_lists_sorted`` over a group range against JAX's: ``far_n`` and
  ``far_range`` equal, ``far`` within 1e-5 of its largest value;
* on 2 and 4 gloo ranks (``parallel.launch.spawn``: one process a rank, a
  ``file://`` rendezvous under ``tmp_path``, every job under a timeout):
  the sample sort equal to JAX's exactly; the ring within
  ``tests/test_sharded.py``'s bar of JAX's ring; the sharded window step
  (drift "off" and "max", 2 substeps a call across a rebuild) within 2e-4
  of JAX's unsharded step; the forced replicated fallback and the moment
  refresh, each against the unsharded dense step; ring and Barnes-Hut
  steps against the unsharded engines; the sharded boids step
  (``second_pass`` on and off, 3 calls of 2 substeps across a re-sort)
  within 2e-4 of the port's unsharded frozen-order step
  (``tests/test_sharded.py``'s bar) and within ``test_torch_boids.py``'s
  1e-3 of JAX's unsharded ``Flock``; the dry run.  Against JAX's own
  sharded window, Barnes-Hut and boids steps only under ``-m slow`` (their
  JAX programs are slow to build, as in ``tests/test_sharded.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spatialsim_tpu.config.boids import BoidsConfig as JaxBoidsConfig
from spatialsim_tpu.config.nbody import NBodyConfig as JaxConfig
from spatialsim_tpu.ops import bh_window as jbw
from spatialsim_tpu.ops.bh_eval_kernel import pallas_window_eval
from spatialsim_tpu.parallel import make_mesh as jax_mesh
from spatialsim_tpu.parallel import ring_allpairs_accel as jax_ring
from spatialsim_tpu.parallel.distsort import (
    sample_sort_local as jax_sample_sort)
from spatialsim_tpu.parallel.mesh import BODY_AXIS
from spatialsim_tpu_torch.config.nbody import NBodyConfig
from spatialsim_tpu_torch.convert import sharded_window_state_from_numpy
from spatialsim_tpu_torch.models.nbody import NBodyState, make_step_fn
from spatialsim_tpu_torch.ops import bh_eval_kernel as tek
from spatialsim_tpu_torch.ops import bh_window as tbw
from spatialsim_tpu_torch.parallel import dryrun, launch, make_mesh

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

TOL = 1e-4              # the dense eval's bar, of max|a|
RANK_TIMEOUT = 240.0    # seconds before a gloo job is killed
GSZ = 64
FORMS = {"row": (tek.window_eval_reference, {}),
         "cols": (tek.window_eval_cols_reference, dict(use_cols=True)),
         "mxu": (tek.window_eval_mxu_reference, dict(use_mxu=True))}
FAR_TILE = 128
# (window_groups, far rows, steps_since): every value of each once.
CASES = [(1, 8, 23), (2, 10, 0)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---------------------------------------------------------------------------
# The modes' plain versions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dense(wg, R):
    """JAX-built dense lists of the 2,048-body galaxy (group 64, cap 256),
    R = 10 with accelerations, and the sorted state."""
    pos, vel, mass = dryrun.galaxy(2048, 3)
    acc = (np.random.default_rng(0).normal(size=(3, 2048)) * 0.1).astype(
        np.float32)
    jl = jbw.build_lists(
        jnp.asarray(pos.numpy()), jnp.asarray(vel.numpy()),
        jnp.asarray(mass.numpy()), jnp.asarray(acc) if R == 10 else None,
        theta=0.8, softening=2.0, skin=2.0, max_depth=7, group_size=GSZ,
        window_groups=wg, list_cap=256, pool_tile=0)
    o = np.asarray(jl.order)
    return jl, pos.numpy()[:, o], vel.numpy()[:, o], mass.numpy()[o]


def _kw(form, wg):
    kw = dict(G=0.1, softening=2.0, group_size=GSZ, window_groups=wg)
    return kw if form == "row" else dict(kw, far_tile=FAR_TILE)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "wg%d-R%d-tau%d" % c)
@pytest.mark.parametrize("form", sorted(FORMS))
def test_modes_match_jax_interpret(form, case):
    wg, R, steps = case
    jl, s_pos, s_vel, s_mass = _dense(wg, R)
    plain, jax_form = FORMS[form]
    kw = _kw(form, wg)
    D = 2
    n, ng = s_pos.shape[1], s_pos.shape[1] // GSZ
    ngl, halo = ng // D, wg * GSZ
    args = (steps, 0.02)
    full = plain(torch.tensor(s_pos), torch.tensor(s_mass), torch.tensor(
        np.asarray(jl.far)), torch.tensor(np.asarray(jl.far_n)), None,
        *args, **kw)
    assert full.shape == (3, n)
    pm = np.pad(np.concatenate([s_pos, s_mass[None]]), ((0, 0),
                                                        (halo, halo)))
    haloed, sliced = [], []
    for r in range(D):
        st = sharded_window_state_from_numpy(
            s_pos, s_vel, s_mass, jl.order, jl.inv_order, jl.far, jl.far_n,
            jl.far_range, s_pos, rank=r, world_size=D)
        lists = st.lists
        assert lists.far.shape[0] == ngl and st.pos.shape == (3, n // D)
        # The haloed source as the sharded step slices it.
        src = pm[:, r * ngl * GSZ:r * ngl * GSZ + n // D + 2 * halo]
        got = plain(torch.tensor(src[:3]), torch.tensor(src[3]), lists.far,
                    lists.far_n, None, *args, haloed=True, **kw)
        assert got.shape == (3, n // D)
        # JAX on one shard a mode (interpret mode runs slowly): the haloed
        # shard 0 has a zero halo on its left and a real one on its right.
        if r == 0:
            want = pallas_window_eval(
                jnp.asarray(src[:3]), jnp.asarray(src[3]),
                jnp.asarray(lists.far.numpy()),
                jnp.asarray(lists.far_n.numpy()), None, *args, haloed=True,
                **jax_form, **kw)
            assert _rel(got, want) <= TOL, ("haloed", r)
        haloed.append(got)
        got = plain(torch.tensor(s_pos), torch.tensor(s_mass), lists.far,
                    lists.far_n, None, *args, local_slice=(r * ngl, ngl),
                    **kw)
        if r == 1:
            want = pallas_window_eval(
                jnp.asarray(s_pos), jnp.asarray(s_mass),
                jnp.asarray(lists.far.numpy()),
                jnp.asarray(lists.far_n.numpy()), None, *args,
                local_slice=(r * ngl, ngl), **jax_form, **kw)
            assert _rel(got, want) <= TOL, ("local_slice", r)
        sliced.append(got)
    assert _rel(torch.cat(haloed, 1), full) <= TOL
    assert _rel(torch.cat(sliced, 1), full) <= TOL


def test_modes_refuse_near_groups_and_bad_ranges():
    s_pos, s_mass = torch.zeros(3, 4 * GSZ), torch.zeros(4 * GSZ)
    far, far_n = torch.zeros(2, 8, 8), torch.zeros(2, dtype=torch.int32)
    kw = dict(G=0.1, softening=2.0, group_size=GSZ, window_groups=1)
    near = torch.zeros(2, 3, dtype=torch.int32)
    for mode in (dict(haloed=True), dict(local_slice=(1, 2))):
        with pytest.raises(ValueError, match="near groups"):
            tek.window_eval(s_pos, s_mass, far, far_n, near, **mode, **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tek.window_eval_reference(s_pos, s_mass, far, far_n, haloed=True,
                                  local_slice=(0, 2), **kw)
    with pytest.raises(ValueError, match="do not lie"):
        tek.window_eval_reference(s_pos, s_mass, far, far_n,
                                  local_slice=(3, 2), **kw)
    assert tek.eval_mode(4 * GSZ, GSZ, 1, haloed=True) == (1, 2, 4)
    assert tek.eval_mode(4 * GSZ, GSZ, 1, local_slice=(2, 2)) == (2, 2, 4)
    assert tek.eval_mode(4 * GSZ, GSZ, 1) == (0, 4, 4)


# ---------------------------------------------------------------------------
# The sorted-state build over a group range
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 8, 24])
def test_build_lists_sorted_range_matches_jax(offset):
    jl, s_pos, s_vel, s_mass = _dense(2, 10)
    n = s_pos.shape[1]
    acc = (np.random.default_rng(5).normal(size=(3, n)) * 0.1).astype(
        np.float32)
    kw = dict(theta=0.8, softening=2.0, skin=2.0, max_depth=7,
              group_size=GSZ, window_groups=2, list_cap=256,
              group_offset=offset, n_groups=8)
    order = np.arange(n, dtype=np.int32)[::-1].copy()
    want = jbw.build_lists_sorted(
        jnp.asarray(s_pos), jnp.asarray(s_vel), jnp.asarray(s_mass),
        jnp.asarray(acc), order=jnp.asarray(order), **kw)
    got = tbw.build_lists_sorted(
        torch.tensor(s_pos), torch.tensor(s_vel), torch.tensor(s_mass),
        torch.tensor(acc), order=torch.tensor(order), **kw)
    for f in ("far_n", "far_range", "order", "inv_order"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    jf = np.asarray(want.far)
    assert got.far.shape == jf.shape == (8, 10, 256)
    np.testing.assert_allclose(got.far.numpy(), jf, rtol=1e-5,
                               atol=1e-5 * np.abs(jf).max())


# ---------------------------------------------------------------------------
# Gloo ranks
# ---------------------------------------------------------------------------

N_WIN = 1024
N_BOIDS = 4096


def _window_cfg(cls, drift="off", **kw):
    """``tests/test_sharded.py``'s window configuration (the JAX or the
    port's config class)."""
    base = dict(num_bodies=N_WIN, theta=0.8, G=0.1, softening=2.0,
                max_depth=7, group_size=GSZ, list_capacity=512,
                window_groups=2, skin=4.0 if drift == "off" else 0.5,
                rebuild_interval=3, rebuild_drift_mode=drift)
    return cls(**dict(base, **kw))


REFRESH = dict(rebuild_interval=6, refresh_interval=2)
STEP_CFG = dict(theta=0.8, G=0.1, softening=2.0, damping=1.0, max_depth=7,
                group_size=GSZ, frontier_capacity=512, near_capacity=2048,
                leaf_size=8)


def _codes(dist, n=2048):
    rng = np.random.default_rng(3)
    if dist == "uniform":
        codes = rng.integers(0, 1 << 30, n)
    else:   # most codes in a narrow band: splitters and rebalance
        codes = np.where(rng.random(n) < 0.8, rng.integers(1000, 3000, n),
                         rng.integers(0, 1 << 30, n))
    rows_f = rng.normal(size=(4, n)).astype(np.float32)
    rows_i = np.stack([np.arange(n), rng.integers(0, 99, n)]).astype(
        np.int32)
    return codes.astype(np.int32), rows_f, rows_i


def _calls():
    pos, vel, mass = dryrun.galaxy(N_WIN, 4)
    rpos, rvel, rmass = dryrun.galaxy(N_WIN, 11)
    spos, svel, smass = dryrun.galaxy(N_WIN, 4)
    calls = {}
    for dist in ("uniform", "clustered"):
        calls[f"sort-{dist}"] = (dryrun.sample_sort, tuple(
            torch.tensor(a) for a in _codes(dist)), {})
    calls["ring"] = (dryrun.ring_accel, (pos, mass, 0.1, 2.0), {})
    for drift in ("off", "max"):
        calls[f"window-{drift}"] = (
            dryrun.window_steps,
            (_window_cfg(NBodyConfig, drift), pos, vel, mass),
            dict(substeps=2, calls=3))
    calls["fallback"] = (dryrun.window_steps,
                         (_window_cfg(NBodyConfig), pos, vel, mass),
                         dict(substeps=2, calls=3, cap_factor=1e-9))
    calls["refresh"] = (dryrun.window_steps,
                        (_window_cfg(NBodyConfig, **REFRESH), rpos, rvel,
                         rmass), dict(substeps=2, calls=4))
    for engine in ("allpairs", "barnes_hut"):
        calls[f"step-{engine}"] = (
            dryrun.sharded_steps, (NBodyConfig(**STEP_CFG), spos, svel,
                                   smass),
            dict(engine=engine, substeps=2, dt=0.05))
    for sp in (True, False):
        bcfg = dryrun.boids_config(N_BOIDS, second_pass=sp)
        calls[f"boids-{sp}"] = (dryrun.boids_steps,
                                (bcfg,) + dryrun.flock_state(bcfg, 7),
                                dict(substeps=2, calls=3))
    calls["dryrun"] = (dryrun.run, (), {})
    return calls


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every gloo job, run once per world size in one start of the ranks:
    ``ranks(D)[name]`` is the list of the D ranks' results."""
    cache = {}

    def get(D):
        if D not in cache:
            calls = _calls()
            out = launch.spawn(
                launch.sequence, D, tuple(calls.values()),
                workdir=tmp_path_factory.mktemp(f"ranks{D}"),
                timeout=RANK_TIMEOUT)
            cache[D] = {name: [r[i] for r in out]
                        for i, name in enumerate(calls)}
        return cache[D]
    return get


@functools.lru_cache(maxsize=None)
def _jax_sort_fn(D):
    mesh = jax_mesh(D)
    fn = jax.jit(shard_map(
        functools.partial(jax_sample_sort, axis=BODY_AXIS, ndev=D),
        mesh=mesh,
        in_specs=(P(BODY_AXIS), P(None, BODY_AXIS), P(None, BODY_AXIS)),
        out_specs=(P(BODY_AXIS), P(None, BODY_AXIS), P(None, BODY_AXIS),
                   P())))
    return mesh, fn


def _jax_sort(codes, rows_f, rows_i, D):
    mesh, fn = _jax_sort_fn(D)

    def put(a, spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
    return fn(put(codes, P(BODY_AXIS)), put(rows_f, P(None, BODY_AXIS)),
              put(rows_i, P(None, BODY_AXIS)))


@pytest.mark.parametrize("dist", ["uniform", "clustered"])
@pytest.mark.parametrize("D", [2, 4])
def test_sample_sort_equals_jax(ranks, D, dist):
    got = ranks(D)[f"sort-{dist}"]
    codes, rows_f, rows_i = _codes(dist)
    want = _jax_sort(codes, rows_f, rows_i, D)
    assert all(r[3] for r in got) and bool(want[3])
    for k in range(3):
        np.testing.assert_array_equal(
            torch.cat([r[k] for r in got], -1).numpy(), np.asarray(want[k]))
    # The sorted order itself: the codes of a stable global sort.
    np.testing.assert_array_equal(np.asarray(want[0]),
                                  np.sort(codes, kind="stable"))


@pytest.mark.parametrize("D", [2, 4])
def test_ring_matches_jax(ranks, D):
    pos, _, mass = dryrun.galaxy(N_WIN, 4)
    got = torch.cat(ranks(D)["ring"], 1).numpy()
    want = jax_ring(jnp.asarray(pos.numpy()), jnp.asarray(mass.numpy()),
                    jax_mesh(D), 0.1, 2.0)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-5)


def _original(results):
    """Whole original-order (pos, vel) from the ranks' sorted shards."""
    inv = results[0]["inv_order"].long()
    pos = torch.cat([r["pos"] for r in results], 1)
    vel = torch.cat([r["vel"] for r in results], 1)
    return pos[:, inv].numpy(), vel[:, inv].numpy()


@functools.lru_cache(maxsize=None)
def _jax_window(drift):
    """JAX's unsharded window step: 3 calls of 2 substeps (one rebuild);
    original-order pos and vel."""
    pos, vel, mass = dryrun.galaxy(N_WIN, 4)
    cfg = _window_cfg(JaxConfig, drift)
    step = jbw.make_window_step(cfg, N_WIN, substeps=2)
    st = jbw.init_window_state(jnp.asarray(pos.numpy()),
                               jnp.asarray(vel.numpy()),
                               jnp.asarray(mass.numpy()), cfg)
    for _ in range(3):
        st = step(st, jnp.float32(0.02))
    inv = np.asarray(st.lists.inv_order)
    return np.asarray(st.pos)[:, inv], np.asarray(st.vel)[:, inv]


@pytest.mark.parametrize("drift", ["off", "max"])
@pytest.mark.parametrize("D", [2, 4])
def test_window_step_matches_jax_unsharded(ranks, D, drift):
    res = ranks(D)[f"window-{drift}"]
    assert [r["rebuilds"] for r in res] == [1] * D
    # At 2 ranks the sample sort's bins hold the rebuild; at 4 a rank's
    # bin to itself (most of an already sorted shard) outgrows the JAX
    # package's capacity, 2 nl / D, and the rebuild falls back, as there.
    assert [r["fallbacks"] for r in res] == [int(D > 2)] * D
    pos, vel = _original(res)
    jpos, jvel = _jax_window(drift)
    np.testing.assert_allclose(pos, jpos, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(vel, jvel, rtol=2e-4, atol=2e-4)


def _unsharded_window(cfg, seed, calls):
    pos, vel, mass = dryrun.galaxy(N_WIN, seed)
    cfg = cfg.replace(pool_tile=0)
    step = tbw.make_window_step(cfg, N_WIN, substeps=2)
    st = tbw.init_window_state(pos, vel, mass, cfg)
    for _ in range(calls):
        st = step(st, 0.02)
    inv = st.lists.inv_order.long()
    return st.pos[:, inv].numpy(), st.vel[:, inv].numpy(), step


@pytest.mark.parametrize("D", [2, 4])
def test_replicated_fallback_matches_unsharded(ranks, D):
    """A bin capacity that overflows every bin sends the rebuild to the
    replicated sort on every rank; the trajectory is the same."""
    res = ranks(D)["fallback"]
    assert [r["fallbacks"] for r in res] == [1] * D
    pos, vel = _original(res)
    upos, uvel, _ = _unsharded_window(_window_cfg(NBodyConfig), 4, 3)
    np.testing.assert_allclose(pos, upos, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(vel, uvel, rtol=2e-4, atol=2e-4)
    jpos, _ = _jax_window("off")
    np.testing.assert_allclose(pos, jpos, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("D", [2, 4])
def test_refresh_matches_unsharded(ranks, D):
    """Refreshes at substeps 2 and 4, the rebuild at 6, over 8 substeps:
    each rank refreshes its entries from the gathered state."""
    res = ranks(D)["refresh"]
    upos, uvel, ustep = _unsharded_window(
        _window_cfg(NBodyConfig, **REFRESH), 11, 4)
    assert ustep.refreshes == 2 and ustep.rebuilds == 1
    assert [(r["refreshes"], r["rebuilds"]) for r in res] == [(2, 1)] * D
    pos, vel = _original(res)
    np.testing.assert_allclose(pos, upos, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(vel, uvel, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("engine", ["allpairs", "barnes_hut"])
@pytest.mark.parametrize("D", [2, 4])
def test_sharded_step_matches_unsharded(ranks, D, engine):
    pos, vel, mass = dryrun.galaxy(N_WIN, 4)
    step = make_step_fn(NBodyConfig(**STEP_CFG), N_WIN, substeps=2,
                        engine="allpairs" if engine == "allpairs"
                        else "exact")
    want = step(NBodyState(pos, vel, mass), 0.05)
    got = ranks(D)[f"step-{engine}"]
    for f in ("pos", "vel"):
        np.testing.assert_allclose(
            torch.cat([getattr(r, f) for r in got], 1).numpy(),
            getattr(want, f).numpy(), rtol=2e-4, atol=2e-4, err_msg=f)


@pytest.mark.slow
@pytest.mark.parametrize("D", [2, 4])
def test_window_step_matches_jax_sharded(ranks, D):
    """Against JAX's own sharded window step on D virtual devices (its
    program is slow to build, as in ``tests/test_sharded.py``)."""
    from spatialsim_tpu.parallel.sharded import make_sharded_window_step
    pos, vel, mass = (jnp.asarray(a.numpy()) for a in dryrun.galaxy(N_WIN,
                                                                     4))
    step, init = make_sharded_window_step(_window_cfg(JaxConfig), N_WIN,
                                          jax_mesh(D), substeps=2)
    st = init(pos, vel, mass)
    for _ in range(3):
        st = step(st, jnp.float32(0.02))
    inv = np.asarray(st.lists.inv_order)
    got_pos, got_vel = _original(ranks(D)["window-off"])
    np.testing.assert_allclose(got_pos, np.asarray(st.pos)[:, inv],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_vel, np.asarray(st.vel)[:, inv],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.slow
@pytest.mark.parametrize("D", [2, 4])
def test_sharded_barnes_hut_step_matches_jax_sharded(ranks, D):
    """The sharded Barnes-Hut step against JAX's on D virtual devices."""
    from spatialsim_tpu.models.nbody import NBodyState as JaxState
    from spatialsim_tpu.parallel import make_sharded_step, shard_state
    mesh = jax_mesh(D)
    pos, vel, mass = (jnp.asarray(a.numpy()) for a in dryrun.galaxy(N_WIN,
                                                                     4))
    step = make_sharded_step(JaxConfig(**STEP_CFG), N_WIN, mesh, substeps=2,
                             engine="barnes_hut")
    want = step(shard_state(JaxState(pos, vel, mass), mesh),
                jnp.float32(0.05))
    got = ranks(D)["step-barnes_hut"]
    for f in ("pos", "vel"):
        np.testing.assert_allclose(
            torch.cat([getattr(r, f) for r in got], 1).numpy(),
            np.asarray(getattr(want, f)), rtol=2e-4, atol=2e-4, err_msg=f)


def _boids_original(results):
    """Whole original-order (pos, vel, col) from the ranks' sorted
    shards."""
    inv = results[0]["inv1"]
    return [torch.cat([r[f] for r in results], 1)[:, inv].numpy()
            for f in ("pos", "vel", "col")]


@pytest.mark.parametrize("second_pass", [True, False])
@pytest.mark.parametrize("D", [2, 4])
def test_sharded_boids_matches_unsharded(ranks, D, second_pass):
    """``tests/test_sharded.py``'s case (4,096 boids, group 64, windows 2
    then 1, a re-sort every 3 substeps; 6 substeps) against the port's
    unsharded frozen-order step at 2e-4, and against JAX's unsharded
    ``Flock`` at ``test_torch_boids.py``'s 1e-3 (the two sum the same
    pairs in another order)."""
    from spatialsim_tpu.models.boids import Flock as JaxFlock
    from spatialsim_tpu.models.boids import make_step_fn as jax_step_fn
    from spatialsim_tpu_torch.models.boids import (
        init_boids_window_state, make_step_fn as boids_step_fn)
    res = ranks(D)[f"boids-{second_pass}"]
    assert [r["resorts"] for r in res] == [1] * D
    got = _boids_original(res)
    cfg = dryrun.boids_config(N_BOIDS, second_pass=second_pass)
    ustep = boids_step_fn(cfg, substeps=2)
    ust = init_boids_window_state(*dryrun.flock_state(cfg, 7), cfg)
    jcfg = JaxBoidsConfig(**{k: getattr(cfg, k) for k in (
        "num_boids", "neighbor_mode", "group_size", "window_groups",
        "pass2_window_groups", "second_pass", "resort_interval")})
    jstep = jax_step_fn(jcfg, substeps=2)
    jst = JaxFlock(config=jcfg, seed=7).state
    for _ in range(3):
        ust = ustep(ust, 1 / 30)
        jst = jstep(jst, jnp.float32(1 / 30))
    assert ustep.resorts == 1
    jinv = np.asarray(jst.inv1)
    for g, f in zip(got, ("pos", "vel", "col")):
        np.testing.assert_allclose(
            g, getattr(ust, f)[:, ust.inv1].numpy(), rtol=2e-4, atol=2e-4,
            err_msg=f)
        np.testing.assert_allclose(g, np.asarray(getattr(jst, f))[:, jinv],
                                   rtol=0, atol=1e-3, err_msg=f)


@pytest.mark.slow
@pytest.mark.parametrize("second_pass", [True, False])
@pytest.mark.parametrize("D", [2, 4])
def test_sharded_boids_matches_jax_sharded(ranks, D, second_pass):
    """Against JAX's own sharded boids step on D virtual devices."""
    from spatialsim_tpu.parallel.sharded import make_sharded_boids_step
    cfg = dryrun.boids_config(N_BOIDS, second_pass=second_pass)
    jcfg = JaxBoidsConfig(**{k: getattr(cfg, k) for k in (
        "num_boids", "neighbor_mode", "group_size", "window_groups",
        "pass2_window_groups", "second_pass", "resort_interval")})
    step, init = make_sharded_boids_step(jcfg, N_BOIDS, jax_mesh(D),
                                         substeps=2)
    st = init(*(jnp.asarray(a.numpy())
                for a in dryrun.flock_state(cfg, 7)))
    for _ in range(3):
        st = step(st, jnp.float32(1 / 30))
    inv = np.asarray(st.inv1)
    got = _boids_original(ranks(D)[f"boids-{second_pass}"])
    for g, f in zip(got, ("pos", "vel", "col")):
        np.testing.assert_allclose(g, np.asarray(getattr(st, f))[:, inv],
                                   rtol=0, atol=1e-3, err_msg=f)


@pytest.mark.parametrize("D", [2, 4])
def test_dryrun_on_gloo_ranks(ranks, D):
    assert ranks(D)["dryrun"] == [
        f"dryrun({D} ranks, cpu) OK: ring all-pairs + sharded Barnes-Hut "
        f"+ sharded window engine + sharded boids, {128 * D} bodies"] * D


def test_make_mesh_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(device=device)


def test_world_size_one_on_the_cpu(monkeypatch):
    """Without torchrun's variables the group has one rank; the
    collectives are then identities and the shifts bring zeros."""
    from spatialsim_tpu_torch.parallel import collectives as col
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    mesh = make_mesh(device="cpu")
    try:
        assert (mesh.rank, mesh.size) == (0, 1)
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(col.all_gather(x, mesh, axis=1), x)
        assert torch.equal(col.all_to_all(x, mesh), x)
        assert torch.equal(col.pmax(x, mesh), x)
        assert torch.equal(col.ring_shift(x, mesh), x)
        assert torch.equal(col.shift([x], mesh, +1)[0], torch.zeros_like(x))
        with pytest.raises(ValueError, match="requested 2 devices"):
            make_mesh(2, device="cpu")
    finally:
        torch.distributed.destroy_process_group()
