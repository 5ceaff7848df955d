"""The PyTorch port's N-body main path as a whole, on the CPU.

* the window step across one rebuild against the JAX ``make_window_step``
  (Pallas pooled eval in interpret mode): max|d| / max|x| <= 1e-4 on the
  sorted positions and velocities, after the permutations agree exactly;
* ``NBodySimulation`` getters in original body order, and the all-pairs
  engine against the JAX model;
* the recorder CLI, decoded with ``spatialsim_tpu.io.codec``;
* the port imports neither jax nor the JAX package; ``device="cuda"``
  without a card raises instead of falling back.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu import distributions
from spatialsim_tpu.config.nbody import NBodyConfig
from spatialsim_tpu.io import codec, session

ROOT = Path(__file__).resolve().parents[1]


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


N_STEP = 8000   # ragged: 63 groups of 128, the last one padded
STEP_CFG = NBodyConfig(num_bodies=N_STEP, theta=0.8, G=0.1, softening=2.0,
                       engine="window", max_depth=7, group_size=128,
                       list_capacity=512, window_groups=2, skin=2.0,
                       rebuild_interval=4, rebuild_drift_mode="off",
                       pool_tile=128)


def _step_bodies():
    p, v, m = distributions.generate_distribution("galaxy", N_STEP, 200.0,
                                                  0.1, seed=3)
    return tuple(np.ascontiguousarray(a, np.float32) for a in (p.T, v.T, m))


def test_window_step_across_rebuild_matches_jax():
    from spatialsim_tpu.ops import bh_window as jbw
    from spatialsim_tpu_torch.ops import bh_window as tbw
    n, cfg = N_STEP, STEP_CFG
    pos, vel, mass = _step_bodies()
    dt = 0.02
    js = jbw.init_window_state(jnp.asarray(pos), jnp.asarray(vel),
                               jnp.asarray(mass), cfg)
    jstep = jbw.make_window_step(cfg, n, 1)
    ts = tbw.init_window_state(torch.from_numpy(pos), torch.from_numpy(vel),
                               torch.from_numpy(mass), cfg)
    tstep = tbw.make_window_step(cfg, n, 1)
    for _ in range(6):
        js = jstep(js, jnp.float32(dt))
        ts = tstep(ts, dt)
    assert tstep.rebuilds == 1
    assert ts.lists.steps_build == int(js.lists.steps_build) == 2
    np.testing.assert_array_equal(ts.lists.order.numpy(),
                                  np.asarray(js.lists.order))
    np.testing.assert_array_equal(ts.lists.inv_order.numpy(),
                                  np.asarray(js.lists.inv_order))
    assert _rel(ts.pos.numpy(), np.asarray(js.pos)) <= 1e-4
    assert _rel(ts.vel.numpy(), np.asarray(js.vel)) <= 1e-4
    # ref_pos is its own tensor (nothing may alias the live positions).
    assert ts.lists.ref_pos.data_ptr() != ts.pos.data_ptr()


def test_port_steps_a_jax_built_state():
    """JAX-built lists and sorted state, carried over by convert.py, step
    in the port as they step in JAX (eval parity apart from the build)."""
    from spatialsim_tpu.ops import bh_window as jbw
    from spatialsim_tpu_torch.convert import (lists_from_numpy,
                                              window_state_from_numpy)
    from spatialsim_tpu_torch.ops import bh_window as tbw
    js = jbw.init_window_state(*(jnp.asarray(a) for a in _step_bodies()),
                               STEP_CFG)
    jl = js.lists
    ts = window_state_from_numpy(
        js.pos, js.vel, js.mass,
        lists_from_numpy(jl.order, jl.inv_order, jl.far_n, jl.ref_pos,
                         jl.pool, jl.pstart, int(jl.steps_since),
                         int(jl.steps_build)), acc=js.acc)
    jstep = jbw.make_window_step(STEP_CFG, N_STEP, 1)
    tstep = tbw.make_window_step(STEP_CFG, N_STEP, 1)
    for _ in range(3):                   # tau 0..2, no rebuild
        js = jstep(js, jnp.float32(0.02))
        ts = tstep(ts, 0.02)
    assert tstep.rebuilds == 0 and ts.lists.steps_since == 3
    assert _rel(ts.pos.numpy(), np.asarray(js.pos)) <= 1e-4
    assert _rel(ts.vel.numpy(), np.asarray(js.vel)) <= 1e-4


def test_window_simulation_getters_in_original_order():
    from spatialsim_tpu_torch.models.nbody import NBodySimulation
    from spatialsim_tpu_torch.ops.bh_window import state_original_order
    cfg = NBodyConfig(num_bodies=3000, engine="window", group_size=64,
                      max_depth=6, list_capacity=512, rebuild_interval=2)
    sim = NBodySimulation(config=cfg, seed=4, device="cpu")
    p, v, m = distributions.generate_distribution(
        cfg.distribution, 3000, cfg.spawn_radius, cfg.G, seed=4)
    assert sim.engine == "window"
    np.testing.assert_array_equal(sim.get_positions(), p.astype(np.float32))
    np.testing.assert_array_equal(sim.get_velocities(),
                                  v.astype(np.float32))
    np.testing.assert_array_equal(sim.get_masses(), m.astype(np.float32))
    for _ in range(3):                  # crosses a rebuild (re-sort)
        sim.update(0.02)
    assert sim.rebuilds == 1
    pos_o, vel_o, mass_o = state_original_order(sim.state)
    np.testing.assert_array_equal(sim.get_positions(), pos_o.numpy().T)
    np.testing.assert_array_equal(sim.get_velocities(), vel_o.numpy().T)
    np.testing.assert_array_equal(sim.get_masses(), m.astype(np.float32))
    c = sim.get_colors()
    assert c.shape == (3000, 3) and (c >= 0).all() and (c <= 1).all()
    fp, fv = sim.device_frame()
    np.testing.assert_array_equal(fp.numpy().T, sim.get_positions())


def test_allpairs_simulation_matches_jax_model():
    from spatialsim_tpu.models.nbody import NBodySimulation as JaxSim
    from spatialsim_tpu_torch.models.nbody import NBodySimulation
    cfg = NBodyConfig(num_bodies=1000)
    js = JaxSim(config=cfg, seed=2, substeps=2)
    ts = NBodySimulation(config=cfg, seed=2, substeps=2, device="cpu")
    assert ts.engine == js.engine == "allpairs"
    for _ in range(3):
        js.update(0.02)
        ts.update(0.02)
    assert _rel(ts.get_positions(), js.get_positions()) <= 1e-5
    assert _rel(ts.get_velocities(), js.get_velocities()) <= 1e-4
    np.testing.assert_allclose(ts.get_colors(), js.get_colors(), atol=1e-4)


def test_from_state_and_exact_engine():
    from spatialsim_tpu_torch.models.nbody import NBodySimulation
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(500, 3)) * 50
    vel = rng.normal(size=(500, 3))
    sim = NBodySimulation.from_state(pos, vel, device="cpu")
    np.testing.assert_array_equal(sim.get_positions(),
                                  pos.astype(np.float32))
    np.testing.assert_array_equal(sim.get_masses(), np.ones(500, np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NBodySimulation(config=NBodyConfig(num_bodies=500, engine="exact"),
                        device="cpu")


def test_recorder_cli_frames_decode(tmp_path, monkeypatch):
    from spatialsim_tpu_torch.tools import record
    monkeypatch.setenv("SPATIALSIM_RECORDINGS", str(tmp_path))
    rc = record.main(["--preset", "tiny_galaxy", "--bodies", "2k",
                      "--frames", "3", "--name", "port_rec",
                      "--device", "cpu"])
    assert rc == 0
    rec_dir = tmp_path / "port_rec"
    assert session.get_completed_frames(rec_dir) == 3
    assert session.load_metadata(rec_dir)["num_bodies"] == 2000
    prev = (None, None)
    for k in range(3):
        p, c = codec.load_frame(rec_dir, k, *prev)
        assert p.shape == (2000, 3) and c.shape == (2000, 3)
        assert np.isfinite(p).all()
        assert (c >= -1e-3).all() and (c <= 1 + 1e-3).all()
        prev = (p, c)
    # The final checkpoint restores through the port's resume path.
    state_file, frame = session.find_latest_state(rec_dir, 3)
    assert frame == 2
    rc = record.main(["--extend", "2", "port_rec", "--device", "cpu"])
    assert rc == 0 and session.get_completed_frames(rec_dir) == 5


def test_main_path_imports_no_jax(tmp_path):
    """Every port module, both models and the recorder CLI run, and neither
    jax nor any module of the JAX package is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import spatialsim_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from spatialsim_tpu_torch import Flock, NBodySimulation\n"
        "from spatialsim_tpu_torch.config.boids import BoidsConfig\n"
        "from spatialsim_tpu_torch.tools import record\n"
        "sim = NBodySimulation(num_bodies=400, device='cpu')\n"
        "sim.update(0.02)\n"
        "assert sim.get_positions().shape == (400, 3)\n"
        "flock = Flock(config=BoidsConfig(num_boids=2048,\n"
        "              neighbor_mode='window', group_size=128),\n"
        "              device='cpu')\n"
        "flock.update(1 / 30)\n"
        "assert flock.get_positions().shape == (2048, 3)\n"
        "assert record.main(['--preset', 'tiny_galaxy', '--bodies', '1k',\n"
        "                    '--frames', '2', '--name', 'imports',\n"
        "                    '--device', 'cpu']) == 0\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'spatialsim_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, SPATIALSIM_RECORDINGS=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_cuda_device_without_card_raises():
    from spatialsim_tpu_torch.models.nbody import NBodySimulation
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    with pytest.raises(RuntimeError, match="cuda"):
        NBodySimulation(num_bodies=100, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        NBodySimulation(num_bodies=100)          # the default device
