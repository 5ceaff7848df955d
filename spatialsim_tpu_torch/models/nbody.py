"""N-body gravitational simulation model (port of
``spatialsim_tpu/models/nbody.py``).

The engine is picked by body count as in the JAX package: the all-pairs
CUDA kernel up to ``allpairs_threshold`` (32,768), the windowed Barnes-Hut
engine (``ops/bh_window.py``) above it; ``engine="exact"`` forces the
per-step group traversal of ``ops/barnes_hut.py``.  State lives on
``device`` as component-major ``(3, N)`` float32 tensors; the window
engine keeps it Morton-sorted and maps back through ``lists.inv_order``
for every host-facing read.  Initial conditions come from the numpy generators in
the port's ``distributions`` (a copy of the JAX package's, bit-identical
for a ``seed``); the step itself has no randomness.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from spatialsim_tpu_torch import distributions
from spatialsim_tpu_torch.config.nbody import (NBODY, NBodyConfig,
                                               resolve_config)
from spatialsim_tpu_torch.ops.allpairs import allpairs_accel
from spatialsim_tpu_torch.ops.capture import original_order
from spatialsim_tpu_torch.ops.colors import colors_by_velocity
from spatialsim_tpu_torch.ops.integrator import integrate
from spatialsim_tpu_torch.utils.profiling import count


class NBodyState(NamedTuple):
    """All-pairs and exact engine state.  pos/vel: (3, N) f32; mass: (N,)
    f32."""

    pos: torch.Tensor
    vel: torch.Tensor
    mass: torch.Tensor


def resolve_engine(config: NBodyConfig, n: int) -> str:
    """Tiled all-pairs up to the threshold, the window engine above it;
    an explicit ``config.engine`` wins."""
    if config.engine != "auto":
        return config.engine
    return "allpairs" if n <= config.allpairs_threshold else "window"


def make_accel_fn(config: NBodyConfig, n: int,
                  engine: Optional[str] = None):
    """``accel(state) -> (3, N)`` accelerations of a stateless engine:
    "allpairs" (kernel 1) or "exact" (the per-step group traversal).  The
    window engine keeps lists between steps: ``ValueError``, use
    :func:`make_step_fn`."""
    config = resolve_config(config, n)
    engine = engine or resolve_engine(config, n)
    if engine == "window":
        raise ValueError("the window engine is stateful; use "
                         "make_window_step (models handle this)")
    if engine == "allpairs":
        def accel(state: NBodyState):
            return allpairs_accel(state.pos, state.mass, config.G,
                                  config.softening)
        return accel
    if engine != "exact":
        raise ValueError(f"unknown engine {engine!r}")
    from spatialsim_tpu_torch.ops.barnes_hut import barnes_hut_accel

    def accel(state: NBodyState):
        return barnes_hut_accel(state.pos, state.mass, config)
    return accel


def make_step_fn(config: NBodyConfig, n: int, substeps: int = 1,
                 engine: Optional[str] = None):
    """Multi-substep step: ``step(state, dt) -> state``.

    ``dt`` is the per-substep timestep.  The window engine's step takes and
    returns a ``WindowBHState``; the all-pairs and exact ones an
    :class:`NBodyState`.
    """
    config = resolve_config(config, n)
    engine = engine or resolve_engine(config, n)
    if engine == "window":
        from spatialsim_tpu_torch.ops.bh_window import make_window_step
        return make_window_step(config, n, substeps)
    accel = make_accel_fn(config, n, engine)
    damping = config.damping

    def step(state: NBodyState, dt: float) -> NBodyState:
        for _ in range(substeps):
            acc = accel(state)
            pos, vel = integrate(state.pos, state.vel, acc, float(dt),
                                 damping)
            state = NBodyState(pos, vel, state.mass)
        return state

    return step


def _clock(device: torch.device) -> float:
    """Host seconds after the device's queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    return dev


class NBodySimulation:
    """Host-side driver owning the on-device state.

    API as in the JAX package: ``update(dt)``, ``step_raw(dt)``,
    ``device_frame()``, ``get_positions()``, ``get_velocities()``,
    ``get_colors()``, ``get_masses()``, plus ``state`` for the recorder.
    ``device`` (default ``"cuda"``) holds every tensor; it raises when CUDA
    is asked for and absent -- there is no silent CPU fallback.
    ``setup_seconds`` holds the host seconds of the set-up phases
    ("initial_conditions" with the copy to the device, and for the window
    engine "calibration" and "first_build").
    """

    def __init__(self, num_bodies: Optional[int] = None,
                 config: Optional[NBodyConfig] = None, seed: int = 0,
                 substeps: int = 1, device="cuda"):
        self.device = _device(device)
        self.config = config or NBODY
        if num_bodies is not None:
            self.config = self.config.replace(num_bodies=num_bodies)
        self.num_bodies = self.config.num_bodies
        self.substeps = substeps
        t0 = time.perf_counter()
        pos, vel, mass = distributions.generate_distribution(
            self.config.distribution, self.num_bodies,
            self.config.spawn_radius, self.config.G, seed=seed)
        self._init_state(pos, vel, mass, t0)

    @classmethod
    def from_state(cls, positions, velocities, masses=None,
                   config: Optional[NBodyConfig] = None, substeps: int = 1,
                   device="cuda"):
        """Restore from host arrays (N,3)/(N,3)/(N,) -- the resume path."""
        sim = cls.__new__(cls)
        sim.device = _device(device)
        n = positions.shape[0]
        sim.config = (config or NBODY).replace(num_bodies=n)
        sim.num_bodies = n
        sim.substeps = substeps
        if masses is None:
            masses = np.ones(n)
        sim._init_state(positions, velocities, masses)
        return sim

    def _tensor(self, arr, transpose=False):
        arr = np.asarray(arr, np.float32)
        if transpose:
            arr = np.ascontiguousarray(arr.T)
        return torch.as_tensor(arr, device=self.device)

    def _init_state(self, pos, vel, mass, t0=None):
        """Device state + step for the engine the body count selects."""
        t0 = time.perf_counter() if t0 is None else t0
        pos = self._tensor(pos, transpose=True)
        vel = self._tensor(vel, transpose=True)
        mass = self._tensor(mass)
        self.config = resolve_config(self.config, self.num_bodies)
        self.engine = resolve_engine(self.config, self.num_bodies)
        t1 = _clock(self.device)
        self.setup_seconds = {"initial_conditions": t1 - t0}
        if self.engine == "window":
            from spatialsim_tpu_torch.ops.bh_window import (
                calibrate_config, init_window_state)
            # Demand-calibrate tree/worklist/pool caps on the real initial
            # conditions (a no-op for the worklist when the defaults fit).
            self.config = calibrate_config(self.config, pos, vel, mass)
            t2 = _clock(self.device)
            self.state = init_window_state(pos, vel, mass, self.config)
            self.setup_seconds.update(calibration=t2 - t1,
                                      first_build=_clock(self.device) - t2)
        else:
            self.state = NBodyState(pos=pos, vel=vel, mass=mass)
        self._step = make_step_fn(self.config, self.num_bodies,
                                  self.substeps, self.engine)
        self._color_cache = None

    @property
    def rebuilds(self) -> int:
        """List rebuilds the step has run (0 for the all-pairs engine)."""
        return getattr(self._step, "rebuilds", 0)

    @property
    def refreshes(self) -> int:
        """Moment refreshes the step has run (``refresh_interval > 0``)."""
        return getattr(self._step, "refreshes", 0)

    def device_frame(self):
        """(pos, vel) device tensors, original body order -- capture path.

        The window engine's state goes through ``ops/capture.py``
        ``original_order`` (on the card, ``(3, N)`` views of fresh
        ``(N, 3)`` rows); the other engines' state is in that order
        already."""
        if self.engine == "window":
            return original_order(self.state.lists.inv_order,
                                  self.state.pos, self.state.vel)
        count("capture.plain_calls")
        return self.state.pos, self.state.vel

    def update(self, dt: float):
        """Advance one frame (dt capped at ``config.max_dt``)."""
        dt = min(float(dt), self.config.max_dt) if self.config.max_dt \
            else float(dt)
        self.state = self._step(self.state, dt)
        self._color_cache = None

    def step_raw(self, dt: float):
        """Advance without the interactive dt cap (offline recorder path)."""
        self.state = self._step(self.state, float(dt))
        self._color_cache = None

    # --- host-facing getters ---
    def get_positions(self) -> np.ndarray:
        return self.device_frame()[0].cpu().numpy().T

    def get_velocities(self) -> np.ndarray:
        return self.device_frame()[1].cpu().numpy().T

    def get_colors(self) -> np.ndarray:
        if self._color_cache is None:
            self._color_cache = colors_by_velocity(
                self.device_frame()[1],
                self.config.max_speed_color).cpu().numpy().T
        return self._color_cache

    def get_masses(self) -> np.ndarray:
        if self.engine == "window":
            return self.state.mass[
                self.state.lists.inv_order.long()].cpu().numpy()
        return self.state.mass.cpu().numpy()
