"""Boids flocking model (port of ``spatialsim_tpu/models/boids.py``).

``Flock`` picks its neighbour search by count, as in the JAX package: the
exact grid (plain PyTorch, ``ops/boids_ops.flocking_forces``) up to
``window_threshold`` boids, the two-pass Morton window above it, whose
accumulation runs in the CUDA kernel ``csrc/boids_window.cu`` on a card.
The window state lives sorted by the pass-1 Morton code with FROZEN pass
orders, re-sorted every ``resort_interval`` steps by a host-side Python-int
counter, so no step synchronises with the device; host-facing reads map
back through ``inv1``.  Initial conditions come from numpy's
``default_rng(seed)`` in the JAX package's order (positions, velocities,
shuffled hues), so both packages start from the same state.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from spatialsim_tpu_torch.config.boids import BOIDS, BoidsConfig
from spatialsim_tpu_torch.models.nbody import _device
from spatialsim_tpu_torch.ops.boids_ops import (
    _inverse, boids_physics, build_boids_orders, flocking_forces,
    flocking_forces_window_frozen)


class BoidsState(NamedTuple):
    """Grid-mode state: pos/vel/col ``(3, N)`` float32, original order."""

    pos: torch.Tensor
    vel: torch.Tensor
    col: torch.Tensor


class BoidsWindowState(NamedTuple):
    """Window-mode state: PASS-1-MORTON-SORTED arrays plus the frozen
    order pair, re-sorted every ``resort_interval`` steps.

    ``order1``: (n,) sorted slot -> ORIGINAL boid id; ``inv1`` its
    inverse (host-facing reads map back through it); ``p21``/``s21``: the
    second window pass's permutation relative to the pass-1 layout (see
    ``ops/boids_ops.flocking_forces_window_frozen``).  Orders are int64;
    ``steps_since`` is a Python int.
    """

    pos: torch.Tensor
    vel: torch.Tensor
    col: torch.Tensor
    order1: torch.Tensor
    inv1: torch.Tensor
    p21: torch.Tensor
    s21: torch.Tensor
    steps_since: int


def generate_rainbow_colors(count: int, rng: np.random.Generator) -> np.ndarray:
    """Shuffled evenly-spaced hues at S=0.9, V=1.0."""
    hues = np.linspace(0, 1, count, endpoint=False)
    rng.shuffle(hues)
    s, v = 0.9, 1.0
    h6 = hues * 6.0
    i = h6.astype(np.int32) % 6
    f = h6 - np.floor(h6)
    p = np.full_like(f, v * (1.0 - s))
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    vv = np.full_like(f, v)
    table = [(vv, t, p), (q, vv, p), (p, vv, t), (p, q, vv), (t, p, vv),
             (vv, p, q)]
    colors = np.zeros((count, 3))
    for idx, (r_, g_, b_) in enumerate(table):
        m = i == idx
        colors[m, 0], colors[m, 1], colors[m, 2] = r_[m], g_[m], b_[m]
    return colors


def resolve_neighbor_mode(config: BoidsConfig) -> str:
    mode = getattr(config, "neighbor_mode", "auto")
    if mode != "auto":
        return mode
    return ("grid" if config.num_boids <= config.window_threshold
            else "window")


def _grid_kw(config):
    return dict(cell_size=config.cell_size, grid_dim=config.grid_dim,
                offset=config.bounds + config.cell_size)


def _resort_boids(state: BoidsWindowState, grid_kw, gsz) -> BoidsWindowState:
    """Re-sort the (nearly sorted) state and compose the original-id maps."""
    o1, p21, s21 = build_boids_orders(state.pos, group_size=gsz, **grid_kw)
    return BoidsWindowState(state.pos[:, o1], state.vel[:, o1],
                            state.col[:, o1], state.order1[o1],
                            _inverse(o1)[state.inv1], p21, s21, 0)


def init_boids_window_state(pos, vel, col, config) -> BoidsWindowState:
    """Sort ORIGINAL-order arrays into the frozen-order window state."""
    o1, p21, s21 = build_boids_orders(pos, group_size=config.group_size,
                                      **_grid_kw(config))
    return BoidsWindowState(pos[:, o1], vel[:, o1], col[:, o1], o1,
                            _inverse(o1), p21, s21, 0)


def physics_fn(config):
    """``physics(pos, vel, col, force, avg_col, dt)``: the flock step's
    walls, clamps and colour blend, with the float32 blend the JAX step
    computes."""
    wall_force = config.max_force * config.wall_weight

    def physics(pos, vel, col, force, avg_col, dt):
        blend = min(1.0, float(np.float32(config.color_blend_rate)
                               * np.float32(dt)))
        return boids_physics(
            pos, vel, col, force, avg_col, bounds=config.bounds,
            margin=config.wall_margin, wall_force=wall_force,
            max_speed=config.max_speed, color_blend=blend, dt=dt)
    return physics


def make_step_fn(config: BoidsConfig, substeps: int = 1):
    """The flock step: ``step(state, dt) -> state``, ``substeps`` physics
    steps of ``dt`` each.

    Window mode takes and returns a :class:`BoidsWindowState`; it re-sorts
    BEFORE a step's forces when ``steps_since >= resort_interval`` and
    counts its re-sorts in ``step.resorts``.  Grid mode keeps the
    original-order :class:`BoidsState`.
    """
    mode = resolve_neighbor_mode(config)
    cell_range = int(math.ceil(config.perception_radius / config.cell_size))
    resort_interval = getattr(config, "resort_interval", 6)
    force_kw = dict(
        perception_radius=config.perception_radius,
        separation_radius=config.separation_radius,
        separation_weight=config.separation_weight,
        alignment_weight=config.alignment_weight,
        cohesion_weight=config.cohesion_weight,
        max_speed=config.max_speed, max_force=config.max_force)
    grid_kw = _grid_kw(config)
    window_kw = dict(group_size=config.group_size,
                     window_groups=config.window_groups,
                     pass2_window_groups=getattr(config,
                                                 "pass2_window_groups", 0),
                     second_pass=config.second_pass, **force_kw)

    physics = physics_fn(config)

    def window_substep(state: BoidsWindowState, dt):
        if state.steps_since >= resort_interval:
            state = _resort_boids(state, grid_kw, config.group_size)
            step.resorts += 1
        force, avg_col = flocking_forces_window_frozen(
            state.pos, state.vel, state.col, state.p21, state.s21,
            **window_kw)
        pos, vel, col = physics(state.pos, state.vel, state.col, force,
                                avg_col, dt)
        return state._replace(pos=pos, vel=vel, col=col,
                              steps_since=state.steps_since + 1)

    def grid_substep(state: BoidsState, dt):
        force, avg_col = flocking_forces(
            state.pos, state.vel, state.col, cell_range=cell_range,
            cell_capacity=config.cell_capacity, **grid_kw, **force_kw)
        return BoidsState(*physics(state.pos, state.vel, state.col, force,
                                   avg_col, dt))

    substep = window_substep if mode == "window" else grid_substep

    def step(state, dt):
        dt = float(np.float32(dt))
        for _ in range(substeps):
            state = substep(state, dt)
        return state

    step.resorts = 0
    return step


class Flock:
    """Host-side driver owning the on-device flock state.

    API as in the JAX package: ``update(dt)``, ``get_positions()``,
    ``get_velocities()``, ``get_colors()`` (``(N, 3)`` numpy, original boid
    order), plus ``resorts``.  ``device`` (default ``"cuda"``) holds every
    tensor; it raises when CUDA is asked for and absent -- there is no
    silent CPU fallback.
    """

    def __init__(self, num_boids: Optional[int] = None,
                 config: Optional[BoidsConfig] = None, seed: int = 0,
                 device="cuda"):
        self.device = _device(device)
        self.config = config or BOIDS
        if num_boids is not None:
            self.config = self.config.replace(num_boids=num_boids)
        self.num_boids = n = self.config.num_boids
        rng = np.random.default_rng(seed)
        # Uniform positions in the box, uniform velocities in
        # [-max_speed/2, max_speed/2], then the shuffled hues.
        b = self.config.bounds
        pos = (rng.random((n, 3)) - 0.5) * 2 * b
        vel = (rng.random((n, 3)) - 0.5) * self.config.max_speed
        col = generate_rainbow_colors(n, rng)
        pos, vel, col = (torch.as_tensor(
            np.ascontiguousarray(a.T, np.float32), device=self.device)
            for a in (pos, vel, col))
        self.neighbor_mode = resolve_neighbor_mode(self.config)
        if self.neighbor_mode == "window":
            self.state = init_boids_window_state(pos, vel, col, self.config)
        else:
            self.state = BoidsState(pos, vel, col)
        self._step = make_step_fn(self.config)

    @property
    def resorts(self) -> int:
        """Re-sorts the window step has run (0 in grid mode)."""
        return self._step.resorts

    def update(self, dt: float):
        self.state = self._step(self.state, dt)

    def _original(self, arr):
        if self.neighbor_mode == "window":
            return arr[:, self.state.inv1]
        return arr

    def get_positions(self) -> np.ndarray:
        return self._original(self.state.pos).cpu().numpy().T

    def get_velocities(self) -> np.ndarray:
        return self._original(self.state.vel).cpu().numpy().T

    def get_colors(self) -> np.ndarray:
        return self._original(self.state.col).cpu().numpy().T
