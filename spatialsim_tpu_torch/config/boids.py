"""Boids configuration.

Field names and defaults follow the reference ``config/boids.py:30-46``
(count=500_000, bounds=500, max_speed=25, max_force=60, wall_margin=3,
wall_weight=10, perception_radius=5, separation_radius=3, weights
2.5/1.0/1.0, color_blend_rate=1.0).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BoidsConfig:
    num_boids: int = 500_000
    bounds: float = 500.0
    max_speed: float = 25.0
    max_force: float = 60.0
    size: float = 1.2
    wall_margin: float = 3.0
    wall_weight: float = 10.0

    # Flocking behaviour (reference config/boids.py:39-45)
    perception_radius: float = 5.0
    separation_radius: float = 3.0
    separation_weight: float = 2.5
    alignment_weight: float = 1.0
    cohesion_weight: float = 1.0
    color_blend_rate: float = 1.0

    # --- TPU-native tuning knobs ---
    # Fixed per-cell gather capacity for the neighbour search.  The reference
    # scans every boid in every neighbouring cell (boids/flock.py:139-141);
    # on TPU we gather up to `cell_capacity` boids from each of the 27
    # neighbour cells — exact whenever no cell holds more than this many
    # boids, a graceful density approximation beyond it.
    cell_capacity: int = 16
    # Neighbour search mode: "grid" = exact 27-cell hash (reference parity,
    # gather-heavy), "window" = Morton-sorted sliding window (production
    # path, ~50x faster at 100K+, misses a few percent of cross-boundary
    # pairs), "auto" = grid below window_threshold boids.
    neighbor_mode: str = "auto"
    window_threshold: int = 20_000
    group_size: int = 256
    window_groups: int = 2
    # Second window pass over a diagonally-shifted Morton code — captures
    # the cross-octant pairs pass one misses (99.9% total vs 97.2%
    # single-pass, scripts/boids_capture.py).
    second_pass: bool = True
    # Width of the SECOND pass's window, in groups (0 = same as
    # window_groups).  Pass 2 only recovers the octant-seam pairs pass 1
    # missed (~1-3%), and those land in pass 2's window INTERIOR by
    # construction of the diagonal shift — a narrower window keeps the
    # capture at 3/5 of pass 2's accumulate cost.  Measured at 100K
    # (scripts/boids_capture.py, round 4): two-pass capture 1.0000
    # uniform / 0.9983 clustered at width 1, vs 1.0000 / 0.9989 at
    # width 2.
    pass2_window_groups: int = 1
    # Production stepper: the state stays Morton-sorted with FROZEN pass
    # orders; every `resort_interval` steps both orders rebuild from the
    # current positions.  Drift between re-sorts stays well inside the
    # window slack (max_speed*dt*interval ~ 1.6 units at dt=1/60 vs the
    # 5-unit cells); capture at interval end is tested >= 99%.
    resort_interval: int = 6

    def replace(self, **kw) -> "BoidsConfig":
        return dataclasses.replace(self, **kw)

    @property
    def cell_size(self) -> float:
        # Reference sizes grid cells to the perception radius (flock.py:477).
        return self.perception_radius

    @property
    def grid_dim(self) -> int:
        import math

        # Reference: ceil(2*bounds/cell)+2 (flock.py:478-481).
        return int(math.ceil((2.0 * self.bounds) / self.cell_size)) + 2


WINDOW = {"width": 1280, "height": 720, "title": "3D Boids"}

CAMERA = {
    "fov": 90.0,
    "near_clip": 0.1,
    "far_clip": 1000.0,
    "initial_radius": 120.0,
    "initial_theta": 45.0,
    "initial_phi": 25.0,
    "min_radius": -1500.0,
    "max_radius": 1500.0,
    "min_phi": -89.0,
    "max_phi": 89.0,
    "keyboard_rotate_speed": 60.0,
    "keyboard_zoom_speed": 20.0,
    "mouse_sensitivity": 0.3,
}

GRID = {"base_size": 500, "color": (0.2, 0.2, 0.25)}

BOIDS = BoidsConfig()

COLORS = {"background": (0.01, 0.01, 0.02, 1.0), "text": (0.9, 0.9, 0.9)}
