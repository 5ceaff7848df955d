"""Configuration layer (L1).

Mirrors the reference's ``config/boids.py`` and ``config/nbody.py`` module
dicts (reference ``config/nbody.py:29-78``, ``config/boids.py:3-51``) but as
typed frozen dataclasses that are safe to close over in jitted programs.
"""

from spatialsim_tpu_torch.config.nbody import NBodyConfig, NBODY, WINDOW as NBODY_WINDOW  # noqa: F401
from spatialsim_tpu_torch.config.boids import BoidsConfig, BOIDS, WINDOW as BOIDS_WINDOW  # noqa: F401
