"""Presentation layer: cameras and a headless software point renderer.

The reference renders through OpenGL point sprites inside a pygame window
(``nbody/simulation.py:905-963``, ``tools/playback.py:398-444``,
``tools/export.py:358-398``).  This framework targets headless TPU VMs, so
the core renderer is a numpy software rasterizer (projection + additive
splatting) that needs no GL context or display; the interactive GL viewer
(:mod:`spatialsim_tpu_torch.apps.viewer`) reuses the same cameras when a display
exists.
"""

from spatialsim_tpu_torch.render.camera import (  # noqa: F401
    OrbitalCamera, PlaybackCamera, ExportCamera, camera_basis)
from spatialsim_tpu_torch.render.points import render_points  # noqa: F401
