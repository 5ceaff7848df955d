"""spatialsim-tpu-torch: the N-body and boids main paths on PyTorch and
CUDA (H100).

A port of :mod:`spatialsim_tpu` (JAX/XLA/Pallas on a TPU), which stays in
the repository as the reference every module here is tested against.
Module names mirror the JAX package's (``ops/morton.py``,
``ops/bh_window.py``, ``models/nbody.py``, ``tools/record.py``, ...).

The port imports neither jax nor anything of the JAX package.  It keeps
its own copies of the JAX package's framework-neutral modules
(``config``, ``distributions``, ``presets``, ``io``), verbatim apart from
their imports, so initial conditions and recorded frames stay identical.

    from spatialsim_tpu_torch import NBodySimulation
    sim = NBodySimulation(num_bodies=1_000_000, device="cuda")
    sim.update(0.02)

    from spatialsim_tpu_torch import Flock
    flock = Flock(num_boids=500_000, device="cuda")
    flock.update(1 / 30)

The hand-written CUDA kernels live in ``csrc/`` and are built with nvcc on
first use (:mod:`spatialsim_tpu_torch._kernels`).
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy import keeps `import spatialsim_tpu_torch` light.
    if name == "NBodySimulation":
        from spatialsim_tpu_torch.models.nbody import NBodySimulation
        return NBodySimulation
    if name == "Flock":
        from spatialsim_tpu_torch.models.boids import Flock
        return Flock
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
