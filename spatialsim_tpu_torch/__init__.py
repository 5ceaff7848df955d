"""spatialsim-tpu-torch: the N-body main path on PyTorch and CUDA (H100).

A port of :mod:`spatialsim_tpu` (JAX/XLA/Pallas on a TPU), which stays in
the repository as the reference every module here is tested against.
Module names mirror the JAX package's (``ops/morton.py``,
``ops/bh_window.py``, ``models/nbody.py``, ``tools/record.py``, ...).

The port never imports jax.  It reuses the JAX package's framework-neutral
modules (``config``, ``distributions``, ``presets``, ``io`` and the
helpers of ``tools.record``), which import no jax either.

    from spatialsim_tpu_torch import NBodySimulation
    sim = NBodySimulation(num_bodies=1_000_000, device="cuda")
    sim.update(0.02)

The hand-written CUDA kernels live in ``csrc/`` and are built with nvcc on
first use (:mod:`spatialsim_tpu_torch._kernels`).
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy import keeps `import spatialsim_tpu_torch` light.
    if name == "NBodySimulation":
        from spatialsim_tpu_torch.models.nbody import NBodySimulation
        return NBodySimulation
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
