"""Tensor ops of the port: Morton/octree build, window engine, kernels.

Unlike ``spatialsim_tpu.ops`` this package imports nothing eagerly, so a
pure helper never drags in the CUDA kernel loader.
"""
