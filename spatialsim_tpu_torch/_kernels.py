"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ONE shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``_build/`` next to this file (listed in
``.gitignore``), named by a hash of the sources and flags, so it is built
once per source change, on first use.  Nothing here includes PyTorch's
headers: a build takes seconds, not minutes.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a nonzero code, so a
refused launch (too many threads, too much shared memory) never passes
silently.  Pointers and the stream travel as ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: name -> argtypes (every entry point returns an int error).
SIGNATURES = {
    "spatialsim_allpairs": (_P, _P, _P, _I, _F, _F, _I, _I, _I, _P),
    "spatialsim_allpairs_occupancy": (_I, _I, _I, _P),
    "spatialsim_window_eval_pool": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _I, _F, _F, _F, _F, _P),
    "spatialsim_window_eval_pool_occupancy": (_I, _I, _P),
    "spatialsim_window_eval": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _F, _F, _F, _F, _P),
    "spatialsim_window_eval_occupancy": (_I, _I, _I, _I, _I, _P),
    "spatialsim_window_eval_cols": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _F, _F, _F, _F, _P),
    "spatialsim_window_eval_mxu": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _F, _F, _F, _F, _P),
    "spatialsim_boids_window": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                                _I, _I, _P),
    "spatialsim_boids_window_occupancy": (_I, _I, _I, _I, _P),
    # The traversal-primitive probes (csrc/probes_decide15.cu, 18.cu).
    "spatialsim_probe_row_reads": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "spatialsim_probe_block_read": (_P, _P, _P, _I, _I, _I, _P),
    "spatialsim_probe_reduce_roundtrip": (_P, _P, _I, _I, _I, _P),
    "spatialsim_probe_row_write": (_P, _P, _P, _P, _I, _I, _P),
    "spatialsim_probe_roll": (_P, _I, _P, _P),
    "spatialsim_probe_scalar_load": (_P, _P, _P, _I, _I, _I, _I, _P),
    "spatialsim_probe_extract8": (_P, _P, _P, _I, _I, _I, _I, _P),
    "spatialsim_probe_smem_table": (_P, _P, _P, _I, _I, _I, _I, _P),
    "spatialsim_probe_gated_reduce": (_P, _P, _I, _I, _I, _P),
    "spatialsim_probe_row_store": (_P, _P, _P, _I, _I, _P),
    "spatialsim_probe_iteration_core": (_P, _P, _P, _I, _I, _I, _I, _P),
}

_lib = None
build_info = {"seconds": None, "path": None, "log": ""}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False, verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the cached shared library; return its path.

    One ``nvcc -c`` per source, all started together, then one link.
    ``force`` rebuilds even when a library for these sources exists;
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel) and keeps the compiler's output in ``build_info["log"]``.
    """
    so = BUILD_DIR / f"libspatialsim_kernels_{_key()}.so"
    if so.exists() and not force:
        build_info["path"] = str(so)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = so.with_name(f"{so.name}.{tag}")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0, path=str(so),
                      log="".join(log))
    return so


def library(force_build: bool = False, verbose: bool = False):
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None or force_build:
        lib = ctypes.CDLL(str(build(force=force_build, verbose=verbose)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device) -> int:
    """Raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
