"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ONE shared library with a plain C interface.  The library lands in
``_build/`` next to this file (listed in ``.gitignore``), named by a hash
of the sources, the flags and the Python ABI, so it is built once per
source change, on first use.  Nothing here includes PyTorch's headers: a
build takes seconds, not minutes.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; a wrapper raises on a nonzero code (:func:`fail`),
so a refused launch (too many threads, too much shared memory) never
passes silently.

The launch path, one for every wrapper, is short because a small kernel's
call is host-bound: the roll probe's kernel runs ~1 us on an H100, its
wrapper took 14-24 us of host time through ``library()``, a
``torch.cuda.Stream`` object built per call and a ``ctypes`` call, whose
argument types alone cost ~1 us of conversions a call (PERF.md, 5e).  A
wrapper calls ``entry.<name>(..., stream(t))``:

* :data:`entry` holds every C entry point of ``SIGNATURES`` as an
  attribute, bound once when the library loads (the first lookup loads
  it).  Each is a function of a small CPython extension compiled into the
  same library (:func:`binding_source`, generated from ``SIGNATURES``):
  a ``METH_FASTCALL`` call converts each argument by its kind (a pointer
  from an int or None, an int, a float) in C, keeps the GIL (an entry
  point only enqueues) and returns the entry point's error code.  It
  takes what the ``ctypes`` binding took (``bind``, which tools that load
  other libraries still use), with pointers as ints;
* :func:`stream` is the raw ``cudaStream_t`` of PyTorch's current stream
  on the tensor's device, as an int, read without building a ``Stream``
  object (``torch._C._cuda_getCurrentRawStream``, as Triton's launcher
  reads it).
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# The binding is host code: nvcc hands it to the host compiler.
HOST_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
BINDING = "spatialsim_launch"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: name -> argtypes (every entry point returns an int error).
SIGNATURES = {
    "spatialsim_allpairs": (_P, _P, _P, _I, _F, _F, _I, _I, _I, _P),
    "spatialsim_allpairs_occupancy": (_I, _I, _I, _P),
    "spatialsim_allpairs_at": (_P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _I,
                               _I, _P),
    "spatialsim_allpairs_at_occupancy": (_I, _I, _P),
    "spatialsim_window_eval_pool": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _I, _F, _F, _F, _F, _P),
    "spatialsim_window_eval_pool_occupancy": (_I, _I, _P),
    "spatialsim_window_eval": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P),
    "spatialsim_window_eval_occupancy": (_I, _I, _I, _I, _I, _P),
    "spatialsim_window_eval_cols": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                                    _F, _P),
    "spatialsim_window_eval_cols_occupancy": (_I, _I, _I, _I, _I, _P),
    "spatialsim_window_eval_mxu": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                                   _F, _F, _P),
    "spatialsim_window_eval_mxu_occupancy": (_I, _I, _I, _I, _I, _I, _P),
    "spatialsim_boids_window": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                _F, _F, _I, _I, _P),
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

_C_TYPE = {_P: ("void*", "ptr"), _I: ("int", "int"), _F: ("float", "float")}
_CONVERTERS = """\
static int to_ptr(PyObject* o, void** v) {
  if (o == Py_None) { *v = nullptr; return 0; }
  *v = PyLong_AsVoidPtr(o);
  return (*v == nullptr && PyErr_Occurred()) ? -1 : 0;
}
static int to_int(PyObject* o, int* v) {
  const long x = PyLong_AsLong(o);
  if (x == -1 && PyErr_Occurred()) return -1;
  if (x < INT_MIN || x > INT_MAX) {
    PyErr_SetString(PyExc_OverflowError, "int argument out of range");
    return -1;
  }
  *v = static_cast<int>(x);
  return 0;
}
static int to_float(PyObject* o, float* v) {
  const double x = PyFloat_AsDouble(o);
  if (x == -1.0 && PyErr_Occurred()) return -1;
  *v = static_cast<float>(x);
  return 0;
}
static PyObject* arity(const char* name, Py_ssize_t want, Py_ssize_t got) {
  PyErr_Format(PyExc_TypeError, "%s takes %zd arguments (%zd given)", name,
               want, got);
  return nullptr;
}
"""


def binding_source(signatures=SIGNATURES, module=BINDING) -> str:
    """C++ source of the CPython extension ``module`` whose functions call
    the C entry points of ``signatures`` (name -> ctypes argument types)
    with the same arguments: a pointer from an int or None, an int, a
    float; each returns the entry point's int result."""
    out = ["#define PY_SSIZE_T_CLEAN", "#include <Python.h>",
           "#include <climits>", "", _CONVERTERS]
    table = []
    for name, argtypes in signatures.items():
        kinds = [_C_TYPE[t] for t in argtypes]
        n = len(kinds)
        out.append(f'extern "C" int {name}('
                   + ", ".join(c for c, _ in kinds) + ");")
        out.append(f"static PyObject* py_{name}(PyObject*, "
                   f"PyObject* const* a, Py_ssize_t n) {{")
        out.append(f'  if (n != {n}) return arity("{name}", {n}, n);')
        for i, (c, kind) in enumerate(kinds):
            out.append(f"  {c} a{i};")
        conv = " || ".join(f"to_{kind}(a[{i}], &a{i})"
                           for i, (_, kind) in enumerate(kinds))
        out.append(f"  if ({conv}) return nullptr;")
        out.append(f"  return PyLong_FromLong({name}("
                   + ", ".join(f"a{i}" for i in range(n)) + "));")
        out.append("}")
        table.append(f'  {{"{name}", reinterpret_cast<PyCFunction>('
                     f"reinterpret_cast<void (*)(void)>(py_{name})), "
                     f"METH_FASTCALL, nullptr}},")
    out += [f"static PyMethodDef methods[] = {{", *table,
            "  {nullptr, nullptr, 0, nullptr}};",
            f'static PyModuleDef module = {{PyModuleDef_HEAD_INIT, "{module}",'
            " nullptr, -1, methods};",
            f"PyMODINIT_FUNC PyInit_{module}(void) {{",
            "  return PyModule_Create(&module);", "}", ""]
    return "\n".join(out)


def load_binding(path, module=BINDING):
    """Import the CPython extension ``module`` from the library at
    ``path``."""
    spec = importlib.util.spec_from_file_location(module, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def python_include() -> str:
    """The running interpreter's C headers (``Python.h``)."""
    return sysconfig.get_paths()["include"]


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + HOST_FLAGS).encode())
    h.update(binding_source().encode())
    h.update(sys.implementation.cache_tag.encode())     # the Python ABI
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False, verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` and the binding (:func:`binding_source`) into
    the cached shared library; return its path.

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
    binding = BUILD_DIR / f"{BINDING}.{tag}.cpp"
    binding.write_text(binding_source())
    cmds = [(src, [*NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ())])
            for src in _sources()]
    cmds.append((binding, [*HOST_FLAGS, "-I", python_include()]))
    for src, flags in cmds:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
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
        for obj in objs + [binding]:
            obj.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0, path=str(so),
                      log="".join(log))
    return so


def bind(lib, signatures=SIGNATURES):
    """Set the argument and result types of ``signatures``' entry points
    of the loaded library ``lib``."""
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


class _Entries:
    """The C entry points of ``SIGNATURES`` as attributes of one object.
    An attribute it lacks loads the library (building it on first use),
    which binds them all here."""

    def __getattr__(self, name):
        if name not in SIGNATURES:
            raise AttributeError(name)
        library()
        return self.__dict__[name]


entry = _Entries()


def library(force_build: bool = False, verbose: bool = False):
    """The loaded kernel library (built on first use), as its CPython
    extension module; binds its entry points into :data:`entry`."""
    global _lib
    if _lib is None or force_build:
        lib = load_binding(build(force=force_build, verbose=verbose))
        for name in SIGNATURES:
            setattr(entry, name, getattr(lib, name))
        _lib = lib
    return _lib


def fail(err: int, name: str):
    """Raise for the nonzero CUDA error a C entry point returned."""
    raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                       f"cudaError {err}")


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err:
        fail(err, name)


def _first_raw_stream(index: int) -> int:
    global _raw_stream
    import torch
    _raw_stream = torch._C._cuda_getCurrentRawStream
    return _raw_stream(index)


_raw_stream = _first_raw_stream


def stream(t) -> int:
    """Raw ``cudaStream_t`` of PyTorch's current stream on the CUDA
    tensor ``t``'s device: ``torch.cuda.current_stream(t.device)
    .cuda_stream`` without the ``Stream`` object."""
    return _raw_stream(t.get_device())
