"""The port's launch path and the column kernel's Python side, on the CPU.

* Every ``extern "C"`` entry point of ``spatialsim_tpu_torch/csrc/*.cu``
  has the arity and the pointer / int / float kinds of its
  ``_kernels.SIGNATURES`` entry (a text parse, no build): a mismatch makes
  ctypes cut a pointer to 32 bits, or read a float as an int, silently.
* ``_kernels.entry`` and ``_kernels.stream``: lazy binding, the raw stream
  of the tensor's device, and a nonzero CUDA error that still raises.
* The column kernel's plan (T, heavy-first), its heavy-first order over
  whole tiles, and ``tools/eval_tiles.py``'s labels and ptxas readings of
  its instances.
"""

import ctypes
import re

import pytest
import torch

from spatialsim_tpu_torch import _kernels
from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
from spatialsim_tpu_torch.ops import traversal_probes as tp
from spatialsim_tpu_torch.tools import eval_tiles, same_sass

_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _c_entry_points():
    """``{name: (kind, ...)}`` of the ``extern "C"`` functions of csrc/*.cu:
    'P' for a pointer, 'I' for an int, 'F' for a float."""
    found = {}
    for src in sorted(_kernels.CSRC_DIR.glob("*.cu")):
        for name, params in _EXTERN.findall(src.read_text()):
            kinds = []
            for p in params.split(","):
                p = " ".join(p.split())
                if "*" in p:
                    kinds.append("P")
                elif re.match(r"(const )?int \w+$", p):
                    kinds.append("I")
                elif re.match(r"(const )?float \w+$", p):
                    kinds.append("F")
                else:
                    raise AssertionError(f"{src.name}: {name}: {p!r}")
            assert name not in found, name
            found[name] = tuple(kinds)
    return found


_KIND = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F"}


@pytest.mark.parametrize("name", sorted(_kernels.SIGNATURES))
def test_signature_matches_its_c_entry_point(name):
    entries = _c_entry_points()
    assert name in entries, f"no extern \"C\" {name} in csrc/*.cu"
    assert tuple(_KIND[t] for t in _kernels.SIGNATURES[name]) == \
        entries[name]


def test_every_c_entry_point_has_a_signature():
    assert set(_c_entry_points()) == set(_kernels.SIGNATURES)


def test_parse_reads_kinds_and_arity():
    text = ('extern "C" int f(const float* a, int n,\n    float s, '
            'void* stream) {')
    (name, params), = _EXTERN.findall(text)
    assert name == "f" and params.count(",") == 3


def test_entry_binds_lazily():
    """Looking up a name that is not an entry point raises without
    loading the library; a module import builds nothing."""
    loaded = _kernels._lib
    with pytest.raises(AttributeError):
        _kernels.entry.spatialsim_no_such_kernel
    assert _kernels._lib is loaded
    if loaded is None:
        assert not set(vars(_kernels.entry)) & set(_kernels.SIGNATURES)


def test_stream_reads_the_tensor_device(monkeypatch):
    seen = []

    def raw(index):
        seen.append(index)
        return 0xABC0 + index

    class Tensor:
        def get_device(self):
            return 3
    monkeypatch.setattr(_kernels, "_raw_stream", raw)
    assert _kernels.stream(Tensor()) == 0xABC3 and seen == [3]


class _SeenOnCard(torch.Tensor):
    """A CPU tensor that the wrappers' device tests take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


def test_nonzero_error_raises_and_counts_nothing(monkeypatch):
    """A CUDA error code from an entry point raises, through the roll
    probe's inlined path and through the helpers of the others, and the
    launch is not counted."""
    x = tp.lane_row("cpu").as_subclass(_SeenOnCard)

    class Entry:
        @staticmethod
        def spatialsim_probe_roll(*args):
            assert len(args) == len(_kernels.SIGNATURES[
                "spatialsim_probe_roll"])
            return 1                                  # cudaErrorInvalidValue

        @staticmethod
        def spatialsim_probe_reduce_roundtrip(*args):
            return 700                                # an illegal address
    monkeypatch.setattr(_kernels, "entry", Entry)
    monkeypatch.setattr(_kernels, "_raw_stream", lambda index: 0)
    before = tp.roll.launches
    with pytest.raises(RuntimeError, match="probe_roll.*cudaError 1"):
        tp.roll(x, 5)
    assert tp.roll.launches == before
    monkeypatch.setattr(tp, "_on_card", lambda *a: True)
    before = tp.reduce_roundtrip.launches
    with pytest.raises(RuntimeError, match="reduce_roundtrip.*cudaError 700"):
        tp.reduce_roundtrip(x, 8, 1)
    assert tp.reduce_roundtrip.launches == before
    with pytest.raises(RuntimeError, match="cudaError 2"):
        _kernels.check(2, "x")
    _kernels.check(0, "x")


def test_roll_takes_plain_only_on_the_cpu():
    x = tp.lane_row("cpu")
    before = tp.roll.launches
    assert torch.equal(tp.roll(x, -3), torch.roll(x, -3, 1))
    assert tp.roll.launches == before
    with pytest.raises(ValueError, match="unsupported devices"):
        tp.roll(x.to("meta"), 5)
    with pytest.raises(ValueError, match="unsupported devices"):
        tp.row_reads(tp.table(4, "cpu"), tp.indices(4, 8, "cpu").to("meta"),
                     1)


@pytest.mark.parametrize("gsz", [8, 16, 24, 40, 64, 96, 128, 256, 512,
                                 1000, 1024])
def test_cols_plan_keeps_runs_of_8(gsz):
    """T divides the group into runs of 8 a thread's batch keeps: source k
    of a batch is source k of its block mod 8, as in the TPU kernel."""
    T, heavy = ek.cols_plan(gsz)
    assert T in (1, 2, 4) and gsz % (8 * T) == 0 and heavy in (True, False)


def test_cols_plan_table():
    """The measured choice at the A/B tool's group size."""
    assert ek.cols_plan(256) == ek._COLS_PLAN[256]
    assert ek.cols_plan(8) == (1, ek._COLS_PLAN.get(8, (2, True))[1])


def test_heavy_first_over_whole_tiles():
    """The column kernel reads whole tiles: far_n 3, 9, 0, 9, 5, 3, 12 at
    tile 8 and cap 16 is 8, 16, 0, 16, 8, 8, 16 slots (ties by id)."""
    far_n = torch.tensor([3, 9, 0, 9, 5, 3, 12], dtype=torch.int32)
    assert ek.heavy_first(far_n, tiles=(16, 8)).tolist() == \
        [1, 3, 6, 0, 4, 5, 2]
    assert ek.heavy_first(far_n).tolist() == [6, 1, 3, 4, 0, 5, 2]
    near = torch.tensor([[-1], [-1], [0], [9], [-1], [-1], [-1]],
                        dtype=torch.int32)
    assert ek.heavy_first(far_n, near, 16, tiles=(16, 8)).tolist() == \
        [1, 2, 3, 6, 0, 4, 5]


def test_cols_order_cache_keys_on_tiles():
    cache = ek._OrderCache()
    far_n = torch.tensor([3, 9, 12], dtype=torch.int32)
    assert cache(far_n, None, 8, (16, 8)).tolist() == [1, 2, 0]
    first = cache(far_n, None, 8, (16, 8))
    assert cache(far_n, None, 8, (16, 8)) is first
    assert cache(far_n, None, 8).tolist() == [2, 1, 0]


def test_cols_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="unsupported device"):
        ek.cols_launch(torch.zeros(3, 64), torch.zeros(64),
                       torch.zeros(1, 8, 8), torch.zeros(1, dtype=torch.int32),
                       None, 0, 0.02, G=1.0, softening=1.0, group_size=64,
                       window_groups=2, tau_clamp=24.0, far_tile=8,
                       targets=2)


def test_eval_tiles_names_the_cols_instances():
    new = ("_ZN12_GLOBAL__N_123window_eval_cols_kernelILi10ELi2EEEvPKfS2_"
           "S2_PKiS4_S4_Pfiiiiiiffff")
    old = ("_ZN12_GLOBAL__N_123window_eval_cols_kernelILi8ELi256EEEvPKfS2_"
           "S2_PKiS4_Pfiiiiiiffff")
    assert eval_tiles.instance(new) == "cols R=10 T=2"
    assert eval_tiles.instance(old, previous=True) == \
        "cols R=8 (previous, <=256 threads)"
    assert eval_tiles.instance("_ZN12window_eval_cols_kernelILi8EEEv") is None
    assert "window_eval_cols.cu" in eval_tiles.PARENT_SIGNATURES


def test_ptxas_table_reads_registers_and_spills():
    log = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123window_eval_\
cols_kernelILi10ELi4EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123window_eval_cols
    0 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Used 12 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123window_eval_\
cols_kernelILi8ELi1EEEvPKf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers
"""
    assert eval_tiles.ptxas_table(log) == {"cols R=10 T=4": (255, 16, 24),
                                           "_Z5otherv": (12, 0, 0),
                                           "cols R=8 T=1": (72, 0, 0)}



def test_sass_differences_compare_kernels_addresses_aside():
    """Two ``cuobjdump -sass`` texts: a kernel with the same instructions
    at other addresses, in an anonymous namespace of another hash, is the
    same; one with another instruction differs, one missing from the
    second differs; a kernel new in the second is not one of the
    first's."""
    def dump(funcs):
        return "\n".join(
            f"\t\tFunction : {name}\n" + "\n".join(
                f"        /*{a:04x}*/                   {t} ;"
                for a, t in insns) for name, insns in funcs.items())
    anon = "_ZN51_GLOBAL__N__{}_18_probes_decide15_cu_3bdf267912empty_kernelEv"
    old = {"_Z1av": [(0, "MOV R1, c[0x0][0x28]"), (16, "EXIT")],
           anon.format("c65e893c"): [(0, "EXIT")],
           "_Z1bv": [(0, "LDG.E R2, desc[UR4][R2.64]"), (16, "EXIT")],
           "_Z1cv": [(0, "EXIT")]}
    new = {"_Z1av": [(32, "MOV R1, c[0x0][0x28]"), (48, "EXIT")],
           anon.format("41a9956a"): [(0, "EXIT")],
           "_Z1bv": [(0, "LDG.E.CONSTANT R2, desc[UR4][R2.64]"),
                     (16, "EXIT")],
           "_Z1dv": [(0, "EXIT")]}
    assert same_sass.sass_differences(dump(old), dump(new)) == (
        ["_Z1av", "_ZN51_GLOBAL__N__18_probes_decide15_cu_3bdf267912empty_"
         "kernelEv", "_Z1bv", "_Z1cv"], ["_Z1bv", "_Z1cv"])
    assert same_sass.sass_differences(dump(old), dump(old))[1] == []


def test_show_loops_prints_the_innermost_loops():
    """``same_sass --show`` reads the innermost loops of the named kernels
    off a ``cuobjdump -sass`` dump: a loop inside another is listed, the
    outer one is not, nor an unconditional jump back; a kernel without a
    loop lists none; other kernels are skipped."""
    insns = ["MOV R1, c[0x0][0x28]", "IADD3 R2, R2, 0x1, RZ",
             "SHFL.IDX PT, R3, R3, R2, 0x1f", "@P0 BRA 0x10",
             "@P1 BRA 0x0", "EXIT", "BRA 0x20"]
    dump = "\n".join(
        [f"\t\tFunction : {name}\n" + "\n".join(
            f"        /*{16 * i:04x}*/                   {t} ;"
            for i, t in enumerate(body))
         for name, body in (("_Z5chainv", insns), ("_Z4flatv", ["EXIT"]),
                            ("_Z5otherv", insns))])
    lines = []
    assert same_sass.show_loops(dump, ["chain", "flat"], lines.append) == 2
    assert lines == ["kernel _Z5chainv: 7 instructions",
                     "  loop 0x0010-0x0030: 3 instructions",
                     "    IADD3 R2, R2, 0x1, RZ",
                     "    SHFL.IDX PT, R3, R3, R2, 0x1f",
                     "    @P0 BRA 0x10",
                     "kernel _Z4flatv: 1 instructions"]


@pytest.fixture(scope="module")
def stub_binding(tmp_path_factory):
    """The launch binding compiled on the host against stub entry points
    that record their arguments (in ``last``, as doubles) and return 7."""
    import shutil
    import subprocess
    d = tmp_path_factory.mktemp("binding")
    ctype = {ctypes.c_void_p: "void*", ctypes.c_int: "int",
             ctypes.c_float: "float"}
    stubs = ['extern "C" { double last[64]; }']
    for name, argtypes in _kernels.SIGNATURES.items():
        params = ", ".join(f"{ctype[t]} a{i}" for i, t in enumerate(argtypes))
        body = " ".join(
            f"last[{i}] = (double)(unsigned long long)a{i};"
            if t is ctypes.c_void_p else f"last[{i}] = (double)a{i};"
            for i, t in enumerate(argtypes))
        stubs.append(f'extern "C" int {name}({params}) {{ {body} '
                     f"return 7; }}")
    (d / "stubs.cpp").write_text("\n".join(stubs) + "\n")
    (d / "binding.cpp").write_text(_kernels.binding_source())
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler builds the binding's test"
    so = d / "libstub_binding.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-I",
                    _kernels.python_include(), "-o", str(so),
                    str(d / "binding.cpp"), str(d / "stubs.cpp")],
                   check=True, capture_output=True, text=True)
    mod = _kernels.load_binding(so)
    last = (ctypes.c_double * 64).in_dll(ctypes.CDLL(str(so)), "last")
    return mod, last


@pytest.mark.parametrize("name", sorted(_kernels.SIGNATURES))
def test_binding_passes_every_argument_by_its_kind(stub_binding, name):
    """Each function of the binding calls its entry point with the values
    it was given: a pointer above 2^32 whole (None as 0), a negative int,
    a float rounded to float32; and returns the entry point's result."""
    mod, last = stub_binding
    argtypes = _kernels.SIGNATURES[name]
    args, want = [], []
    for i, t in enumerate(argtypes):
        if t is ctypes.c_void_p:
            v = None if i % 3 == 2 else 0x7F12_3456_7000 + 16 * i
            args.append(v)
            want.append(0.0 if v is None else float(v))
        elif t is ctypes.c_int:
            args.append(-1000 - i)
            want.append(float(-1000 - i))
        else:
            args.append(0.1 * (i + 1))
            want.append(float(ctypes.c_float(0.1 * (i + 1)).value))
    assert getattr(mod, name)(*args) == 7
    assert list(last[:len(args)]) == want


def test_binding_refuses_what_ctypes_refused(stub_binding):
    mod, _ = stub_binding
    with pytest.raises(TypeError, match="takes 4 arguments"):
        mod.spatialsim_probe_roll(1, 2, 3)
    with pytest.raises(TypeError):
        mod.spatialsim_probe_roll(1, 2.5, 3, 4)      # a float for an int
    with pytest.raises(TypeError):
        mod.spatialsim_probe_roll("x", 2, 3, 4)      # not a pointer
    with pytest.raises(OverflowError):
        mod.spatialsim_probe_roll(1, 2 ** 40, 3, 4)  # past a C int
    assert mod.spatialsim_allpairs_occupancy(1, True, 3, 0) == 7
