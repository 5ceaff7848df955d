"""SASS readings of the window-eval kernels on the card, and the
previous kernels (one thread a target) that ``chip_smoke.py`` times beside
them.

    python -m spatialsim_tpu_torch.tools.eval_tiles [--sass-out DIR]

builds the kernel library, prints the SASS instructions a pair of every
instance of ``csrc/window_eval_pool.cu`` and ``csrc/window_eval.cu`` (and
of a previous version of the two, when its sources lie in
``_build/parent/``), and with ``--sass-out`` writes each instance's inner
loops there.  ``chip_smoke.py`` (phases 1, 3, 11 and 13) calls the same
functions at the main path's shapes.

Instructions a pair come from the SASS (``cuobjdump -sass`` of the built
library; ``nvdisasm`` is not needed): in each innermost loop that holds a
MUFU.RSQ, the instructions from the loop's head to its back branch over
the MUFU.RSQ in it (one a pair).  At one warp instruction a clock on each
of an SM's four schedulers, an H100 SXM issues 132 x 4 x 32 x 1.98e9 =
33.5e12 thread instructions a second: the issue-limited time of a call is
its pairs times the count over that rate.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

from spatialsim_tpu_torch import _kernels

# Thread instructions a second an H100 SXM issues (132 SMs, 4 schedulers
# of 32 lanes, 1.98 GHz boost clock: NVIDIA's data sheet).
ISSUE_RATE = 132 * 4 * 32 * 1.98e9
PARENT_DIR = _kernels.BUILD_DIR / "parent"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The previous C interface: one thread a target, no T, no order.
PARENT_SIGNATURES = {
    "spatialsim_window_eval_pool": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _F, _F, _F, _F, _P),
    "spatialsim_window_eval": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _F, _F, _F, _F, _P),
}

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")
_BRA = re.compile(r"\bBRA(?:\.[A-Z.]+)?\s+0x([0-9a-f]+)")


def _tool(name: str) -> str | None:
    """A CUDA binary tool: the toolkit's, else the copy in Triton's
    package."""
    try:
        beside = Path(_kernels._nvcc()).with_name(name)
        if beside.exists():
            return str(beside)
    except RuntimeError:
        pass
    found = shutil.which(name)
    if found:
        return found
    try:
        import triton
    except ImportError:
        return None
    p = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / name
    return str(p) if p.exists() else None


def parse_sass(text: str) -> dict:
    """``{function: [(address, instruction), ...]}`` of ``cuobjdump -sass``
    output."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def inner_loops(insns) -> list:
    """The innermost loops that hold a MUFU.RSQ: ``(head, back branch,
    instructions, MUFU.RSQ)`` for each, NOPs not counted."""
    loops = []
    for addr, text in insns:
        m = _BRA.search(text)
        if m and int(m.group(1), 16) <= addr:
            lo = int(m.group(1), 16)
            body = [t for a, t in insns if lo <= a <= addr
                    and not t.startswith("NOP")]
            rsq = sum("MUFU.RSQ" in t for t in body)
            if rsq:
                loops.append((lo, addr, len(body), rsq))
    return [lp for lp in loops
            if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1]
                       and (o[0], o[1]) != (lp[0], lp[1]) for o in loops)]


def sass(lib_path) -> dict:
    """``{function: {"loops": [(instructions, MUFU.RSQ), ...],
    "per_pair": min instructions a pair, "text": the loops' SASS}}`` for
    every function of the library with such a loop; {} when no
    ``cuobjdump`` is found."""
    tool = _tool("cuobjdump")
    if tool is None:
        return {}
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    res = {}
    for name, insns in parse_sass(out).items():
        loops = inner_loops(insns)
        if not loops:
            continue
        text = "\n".join(
            f"/*{a:04x}*/ {t}" for lo, hi, _, _ in loops
            for a, t in insns if lo <= a <= hi)
        res[name] = dict(loops=[(n, r) for _, _, n, r in loops],
                         per_pair=min(n / r for _, _, n, r in loops),
                         text=text)
    return res


def instance(name: str, previous: bool = False) -> str | None:
    """A label for a window-eval kernel's mangled name (``pool T=4``,
    ``dense R=8 T=4``; of the previous kernels ``pool (previous)``,
    ``dense R=8 (previous, <=1024 threads)``), None for other kernels."""
    if "window_eval_pool_kernel" in name:
        m = re.search(r"window_eval_pool_kernelILi(\d+)EE", name)
        return ("pool (previous)" if previous or not m
                else f"pool T={m.group(1)}")
    m = re.search(r"window_eval_kernelILi(\d+)ELi(\d+)EE", name)
    if m is None:
        return None
    return (f"dense R={m.group(1)} (previous, <={m.group(2)} threads)"
            if previous else f"dense R={m.group(1)} T={m.group(2)}")


def sass_table(lib_path, previous: bool = False) -> dict:
    """``{label: (instructions a pair, the loops' SASS)}`` of the
    window-eval kernels of a library."""
    res = {}
    for name, rec in sass(lib_path).items():
        label = instance(name, previous)
        if label is not None:
            res[label] = (rec["per_pair"], rec["loops"], rec["text"])
    return res


_parent = None


def parent_library():
    """The previous kernels (one thread a target), built from
    ``_build/parent/window_eval_pool.cu`` and ``window_eval.cu`` when both
    are there; None otherwise."""
    global _parent
    srcs = [PARENT_DIR / "window_eval_pool.cu", PARENT_DIR / "window_eval.cu"]
    if not all(p.exists() for p in srcs):
        return None
    if _parent is None:
        so = PARENT_DIR / "libparent_kernels.so"
        subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared",
                        "-o", str(so), *map(str, srcs)], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in PARENT_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.path = so
        _parent = lib
    return _parent


def parent_pool(lib, s_pos, s_mass, pool, pstart, far_n, steps_since, dt, *,
                G, softening, group_size, window_groups, tau_clamp):
    """The previous pooled kernel on the same inputs as
    ``window_eval_pool``."""
    import torch
    from spatialsim_tpu_torch.ops.bh_eval_kernel import advance_coefs
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    out = torch.empty_like(s_pos)
    ct, _, tile = pool.shape
    npad = s_pos.shape[1]
    _kernels.check(lib.spatialsim_window_eval_pool(
        s_pos.data_ptr(), s_mass.data_ptr(), pool.data_ptr(),
        pstart.data_ptr(), far_n.data_ptr(), out.data_ptr(), npad,
        npad // group_size, group_size, window_groups, ct, tile,
        float(softening) ** 2, float(G), tau, coef2,
        _kernels.stream_ptr(s_pos.device)), "previous window_eval_pool")
    return out


def parent_dense(lib, s_pos, s_mass, far, far_n, near, steps_since, dt, *,
                 G, softening, group_size, window_groups, tau_clamp):
    """The previous dense row-form kernel on the same inputs as
    ``window_eval``."""
    import torch
    from spatialsim_tpu_torch.ops.bh_eval_kernel import advance_coefs
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    out = torch.empty_like(s_pos)
    npad = s_pos.shape[1]
    K = 0 if near is None else near.shape[1]
    _kernels.check(lib.spatialsim_window_eval(
        s_pos.data_ptr(), s_mass.data_ptr(), far.data_ptr(),
        far_n.data_ptr(), near.data_ptr() if K else None, out.data_ptr(),
        npad, npad // group_size, group_size, window_groups, K, far.shape[1],
        far.shape[2], float(softening) ** 2, float(G), tau, coef2,
        _kernels.stream_ptr(s_pos.device)), "previous window_eval")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sass-out", type=Path,
                   help="write each instance's inner loops' SASS here")
    args = p.parse_args(argv)
    libs = [(_kernels.build(), False)]
    parent = parent_library()
    if parent is not None:
        libs.append((parent.path, True))
    for path, previous in libs:
        for label, (per_pair, loops, text) in sorted(
                sass_table(path, previous).items()):
            print(f"{label}: {per_pair:.3f} instructions a pair (innermost "
                  f"loops, instructions / MUFU.RSQ: {loops})")
            if args.sass_out:
                args.sass_out.mkdir(parents=True, exist_ok=True)
                fn = re.sub(r"[^A-Za-z0-9=.]+", "_", label) + ".sass"
                (args.sass_out / fn).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
