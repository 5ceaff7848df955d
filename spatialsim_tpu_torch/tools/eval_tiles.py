"""SASS readings of the window-eval, all-pairs and boids kernels on the
card, and the previous kernels that ``chip_smoke.py`` times beside them.

    python -m spatialsim_tpu_torch.tools.eval_tiles [--sass-out DIR]

builds the kernel library, prints the SASS instructions a pair of every
instance of ``csrc/window_eval_pool.cu``, ``csrc/window_eval.cu``,
``csrc/window_eval_cols.cu``, ``csrc/window_eval_mxu.cu`` (with its HMMA
a pair), ``csrc/allpairs.cu`` and ``csrc/boids_window.cu`` (and of the
previous
versions whose sources lie in ``_build/parent/``: ``PARENT_SIGNATURES``
names them), and with ``--sass-out`` writes each instance's inner loops
there.  ``chip_smoke.py`` (phases 1, 2, 3, 7, 11, 13 and 17) calls the
same functions at the main path's shapes.

Instructions a pair come from the SASS (``cuobjdump -sass`` of the built
library; ``nvdisasm`` is not needed).  For the window evals and the
all-pairs kernel: in each innermost loop that holds a MUFU.RSQ, the
instructions from the loop's head to its back branch over the MUFU.RSQ in
it (one a pair).  The boids kernel has no MUFU in its hot loop; for it
(:func:`boids_counts`) a chunk's 32 x T distance tests are one
straight-line block, the function's longest: "test" is that block over
its 32 T pairs, "pair" one loop iteration over a tested chunk on the path
where no pair is a neighbour (cull, mask checks and loop control
included) over the same pairs, and "skipped" the instructions of
a chunk the cull skips.
The previous boids kernel's "pair" is its source loop's iteration on the
no-neighbour path over the position loads (LDS.128, one a pair) on it.
At one warp instruction a clock on each of an SM's four schedulers, an
H100 SXM issues 132 x 4 x 32 x 1.98e9 = 33.5e12 thread instructions a
second: the issue-limited time of a call is its pairs times the count
over that rate.  Each pair of a window eval also takes one MUFU.RSQ, at 16
a clock an SM: 132 x 16 x 1.98e9 = 4.18e12 a second, the MUFU floor.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import re
import shutil
import subprocess
from pathlib import Path

from spatialsim_tpu_torch import _kernels

# Thread instructions a second an H100 SXM issues (132 SMs, 4 schedulers
# of 32 lanes, 1.98 GHz boost clock: NVIDIA's data sheet).
ISSUE_RATE = 132 * 4 * 32 * 1.98e9
# MUFU.RSQ a second (16 a clock on each of 132 SMs at 1.98 GHz).
MUFU_RATE = 132 * 16 * 1.98e9
PARENT_DIR = _kernels.BUILD_DIR / "parent"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The previous kernels' C interfaces (one thread a target, no T, no order,
# no split), by source file: the window evals (row forms, then the column
# and matrix forms) before their redesign, the all-pairs and boids kernels
# before theirs.
PARENT_SIGNATURES = {
    "window_eval_pool.cu": ("spatialsim_window_eval_pool", (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P)),
    "window_eval.cu": ("spatialsim_window_eval", (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F,
        _P)),
    "allpairs.cu": ("spatialsim_allpairs", (_P, _P, _P, _I, _F, _F, _P)),
    "boids_window.cu": ("spatialsim_boids_window", (
        _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _P)),
    "window_eval_cols.cu": ("spatialsim_window_eval_cols", (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
        _F, _P)),
    "window_eval_mxu.cu": ("spatialsim_window_eval_mxu", (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
        _F, _P)),
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


@functools.lru_cache(maxsize=4)
def _disassemble(lib_path) -> dict | None:
    """``parse_sass`` of the library's ``cuobjdump -sass`` (once per path,
    for the few libraries a run reads); None when no ``cuobjdump`` is
    found."""
    tool = _tool("cuobjdump")
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    return parse_sass(out)


def sass(lib_path) -> dict:
    """``{function: {"loops": [(instructions, MUFU.RSQ), ...],
    "per_pair": min instructions a pair, "hmma": HMMA a pair in that loop,
    "text": the loops' SASS}}`` for every function of the library with
    such a loop; {} when no ``cuobjdump`` is found."""
    res = {}
    for name, insns in (_disassemble(str(lib_path)) or {}).items():
        loops = inner_loops(insns)
        if not loops:
            continue
        text = "\n".join(
            f"/*{a:04x}*/ {t}" for lo, hi, _, _ in loops
            for a, t in insns if lo <= a <= hi)
        lo, hi, n, r = min(loops, key=lambda lp: lp[2] / lp[3])
        hmma = sum(t.startswith("HMMA") for a, t in insns if lo <= a <= hi)
        res[name] = dict(loops=[(n, r) for _, _, n, r in loops],
                         per_pair=n / r, hmma=hmma / r, text=text)
    return res


_ENDS_BLOCK = re.compile(r"\b(?:BRA|BRX|JMP|EXIT|RET|CALL)\b")


def _target(text: str) -> int | None:
    m = _BRA.search(text)
    return int(m.group(1), 16) if m else None


def basic_blocks(insns) -> list:
    """The branch-free runs of a function: a run ends at a branch, exit,
    return or call, and one starts at every branch target."""
    targets = {_target(t) for _, t in insns} - {None}
    blocks, cur = [], []
    for a, t in insns:
        if a in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append((a, t))
        if _ENDS_BLOCK.search(t):
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    return blocks


def _walk(insns, head, back, test, take_first_skip=False):
    """The instructions one iteration of the loop [head, back] issues on
    the path where no pair is a neighbour: a conditional forward branch
    over the ``test`` block (a chunk skip) is not taken, except the first
    with ``take_first_skip``; one over an LDS.64 (the neighbour sums read
    the colours' (cy, cz) so) is taken; others are not.  NOPs not
    counted."""
    at = {a: i for i, (a, _) in enumerate(insns)}
    i, path, skips = at[head], [], 0
    while True:
        a, t = insns[i]
        if not t.startswith("NOP"):
            path.append((a, t))
        if a == back or len(path) > len(insns):
            return path
        tgt = _target(t)
        if tgt is not None and tgt > a:
            if not t.startswith("@"):
                i = at[tgt]
                continue
            skipped = [x for x in insns if a < x[0] < tgt]
            over_test = test is not None and any(x[0] == test for x in skipped)
            if over_test:
                skips += 1
                if take_first_skip and skips == 1:
                    i = at[tgt]
                    continue
            elif any(x[1].startswith("LDS.64") for x in skipped):
                i = at[tgt]
                continue
        i += 1


def boids_counts(insns, targets=None) -> dict | None:
    """SASS counts of a boids window kernel's distance tests.

    For the redesigned kernel (``targets`` T): the test block is the
    function's longest basic block (a chunk's 32 x T tests, straight-line
    code) and the chunk loop the innermost loop around it.  ``test``: the
    test block's instructions over its 32 T pairs; ``pair``: one tested
    chunk's loop iteration on the path with no neighbour (the cull, the
    mask checks and the loop control included) over its 32 T pairs;
    ``skipped``: the instructions of a chunk the cull skips, None without
    the cull.  For the previous kernel (``targets`` None): ``pair`` is its
    source loop's iteration on the no-neighbour path over the LDS.128
    position loads on that path (one a pair); ``test`` and ``skipped``
    are None.
    None when the function has no such loop.
    """
    loops = [(_target(t), a) for a, t in insns
             if _target(t) is not None and _target(t) <= a]
    if targets is not None:
        block = max(basic_blocks(insns),
                    key=lambda b: sum(not t.startswith("NOP") for _, t in b))
        lo, hi = block[0][0], block[-1][0]
        around = [lp for lp in loops if lp[0] <= lo and hi <= lp[1]]
        if not around:
            return None
        head, back = min(around, key=lambda lp: lp[1] - lp[0])
        pairs = 32 * targets
        n_test = sum(not t.startswith("NOP") for _, t in block)
        tested = _walk(insns, head, back, lo)
        culled = _walk(insns, head, back, lo, take_first_skip=True)
        return dict(test=n_test / pairs, pair=len(tested) / pairs,
                    skipped=(len(culled) if len(culled) < len(tested)
                             else None), loop=(head, back))
    best = None
    for head, back in loops:
        body = [t for a, t in insns if head <= a <= back]
        if not any(t.startswith("LDS.64") for t in body):
            continue
        path = _walk(insns, head, back, None)
        loads = sum(t.startswith("LDS.128") for _, t in path)
        if loads and (best is None or loads > best[1]):
            best = (len(path), loads, (head, back))
    if best is None:
        return None
    return dict(test=None, pair=best[0] / best[1], skipped=None,
                loop=best[2])


def boids_sass(lib_path, previous: bool = False) -> dict:
    """``{label: (counts, SASS text of the loop)}`` of the boids window
    kernels of a library (:func:`boids_counts`); {} without
    ``cuobjdump``."""
    res = {}
    for name, insns in (_disassemble(str(lib_path)) or {}).items():
        label = instance(name, previous)
        if label is None or not label.startswith("boids"):
            continue
        m = re.match(r"boids T=(\d+)", label)
        rec = boids_counts(insns, int(m.group(1)) if m else None)
        if rec is not None:
            head, back = rec["loop"]
            res[label] = (rec, "\n".join(f"/*{a:04x}*/ {t}" for a, t in insns
                                         if head <= a <= back))
    return res


def instance(name: str, previous: bool = False) -> str | None:
    """A label for a kernel's mangled name (``pool T=4``, ``dense R=8
    T=4``, its ablation instance ``dense R=8 T=4 dbg``, ``cols R=10
    T=2``, ``mxu R=10 fma T=2``, ``mxu R=10 mma M=4``,
    ``allpairs T=4``, ``allpairs_at T=2``, ``boids T=2 cull on pass 1``;
    of the previous kernels ``pool (previous)``, ``dense R=8 (previous,
    <=1024 threads)``, ``cols R=10 (previous, <=256 threads)``, ``mxu
    R=10 (previous, <=256 threads)``, ``allpairs (previous)``, ``boids
    (previous)``), None for other kernels."""
    if "allpairs_at_kernel" in name:
        m = re.search(r"allpairs_at_kernelILi(\d+)EE", name)
        return None if previous or not m else f"allpairs_at T={m.group(1)}"
    if "allpairs_kernel" in name:
        m = re.search(r"allpairs_kernelILi(\d+)EE", name)
        return ("allpairs (previous)" if previous or not m
                else f"allpairs T={m.group(1)}")
    if "boids_window_kernel" in name:
        m = re.search(r"boids_window_kernelILi(\d+)ELb([01])ELb([01])EE",
                      name)
        if previous or not m:
            return "boids (previous)"
        return (f"boids T={m.group(1)} cull "
                f"{'on' if m.group(2) == '1' else 'off'} pass "
                f"{2 if m.group(3) == '1' else 1}")
    if "window_eval_cols_kernel" in name:
        m = re.search(r"window_eval_cols_kernelILi(\d+)ELi(\d+)EE", name)
        if m is None:
            return None
        return (f"cols R={m.group(1)} (previous, <={m.group(2)} threads)"
                if previous else f"cols R={m.group(1)} T={m.group(2)}")
    if "window_eval_mxu" in name:
        m = re.search(r"window_eval_mxu_(tile|mma)_kernelILi(\d+)ELi(\d+)E"
                      r"(?:Li(\d+)E)?", name)
        if m is not None and not previous:
            kind = "fma T" if m.group(1) == "tile" else "mma M"
            big = ("" if m.group(4) in (None, "256")
                   else f" (<={m.group(4)} threads)")
            return f"mxu R={m.group(2)} {kind}={m.group(3)}{big}"
        m = re.search(r"window_eval_mxu_kernelILi(\d+)ELi(\d+)EE", name)
        if m is None or not previous:
            return None
        return f"mxu R={m.group(1)} (previous, <={m.group(2)} threads)"
    if "window_eval_pool_kernel" in name:
        m = re.search(r"window_eval_pool_kernelILi(\d+)EE", name)
        return ("pool (previous)" if previous or not m
                else f"pool T={m.group(1)}")
    m = re.search(r"window_eval_kernelILi(\d+)ELi(\d+)E(?:Lb([01])E)?E",
                  name)
    if m is None:
        return None
    if previous:
        return f"dense R={m.group(1)} (previous, <={m.group(2)} threads)"
    dbg = " dbg" if m.group(3) == "1" else ""
    return f"dense R={m.group(1)} T={m.group(2)}{dbg}"


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_table(log: str, previous: bool = False) -> dict:
    """``{label: (registers, spill store bytes, spill load bytes)}`` of
    every kernel in an ``nvcc -Xptxas -v`` log, by its :func:`instance`
    label, else by its mangled name."""
    res, label, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            label = instance(m.group(1), previous) or m.group(1)
            spill = (0, 0)
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = _PTXAS_REGS.search(line)
        if m and label is not None:
            res[label] = (int(m.group(1)), *spill)
            label = None
    return res


def sass_table(lib_path, previous: bool = False) -> dict:
    """``{label: (instructions a pair, the loops' SASS)}`` of the
    window-eval kernels of a library."""
    res = {}
    for name, rec in sass(lib_path).items():
        label = instance(name, previous)
        if label is not None:
            res[label] = (rec["per_pair"], rec["loops"], rec["text"])
    return res


def hmma_table(lib_path, previous: bool = False) -> dict:
    """``{label: HMMA a pair}`` of the window-eval kernels of a library, in
    the loop :func:`sass_table`'s count is taken from (0 without tensor
    cores)."""
    res = {}
    for name, rec in sass(lib_path).items():
        label = instance(name, previous)
        if label is not None:
            res[label] = rec["hmma"]
    return res


_parent = None


def parent_library():
    """The previous kernels built from the sources of
    ``PARENT_SIGNATURES`` that lie in ``_build/parent/``; None when there
    are none.  ``lib.entries`` names the C entry points it holds."""
    global _parent
    srcs = [PARENT_DIR / f for f in PARENT_SIGNATURES
            if (PARENT_DIR / f).exists()]
    if not srcs:
        return None
    if _parent is None:
        so = PARENT_DIR / "libparent_kernels.so"
        subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared",
                        "-o", str(so), *map(str, srcs)], check=True,
                       capture_output=True, text=True)
        lib = _kernels.bind(ctypes.CDLL(str(so)), dict(
            PARENT_SIGNATURES[src.name] for src in srcs))
        lib.entries = {PARENT_SIGNATURES[src.name][0] for src in srcs}
        lib.path = so
        _parent = lib
    return _parent


def has_parent(lib, entry: str) -> bool:
    """Whether the previous-kernel library ``lib`` (or None) holds the C
    entry point ``spatialsim_<entry>``."""
    return lib is not None and f"spatialsim_{entry}" in lib.entries


def parent_allpairs(lib, pos, mass, G, softening):
    """The previous all-pairs kernel on the same inputs as
    ``allpairs_accel``."""
    import torch
    out = torch.empty_like(pos)
    _kernels.check(lib.spatialsim_allpairs(
        pos.data_ptr(), mass.data_ptr(), out.data_ptr(), pos.shape[1],
        float(G), float(softening) ** 2, _kernels.stream(pos)),
        "previous allpairs")
    return out


def parent_boids(lib, s_pos, s_vel, s_col, s_grpf=None, *, gsz, wg,
                 perception_sq, separation_sq, prev_wg=None, targets=1,
                 cull=True):
    """The previous boids window kernel (``npad``, T and cull in place of
    the modes' ``(ng, g0, ngs)``) on the same inputs as
    ``boids_window_launch``, at the instance ``targets``/``cull``."""
    import torch
    npad = s_pos.shape[1]
    out = torch.empty((14, npad), dtype=torch.float32, device=s_pos.device)
    _kernels.check(lib.spatialsim_boids_window(
        s_pos.data_ptr(), s_vel.data_ptr(), s_col.data_ptr(),
        None if s_grpf is None else s_grpf.data_ptr(), out.data_ptr(), npad,
        gsz, wg, float(perception_sq), float(separation_sq),
        float(prev_wg if prev_wg is not None else wg), int(targets),
        int(bool(cull)), _kernels.stream(s_pos)), "previous boids_window")
    return out


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
        _kernels.stream(s_pos)), "previous window_eval_pool")
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
        _kernels.stream(s_pos)), "previous window_eval")
    return out


def parent_cols(lib, s_pos, s_mass, far, far_n, near, steps_since, dt, *,
                G, softening, group_size, window_groups, tau_clamp, far_tile):
    """The previous column kernel on the same inputs as
    ``window_eval_cols``."""
    import torch
    from spatialsim_tpu_torch.ops.bh_eval_kernel import advance_coefs
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    out = torch.empty_like(s_pos)
    npad = s_pos.shape[1]
    K = 0 if near is None else near.shape[1]
    _kernels.check(lib.spatialsim_window_eval_cols(
        s_pos.data_ptr(), s_mass.data_ptr(), far.data_ptr(),
        far_n.data_ptr(), near.data_ptr() if K else None, out.data_ptr(),
        npad, npad // group_size, group_size, window_groups, K, far.shape[1],
        far.shape[2], min(int(far_tile), far.shape[2]),
        float(softening) ** 2, float(G), tau, coef2, _kernels.stream(s_pos)),
        "previous window_eval_cols")
    return out


def parent_mxu(lib, s_pos, s_mass, far, far_n, near, steps_since, dt, *,
               G, softening, group_size, window_groups, tau_clamp, far_tile):
    """The previous matrix kernel (one thread a target, no tensor cores)
    on the same inputs as ``window_eval_mxu``."""
    import torch
    from spatialsim_tpu_torch.ops.bh_eval_kernel import advance_coefs
    tau, coef2 = advance_coefs(steps_since, dt, tau_clamp)
    out = torch.empty_like(s_pos)
    npad = s_pos.shape[1]
    K = 0 if near is None else near.shape[1]
    _kernels.check(lib.spatialsim_window_eval_mxu(
        s_pos.data_ptr(), s_mass.data_ptr(), far.data_ptr(),
        far_n.data_ptr(), near.data_ptr() if K else None, out.data_ptr(),
        npad, npad // group_size, group_size, window_groups, K, far.shape[1],
        far.shape[2], min(int(far_tile), far.shape[2]),
        float(softening) ** 2, float(G), tau, coef2, _kernels.stream(s_pos)),
        "previous window_eval_mxu")
    return out


def boids_line(label, rec) -> str:
    """One line of a boids instance's SASS counts."""
    test = "" if rec["test"] is None else f"test block {rec['test']:.3f}, "
    skip = ("" if rec["skipped"] is None
            else f", a skipped chunk {rec['skipped']} instructions")
    return (f"{label}: {test}{rec['pair']:.3f} instructions a tested pair "
            f"(no-neighbour path){skip}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sass-out", type=Path,
                   help="write each instance's inner loops' SASS here")
    args = p.parse_args(argv)
    libs = [(_kernels.build(), False)]
    parent = parent_library()
    if parent is not None:
        libs.append((parent.path, True))

    def keep(label, text):
        if args.sass_out:
            args.sass_out.mkdir(parents=True, exist_ok=True)
            fn = re.sub(r"[^A-Za-z0-9=.]+", "_", label) + ".sass"
            (args.sass_out / fn).write_text(text + "\n")
    for path, previous in libs:
        hmma = hmma_table(path, previous)
        for label, (per_pair, loops, text) in sorted(
                sass_table(path, previous).items()):
            extra = (f", {hmma[label]:.3f} HMMA a pair" if hmma.get(label)
                     else "")
            print(f"{label}: {per_pair:.3f} instructions a pair (innermost "
                  f"loops, instructions / MUFU.RSQ: {loops}){extra}")
            keep(label, text)
        for label, (rec, text) in sorted(boids_sass(path, previous).items()):
            print(boids_line(label, rec))
            keep(label, text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
