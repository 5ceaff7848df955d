"""Whether the kernels of one CUDA source keep their SASS in another
version of it, instruction for instruction.

    python -m spatialsim_tpu_torch.tools.same_sass OLD.cu NEW.cu
    python -m spatialsim_tpu_torch.tools.same_sass SRC.cu --show NAME ...

compiles both with the kernel library's ``nvcc`` flags (``-cubin``),
disassembles them with ``cuobjdump -sass``, prints each kernel of OLD
whose instructions (addresses aside) differ in NEW or are missing there,
then how many of OLD's kernels are the same; exits 1 where one differs.
Needs ``nvcc``.  A redesign that adds a kernel beside an old one checks
with it that the old one was left as it was.  ``--show`` prints instead
the innermost loops of each kernel of SRC whose name holds a NAME, with
their instructions: what a step of a dependent chain issues, to be read
along its path.
"""

import argparse
import re
import subprocess
import tempfile
from pathlib import Path

from spatialsim_tpu_torch import _kernels
from spatialsim_tpu_torch.tools.eval_tiles import _target, _tool, parse_sass

# nvcc names a file's anonymous namespace with a hash that differs from
# one compiled file to another.
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def sass_differences(old_text: str, new_text: str) -> tuple:
    """``(kernels, differ)`` of two ``cuobjdump -sass`` outputs: the
    first's kernels, and those of them whose instructions (addresses
    aside) differ in the second or are missing there.  A kernel is named
    without its anonymous namespace's hash."""
    old, new = ({_ANON.sub("_GLOBAL__N__", name): [t for _, t in insns]
                 for name, insns in parse_sass(text).items()}
                for text in (old_text, new_text))
    return list(old), [name for name in old if old[name] != new.get(name)]


def innermost_loops(insns) -> list:
    """``(head, back branch, instructions)`` of each innermost loop of a
    kernel's ``(address, instruction)`` list: the spans from a predicated
    backward branch's target to the branch that hold no other such span
    (the unconditional jumps back are the divergent fallbacks of
    shuffles and the trailing self-loop)."""
    spans = []
    for addr, text in insns:
        target = _target(text)
        if target is not None and target <= addr and text.startswith("@"):
            spans.append((target, addr))
    return [(lo, hi, [t for a, t in insns if lo <= a <= hi])
            for lo, hi in spans
            if not any((o != (lo, hi)) and lo <= o[0] and o[1] <= hi
                       for o in spans)]


def _sass_of(src) -> str:
    """``cuobjdump -sass`` of ``src`` compiled with the library's flags."""
    nvcc, tool = _kernels._nvcc(), _tool("cuobjdump")
    with tempfile.TemporaryDirectory() as d:
        cubin = Path(d) / "k.cubin"
        subprocess.run([nvcc, *_kernels.NVCC_FLAGS, "-cubin", "-o",
                        str(cubin), str(src)], check=True,
                       capture_output=True)
        return subprocess.run([tool, "-sass", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout


def show_loops(text, names, out=print) -> int:
    """Print the innermost loops (:func:`innermost_loops`) of each kernel
    of a ``cuobjdump -sass`` output whose name holds one of ``names``;
    returns how many kernels matched."""
    found = 0
    for name, insns in parse_sass(text).items():
        if not any(n in name for n in names):
            continue
        found += 1
        out(f"kernel {_ANON.sub('_GLOBAL__N__', name)}: "
            f"{len(insns)} instructions")
        for lo, hi, body in innermost_loops(insns):
            out(f"  loop {lo:#06x}-{hi:#06x}: {len(body)} instructions")
            for t in body:
                out(f"    {t}")
    return found


def same_sass(old_src, new_src, out=print) -> bool:
    """Compile and compare two versions of a source (:func:`
    sass_differences`); print each kernel of ``old_src`` that differs,
    then the count; True when every one is the same."""
    kernels, differ = sass_differences(_sass_of(old_src), _sass_of(new_src))
    for name in differ:
        out(f"SASS differs: {name}")
    out(f"{len(kernels) - len(differ)} of {len(kernels)} kernels of "
        f"{old_src} have the same SASS, instruction for instruction, in "
        f"{new_src}")
    return not differ


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("old", type=Path)
    p.add_argument("new", type=Path, nargs="?")
    p.add_argument("--show", nargs="+", metavar="NAME",
                   help="print the innermost loops of OLD's kernels whose "
                        "names hold NAME")
    a = p.parse_args(argv)
    if a.show:
        return 0 if show_loops(_sass_of(a.old), a.show) else 1
    if a.new is None:
        p.error("NEW is needed without --show")
    return 0 if same_sass(a.old, a.new) else 1


if __name__ == "__main__":
    raise SystemExit(main())
