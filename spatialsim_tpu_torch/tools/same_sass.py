"""Whether the kernels of one CUDA source keep their SASS in another
version of it, instruction for instruction.

    python -m spatialsim_tpu_torch.tools.same_sass OLD.cu NEW.cu

compiles both with the kernel library's ``nvcc`` flags (``-cubin``),
disassembles them with ``cuobjdump -sass``, prints each kernel of OLD
whose instructions (addresses aside) differ in NEW or are missing there,
then how many of OLD's kernels are the same; exits 1 where one differs.
Needs ``nvcc``.  A redesign that adds a kernel beside an old one checks
with it that the old one was left as it was.
"""

import argparse
import re
import subprocess
import tempfile
from pathlib import Path

from spatialsim_tpu_torch import _kernels
from spatialsim_tpu_torch.tools.eval_tiles import _tool, parse_sass

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


def same_sass(old_src, new_src, out=print) -> bool:
    """Compile and compare two versions of a source (:func:`
    sass_differences`); print each kernel of ``old_src`` that differs,
    then the count; True when every one is the same."""
    nvcc, tool = _kernels._nvcc(), _tool("cuobjdump")
    texts = []
    with tempfile.TemporaryDirectory() as d:
        for i, src in enumerate((old_src, new_src)):
            cubin = Path(d) / f"{i}.cubin"
            subprocess.run([nvcc, *_kernels.NVCC_FLAGS, "-cubin", "-o",
                            str(cubin), str(src)], check=True,
                           capture_output=True)
            texts.append(subprocess.run([tool, "-sass", str(cubin)],
                                        capture_output=True, text=True,
                                        check=True).stdout)
    kernels, differ = sass_differences(*texts)
    for name in differ:
        out(f"SASS differs: {name}")
    out(f"{len(kernels) - len(differ)} of {len(kernels)} kernels of "
        f"{old_src} have the same SASS, instruction for instruction, in "
        f"{new_src}")
    return not differ


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("old", type=Path)
    p.add_argument("new", type=Path)
    a = p.parse_args(argv)
    return 0 if same_sass(a.old, a.new) else 1


if __name__ == "__main__":
    raise SystemExit(main())
