"""What the harness loads: nothing of JAX or the JAX package, and the
reference nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench.run import forbidden_modules

HERE = Path(__file__).resolve().parents[1]
# The yardstick: the plain reference and what it shares with the
# harness's arithmetic.
REFERENCE = ("reference.py", "galaxy.py", "kernel2.py", "peaks.py",
             "trace.py", "catalog.py")


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_top_level_names_compared_whole():
    assert forbidden_modules(["spatialsim_tpu_torch",
                              "spatialsim_tpu_torch.ops.colors",
                              "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["spatialsim_tpu.ops", "jax.numpy", "jaxlib",
                              "flax.linen"]) == [
        "flax", "jax", "jaxlib", "spatialsim_tpu"]


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not forbidden_modules(_imports(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for name in REFERENCE:
        bad = {m for m in _imports(HERE / name)
               if m.split(".")[0] == "spatialsim_tpu_torch"}
        assert not bad, (name, bad)


def test_a_run_process_loads_no_jax():
    code = ("import sys, portbench.run, portbench.frames, portbench.control;"
            "import spatialsim_tpu_torch.models.nbody,"
            " spatialsim_tpu_torch.ops.bh_window;"
            "print(portbench.run.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
