"""The port keeps its own copies of the JAX package's framework-neutral
modules and imports nothing of the JAX package.

* a source scan: no ``import spatialsim_tpu`` / ``from spatialsim_tpu``
  statement in ``spatialsim_tpu_torch/`` or ``chip_smoke.py`` (the
  subprocess test in ``test_torch_slice.py`` checks ``sys.modules``);
* the copies against their JAX-package originals: the verbatim copies'
  sources equal apart from the package name (``render/``, ``apps/world``,
  ``apps/input_handler``, ``tools/playback``, ``tools/export``,
  ``utils/logging``, ``io/``, ``config/``, ...), every initial-condition
  distribution bit-identical for a seed, equal presets, equal config
  defaults and ``resolve_config`` results, identical codec bytes, the
  same recorder helpers.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

from spatialsim_tpu import distributions as jax_distributions
from spatialsim_tpu import presets as jax_presets
from spatialsim_tpu.config import boids as jax_boids_cfg
from spatialsim_tpu.config import nbody as jax_nbody_cfg
from spatialsim_tpu.io import codec as jax_codec
from spatialsim_tpu_torch import distributions, presets
from spatialsim_tpu_torch.config import boids as boids_cfg
from spatialsim_tpu_torch.config import nbody as nbody_cfg
from spatialsim_tpu_torch.io import codec

ROOT = Path(__file__).resolve().parents[1]
_JAX_IMPORT = re.compile(
    r"^\s*(import\s+spatialsim_tpu\b(?!_torch)"
    r"|from\s+spatialsim_tpu(\s|\.)(?!_torch))", re.M)


def test_port_sources_import_nothing_of_the_jax_package():
    files = sorted((ROOT / "spatialsim_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _JAX_IMPORT.finditer(f.read_text())]
    assert not bad, bad


def test_source_scan_catches_jax_imports():
    for line in ("import spatialsim_tpu", "from spatialsim_tpu import io",
                 "    from spatialsim_tpu.config.nbody import NBODY"):
        assert _JAX_IMPORT.search(line), line
    for line in ("import spatialsim_tpu_torch",
                 "from spatialsim_tpu_torch.io import codec",
                 "# from spatialsim_tpu.io import codec"):
        assert not _JAX_IMPORT.search(line), line
    for line in ("import jax", "import jax.numpy as jnp",
                 "from jax.experimental import pallas as pl",
                 "    from scripts import decide15", "import scripts.eval_ab"):
        assert _JAX_OR_SCRIPTS.search(line), line
    for line in ("import jaxlib_free_module", "from scriptsx import y",
                 "# import jax"):
        assert not _JAX_OR_SCRIPTS.search(line), line


def test_scan_covers_the_parallel_port():
    """The multi-device modules and the digest tool are among the scanned
    sources (the scans above walk the whole package)."""
    names = {str(f.relative_to(ROOT))
             for f in (ROOT / "spatialsim_tpu_torch").rglob("*.py")}
    assert {f"spatialsim_tpu_torch/parallel/{m}.py"
            for m in ("__init__", "mesh", "collectives", "distsort",
                      "sharded", "launch", "dryrun")} <= names
    assert "spatialsim_tpu_torch/tools/eval_digest.py" in names


_ROOT_BENCH = re.compile(r"^\s*(import\s+bench\b|from\s+bench(\s|\.))", re.M)


def test_scan_covers_the_bench_and_nothing_imports_root_bench():
    """The port's bench is among the scanned sources, and neither the port
    nor the smoke run imports the root ``bench.py`` (only tests do)."""
    names = {str(f.relative_to(ROOT))
             for f in (ROOT / "spatialsim_tpu_torch").rglob("*.py")}
    assert "spatialsim_tpu_torch/tools/bench.py" in names
    files = sorted((ROOT / "spatialsim_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = [str(f.relative_to(ROOT)) for f in files
           if _ROOT_BENCH.search(f.read_text())]
    assert not bad, bad
    assert _ROOT_BENCH.search("import bench")
    assert _ROOT_BENCH.search("    from bench import main")
    assert not _ROOT_BENCH.search("from spatialsim_tpu_torch.tools import "
                                  "bench")


_JAX_OR_SCRIPTS = re.compile(
    r"^\s*(import\s+(jax|scripts)\b|from\s+(jax|scripts)(\s|\.))", re.M)


def test_port_sources_import_neither_jax_nor_scripts():
    """The traversal-probe modules port ``scripts/decide15.py`` and
    ``decide18.py`` without importing them; no port module imports jax."""
    files = sorted((ROOT / "spatialsim_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"spatialsim_tpu_torch/ops/traversal_probes.py",
            "spatialsim_tpu_torch/tools/decide15.py",
            "spatialsim_tpu_torch/tools/decide18.py"} <= names
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _JAX_OR_SCRIPTS.finditer(f.read_text())]
    assert not bad, bad


# Copies verbatim apart from the package's name (in imports and in the
# module paths their text names).
VERBATIM = [
    "render/__init__.py", "render/camera.py", "render/points.py",
    "render/boid_geometry.py", "apps/__init__.py", "apps/world.py",
    "apps/input_handler.py", "tools/playback.py", "tools/export.py",
    "utils/__init__.py", "utils/logging.py", "io/__init__.py",
    "io/codec.py", "io/session.py", "io/compressor.py", "distributions.py",
    "_distributions_extra.py", "presets.py", "config/__init__.py",
    "config/boids.py", "config/nbody.py"]


@pytest.mark.parametrize("rel", VERBATIM)
def test_copies_equal_the_originals(rel):
    port = (ROOT / "spatialsim_tpu_torch" / rel).read_text()
    orig = (ROOT / "spatialsim_tpu" / rel).read_text()
    assert port.replace("spatialsim_tpu_torch", "spatialsim_tpu") == orig


def test_scan_covers_the_viewers_and_utils():
    """The modules ported in place of a copy (the viewers, profiling) are
    among the scanned sources, and the copied modules import."""
    import importlib
    names = {str(f.relative_to(ROOT))
             for f in (ROOT / "spatialsim_tpu_torch").rglob("*.py")}
    assert {"spatialsim_tpu_torch/apps/viewer.py",
            "spatialsim_tpu_torch/utils/profiling.py"} <= names
    for rel in VERBATIM + ["apps/viewer.py", "utils/profiling.py"]:
        importlib.import_module("spatialsim_tpu_torch." + rel[:-3].replace(
            "/__init__", "").replace("/", "."))


@pytest.mark.parametrize("name", jax_distributions.DISTRIBUTIONS)
def test_distribution_bit_identical(name):
    assert distributions.DISTRIBUTIONS == jax_distributions.DISTRIBUTIONS
    got = distributions.generate_distribution(name, 2000, 100.0, 0.1, seed=0)
    want = jax_distributions.generate_distribution(name, 2000, 100.0, 0.1,
                                                   seed=0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_presets_equal():
    assert presets.PRESETS == jax_presets.PRESETS
    assert presets.get_preset_list() == jax_presets.get_preset_list()
    assert presets.parse_number("2.5m") == jax_presets.parse_number("2.5m")


def test_config_defaults_equal():
    for port, ref in ((nbody_cfg.NBodyConfig(), jax_nbody_cfg.NBodyConfig()),
                      (boids_cfg.BoidsConfig(), jax_boids_cfg.BoidsConfig())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    b, jb = boids_cfg.BOIDS, jax_boids_cfg.BOIDS
    assert (b.cell_size, b.grid_dim) == (jb.cell_size, jb.grid_dim)


@pytest.mark.parametrize("n", [8_000, 40_000, 1_000_000, 25_000_000,
                               50_000_000])
def test_resolve_config_equal(n):
    got = nbody_cfg.resolve_config(nbody_cfg.NBodyConfig(num_bodies=n), n)
    want = jax_nbody_cfg.resolve_config(
        jax_nbody_cfg.NBodyConfig(num_bodies=n), n)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_codec_bytes_identical():
    rng = np.random.default_rng(0)
    p0 = (rng.standard_normal((500, 3)) * 100).astype(np.float32)
    c0 = rng.random((500, 3)).astype(np.float32)
    p1 = p0 + (rng.standard_normal((500, 3)) * 0.5).astype(np.float32)
    c1 = np.clip(c0 + 0.01, 0, 1).astype(np.float32)
    absolute = codec.compress_frame(p0, c0)
    delta = codec.compress_frame(p1, c1, p0, c0)
    assert codec.peek_format(absolute) == codec.FORMAT_ABSOLUTE
    assert codec.peek_format(delta) == codec.FORMAT_DELTA
    assert absolute == jax_codec.compress_frame(p0, c0)
    assert delta == jax_codec.compress_frame(p1, c1, p0, c0)
    # Each package decodes the other's frames.
    p, c = jax_codec.decompress_frame(delta, p0, c0)
    np.testing.assert_allclose(p, p1, atol=1e-3)
    np.testing.assert_array_equal(codec.decompress_frame(delta, p0, c0)[0],
                                  p)


def test_recorder_helpers_match_jax(capsys):
    from spatialsim_tpu.tools import record as jax_record
    from spatialsim_tpu_torch.tools import record
    preset = presets.get_preset_config("tiny_galaxy")
    assert (dataclasses.asdict(record.config_from_preset(preset))
            == dataclasses.asdict(jax_record.config_from_preset(preset)))
    assert record.RECORD_MAX_SPEED_COLOR == jax_record.RECORD_MAX_SPEED_COLOR
    for secs in (5, 125, 7384):
        assert record.format_time(secs) == jax_record.format_time(secs)
    # Menu: pick entry 1, override the body count, keep the rest, confirm.
    def answers(*lines):
        it = iter(lines)
        return lambda prompt: next(it)
    menu = ("1", "3k", "", "", "y")
    got = record.select_preset_interactive(answers(*menu))
    want = jax_record.select_preset_interactive(answers(*menu))
    assert got == want and got["num_bodies"] == 3000
    assert record.select_preset_interactive(answers("q")) is None
    capsys.readouterr()


def test_scan_covers_the_measurement_tools():
    """The ports of the ``scripts/`` measurement tools are among the
    scanned sources (the scans above walk the whole package), so none
    imports jax, ``scripts`` or the JAX package."""
    names = {str(f.relative_to(ROOT))
             for f in (ROOT / "spatialsim_tpu_torch").rglob("*.py")}
    assert {f"spatialsim_tpu_torch/tools/{m}.py"
            for m in ("oracle", "nbody_error", "nbody_error_scan",
                      "staleness_scan", "quad_scan", "extreme_run",
                      "prof_parts", "verify_drive")} <= names
