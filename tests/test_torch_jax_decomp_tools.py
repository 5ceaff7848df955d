"""The port's rebuild and boids decomposition tools against the JAX
scripts they port, on the CPU, field by field, times not compared:
``tools/decide21``, ``decide23``, ``decide25``, ``decide26``, ``decide27``
and ``decide13`` against the ``main`` of ``scripts/`` of the same names at
2,048 bodies; ``decide24``, ``decide22`` and ``gather_bench`` (sizes fixed
in the script) with the script's module constants set small where it
has them and the port's size flags set alike; ``decide16`` and
``decide12`` through the scripts' per-size ``run(n)`` and
``boids_part(n)``; ``boids_capture`` through its ``capture``.

The scripts' chains (``marginal``, ``timeit``) get a stand-in that runs
none, so the JAX side compiles only what its printed values need: a
traversal whose outputs only the chains read is stood in for
(``decide21``, ``decide26``); a build the script requires equal to
another is that other build (``_builds_as``: decide23's compact and
compact-mm pools are its ranges pool, decide25's tight tree its full
one, decide27's cell-id build its ranges build), so the port's rows
meet the scripts' own equalities against JAX's numbers;
``decide13``'s ``timeit`` runs its build once and only its first
variant builds (a raising build stands in for the others, which the
script reports as FAILED); ``decide16``'s step chains get a stand-in
step.  ``jax.clear_caches`` is a no-op while a script runs.  The port
tools run each timed call once (``decide16`` its chains at K = 1, 2).

Compared: every indented line's label (numbers in labels masked: the
scripts hard-code some sizes in them), the header lines' fields apart
from the platform, the caps, demands and checksums (counts exact; the
range rows' sum modulo 2**32, as the script's int32 sum wraps; float
sums within 1e-4 of their value), decide13's errors within 1e-4 and
its far_n statistics exact, the capture shares within 1e-4 and the
exact pair counts equal.  Each port tool also needs a card unless
``--device cpu`` is given.
"""

import re

import jax
import numpy as np
import pytest
import torch

from scripts import boids_capture as jax_capture
from scripts import decide12 as jax_decide12
from scripts import decide13 as jax_decide13
from scripts import decide16 as jax_decide16
from scripts import decide21 as jax_decide21
from scripts import decide22 as jax_decide22
from scripts import decide23 as jax_decide23
from scripts import decide24 as jax_decide24
from scripts import decide25 as jax_decide25
from scripts import decide26 as jax_decide26
from scripts import decide27 as jax_decide27
from scripts import gather_bench as jax_gather_bench
from spatialsim_tpu.config.boids import BoidsConfig as JaxBoidsConfig
from spatialsim_tpu.ops import bh_window as jbw
from spatialsim_tpu_torch.config.boids import BoidsConfig
from spatialsim_tpu_torch.tools.chain import Marginal
from spatialsim_tpu_torch.tools import (
    boids_capture, decide12, decide13, decide16, decide21, decide22,
    decide23, decide24, decide25, decide26, decide27, gather_bench)
from _jax_tools import _port, _quiet_cpu, _script

N = 2048
N_BOIDS = 1024
TOL = 1e-4
TOOLS = (decide21, decide27, decide25, decide26, decide23, decide24,
         decide13, decide22, gather_bench, decide16, decide12, boids_capture)
# decide24 and decide22 at a small shape: the scripts' module constants
# and the ports' flags.
D24 = dict(W=65_536, NG=64, L=512)
D22 = dict(C=4096, CP=1024, G=64, L=128, EMIT=20_000)
D22_FLAGS = ["--C", "4096", "--CP", "1024", "--G", "64", "--L", "128",
             "--emit", "20000", "--pool-idx", "30000", "--widths", "8192",
             "16384", "--seg-width", "16384", "--slices", "512"]
GATHER_FLAGS = ["--W", "50000", "--C", "20000"]


def _no_chain(*args, **kwargs):
    return (0.0, 0.0)


def _run(module, argv, patches=()):
    """The script's ``main`` with its chains stood in for; stdout.  Its
    ``jax.clear_caches`` is a no-op, so that a configuration it builds
    twice compiles once."""
    stub = [(jax, "clear_caches", lambda: None)]
    if hasattr(module, "marginal"):
        stub.append((module, "marginal", _no_chain))
    return _script(module, argv, stub + list(patches))


def _builds_as(canon):
    """``jbw.build_lists`` that builds each configuration once after
    ``canon`` maps its keywords: the stand-in for the builds a script
    requires equal to another (a compact pool equals the ranges pool, a
    tight tree equals the full one while its cells fit, a cell-id build
    equals the ranges build's far_n, mass and ranges)."""
    build, done = jbw.build_lists, {}

    def one(*args, **kw):
        kw = canon(dict(kw))
        key = repr(sorted(kw.items()))
        if key not in done:
            done[key] = build(*args, **kw)
        return done[key]
    return (jbw, "build_lists", one)


def _unread_traversal(*args, **kwargs):
    """The stand-in for a JAX traversal whose outputs only the (stood-in)
    chains read."""
    return (None,) * 8


def _once(fn, *args, **kwargs):
    fn()
    return Marginal(0.0, 0.0, None, None)


def _once_ms(fn, k, device, reps=3):
    fn()
    return 0.0, None


def _tool(module, argv):
    """The port tool's ``main`` on the CPU with each timed call run once
    (its chains are the scripts' timing; here only the outputs count)."""
    with pytest.MonkeyPatch.context() as mp:
        for name, stub in (("marginal", _once), ("chain_ms", _once_ms)):
            if hasattr(module, name):
                mp.setattr(module, name, stub)
        return _port(module.main, argv)


def _mask(label):
    return re.sub(r"\d+(\.\d+)?", "#", label)


def _labels(text):
    """Each indented line's label (before its first colon)."""
    return [_mask(x.strip().split(":")[0]) for x in text.splitlines()
            if x.startswith("  ")]


def _line(text, start):
    (x,) = [x for x in text.splitlines() if x.strip().startswith(start)]
    return x.strip()


def _fields(line):
    return {k: float(v) for k, v in
            re.findall(r"(\w+)=(-?[\d.]+(?:e[-+]?\d+)?)", line)}


def _after_platform(text):
    return _line(text, "platform=").split(" ", 1)[1]


def _assert_labels(want, got):
    assert _labels(got) == _labels(want)


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.split(".")[-1])
def test_tool_needs_a_card_unless_cpu_is_asked(tool, monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    try:
        rc = tool.main([])
    except SystemExit as exc:
        rc = exc.code
    assert rc == 1
    assert "--device cpu" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The rebuild by phase, stage and cap (N-body)
# ---------------------------------------------------------------------------

def test_decide21_matches_the_script():
    want = _run(jax_decide21, [str(N)],
                [(jbw, "_traverse_global", _unread_traversal)])
    got = _tool(decide21, [str(N)])
    assert _after_platform(got) == _after_platform(want)
    assert _line(got, "budget=") == _line(want, "budget=")
    _assert_labels(want, got)
    assert [x.split(" marginal")[0] for x in _labels(got)
            if "traverse[" in x] == [f"traverse[{_mask(t)}]" for t, _ in
                                    decide21.VARIANTS]


def _sums(text, mode):
    return _fields(_line(text, f"[{mode}]"))


def _assert_sums(want, got, modes):
    for mode in modes:
        w, g = _sums(want, mode), _sums(got, mode)
        assert set(w) == set(g), mode
        for k, x in w.items():
            if k == "rng_sum":
                assert (int(g[k]) + 2 ** 31) % 2 ** 32 - 2 ** 31 == int(x)
            elif k == "far_n_sum":
                assert g[k] == x, (mode, k)
            else:
                assert abs(g[k] - x) <= TOL * max(abs(x), 1.0), (mode, k)


def test_decide27_matches_the_script():
    """The script's cell-id build is its ranges build (the script requires
    their far_n, mass and ranges equal)."""
    want = _run(jax_decide27, [str(N)], [_builds_as(
        lambda kw: dict(kw, emit_mode="ranges"))])
    got = _tool(decide27, [str(N)])
    assert _after_platform(got) == _after_platform(want)
    for start in ("demand=", "defaults=", "fit caps="):
        assert _line(got, start) == _line(want, start)
    _assert_sums(want, got, ("ranges", "cellid"))
    _assert_labels(want, got)


def test_decide25_matches_the_script():
    """The script's tight-cap build is its full one (equal while the cells
    fit, which the script checks) and that build is ``decide23``'s ranges
    build, one compile for both tests."""
    want = _run(jax_decide25, [str(N)], [_builds_as(
        lambda kw: {k: v for k, v in kw.items() if k != "tree_caps"})])
    got = _tool(decide25, [str(N)])
    assert (_after_platform(got).split(" measured")[0]
            == _after_platform(want).split(" measured")[0])
    _assert_sums(want, got, ("full", "tight"))
    _assert_labels(want, got)


def test_decide26_matches_the_script():
    want = _run(jax_decide26, [str(N)],
                [(jbw, "_traverse_global", _unread_traversal)])
    got = _tool(decide26, [str(N)])
    assert _after_platform(got) == _after_platform(want)
    _assert_labels(want, got)


def test_decide23_matches_the_script():
    """The script's compact and compact-mm builds are its ranges build:
    the three pools are equal bit for bit (the JAX suite's
    ``test_compact_emission_pool_bitexact``; the script checks it)."""
    want = _run(jax_decide23, [str(N)], [_builds_as(
        lambda kw: dict(kw, emit_mode="ranges"))])
    got = _tool(decide23, [str(N)])
    assert _after_platform(got) == _after_platform(want)
    _assert_sums(want, got, decide23.MODES)
    _assert_labels(want, got)


class _Skipped(Exception):
    """The script reports it as the variant's FAILED line."""


def test_decide13_matches_the_script():
    """The script computes its first variant (group 256, window 1, the
    auto budget); the others get a build that raises, which the script
    reports as FAILED.  At 2,048 bodies no budget binds, so the port's
    rows at group 256 and window 1 must equal its auto row; no pool folds
    a group, and the port's dense line reads the auto row's far_n."""
    build = jax_decide13.build_lists

    def first_only(*args, worklist_budget=0, **kw):
        if worklist_budget or kw["group_size"] != 256:
            raise _Skipped("stood in for")
        return build(*args, worklist_budget=worklist_budget, **kw)
    want = _run(jax_decide13, [str(N)], [
        (jax_decide13, "timeit", lambda fn, reps=3: (0.0, fn())),
        (jax_decide13, "build_lists", first_only)])
    got = _tool(decide13, [str(N)])

    def rows(text):
        return {x.split(":")[0].strip(): _fields(x.split("|", 1)[1])
                for x in text.splitlines()
                if x.startswith("  gsz=") and "|" in x}
    fw, fg = rows(want), rows(got)
    assert len(fg) == len(decide13.VARIANTS)
    assert set(fw) == {"gsz=256 W1 B=auto"}
    for g in fg.values():
        assert set(g) == {"med", "p99", "rms", "mean", "max", "folded"}
        assert g["folded"] == 0
    for label, w in fw.items():
        g = fg[label]
        for k in ("med", "p99", "rms"):
            assert abs(g[k] - w[k]) <= TOL, (label, g, w)
        assert (g["mean"], g["max"]) == (w["mean"], w["max"]), label
    auto = fg["gsz=256 W1 B=auto"]
    for b in ("3000000", "2000000", "1500000"):
        assert fg[f"gsz=256 W1 B={b}"] == auto
    # The dense line (the port's own; no pool folds at this size either).
    dense = fg["gsz=256 W1 B=auto dense"]
    assert (dense["mean"], dense["max"]) == (auto["mean"], auto["max"])


# ---------------------------------------------------------------------------
# The primitives at fixed shapes
# ---------------------------------------------------------------------------

def test_decide24_matches_the_script():
    want = _run(jax_decide24, [], [(jax_decide24, k, v)
                                   for k, v in D24.items()])
    got = _tool(decide24, ["--W", str(D24["W"]), "--ng",
                                str(D24["NG"]), "--L", str(D24["L"])])
    assert _after_platform(got) == _after_platform(want)
    _assert_labels(want, got)


def test_decide22_matches_the_script():
    patches = [(jax_decide22, k, v) for k, v in D22.items()]
    patches.append((jax_decide22, "NG_L", D22["G"] * D22["L"]))
    want = _run(jax_decide22, [], patches)
    got = _tool(decide22, D22_FLAGS)
    assert _after_platform(got) == _after_platform(want)
    _assert_labels(want, got)


def test_gather_bench_matches_the_script():
    want = _run(jax_gather_bench, [], [
        (jax_gather_bench, "timeit", lambda fn, *a, reps=5: 0.0)])
    got = _tool(gather_bench, GATHER_FLAGS)

    def names(text):
        return [x[:38].strip() for x in text.splitlines()
                if " ms " in x and "ns/slot" in x]
    assert names(got) == names(want) and len(names(got)) == 8


# ---------------------------------------------------------------------------
# The boids step
# ---------------------------------------------------------------------------

def _boids_text(fn, *args):
    with _quiet_cpu() as out:
        fn(*args)
    return out.getvalue()


def test_decide16_matches_the_script(monkeypatch):
    monkeypatch.setattr(jax_decide16, "timeit", lambda fn, reps=3: 0.0)
    monkeypatch.setattr(jax_decide16, "make_step_fn",
                        lambda cfg, substeps=1: (lambda st, dt: st))
    want = _boids_text(jax_decide16.run, N_BOIDS)
    monkeypatch.setattr(decide16, "marginal", _once)
    monkeypatch.setattr(decide16, "CHAINS", (1, 2))
    got = _boids_text(decide16.run, N_BOIDS, torch.device("cpu"))
    assert _line(got, "boids n=") == _line(want, "boids n=")
    _assert_labels(want, got)


def test_decide12_matches_the_script(monkeypatch):
    monkeypatch.setattr(jax_decide12, "timeit", lambda fn, reps=3: 0.0)
    want = _boids_text(jax_decide12.boids_part, N_BOIDS)
    monkeypatch.setattr(decide12, "marginal", _once)
    got = _boids_text(decide12.boids_part, N_BOIDS, torch.device("cpu"))
    assert _line(got, "boids n=") == _line(want, "boids n=")
    _assert_labels(want, got)
    assert [r[0] for r in decide12.ROWS] == ["xla", "pallas"]


def test_boids_capture_matches_the_script():
    n = 4000
    cfg, jcfg = BoidsConfig(num_boids=n), JaxBoidsConfig(num_boids=n)
    with _quiet_cpu() as out:
        got = boids_capture.run(n, n, torch.device("cpu"))
    # The script's main draws at 100K; these are its draws at n.
    rng = np.random.default_rng(7)
    uni = (rng.random((3, n)) - 0.5) * 2 * cfg.bounds
    centers = (rng.random((3, 200)) - 0.5) * 2 * (cfg.bounds - 20)
    clu = (np.repeat(centers, n // 200, axis=1)
           + rng.normal(size=(3, n)) * 4.0).clip(-cfg.bounds, cfg.bounds)
    sh = max(1, (cfg.grid_dim * 3) // 7)
    gsz, wg = jcfg.group_size, jcfg.window_groups
    for tag, pos in (("uniform", uni), ("clustered", clu)):
        with _quiet_cpu():
            w1, w2, wtot = jax_capture.capture(pos, jcfg, gsz, wg, sh, wg,
                                               sample=n)
        g1, g2, gtot = got[tag]
        assert gtot == wtot, tag
        assert abs(g1 - w1) <= TOL and abs(g2 - w2) <= TOL, (tag, got[tag])
        assert f"{tag}4k" in out.getvalue()
    assert got["clustered"][2] > 1000
