"""The port's sweep tools against the JAX scripts they port, on the CPU,
field by field, times not compared: ``tools/decide20``, ``decide14``,
``distsort_bench``, ``seam_analysis`` and ``nbody_scan2`` against the
``main`` of ``scripts/`` of the same names, and ``tools/decide13``'s fold
count against the script's lists where the pool folds.

Sizes: 2,048 bodies (``seam_analysis`` and ``nbody_scan2`` 2,049, where
the group padding makes npad > n and the script's 2,048 samples fit;
``distsort_bench`` 4,096 on 8 gloo ranks, the smallest count at which
every rank holds the two groups its window needs).  ``seam_analysis``'s
script reads the port's dense lists of its bodies, ``nbody_scan2``'s
the port's pooled lists built with the script's own build arguments
(each handed over as JAX ``BHLists``): their tests hold the analysis,
the pad slots' gather, the eval and the build arguments, not the build,
which ``tests/test_torch_jax_tools.py`` and ``test_torch_bh_window.py``
hold.  decide20's cluster gets a list cap of 256 on both sides, so that
groups sit at the cap and carry residual mass (at the script's caps
nothing saturates at this size); its uncalibrated and calibrated
variants (one configuration at this size: the calibration keeps the
default worklist caps) read the port's lists, and ``cal_L16k`` JAX's own
build at list cap 16,384, so its test holds that build, the residual
sums, the splits and the eval; its calibration is the port's, handed to
the script after checking that the script's input configuration equals
the port's.  decide13 gets a pool cap of 16 tiles on both sides, at
which 4 of the 8 groups fold whole.

The scripts' timing chains and sustained steps get stand-ins that run
nothing, so the JAX side compiles only what its printed values need;
``nbody_scan2`` evaluates its first variant on both sides (the script's
other two reuse it: their lines are compared by name); its
``build_diagnostics`` line is compared by its keys
(``tests/test_torch_pooled_finishes.py`` holds the function's values to
JAX's).  The scripts' own direct sums are the port's oracle (one oracle
for both sides' errors).  The ports run every timed call once.

Compared: each line's label (numbers masked), counts and far_n statistics
exactly, errors, residual-mass fractions and seam shares within 1e-4 (the
fractions unrounded: the script's residual sums captured at
``jax.ops.segment_sum``, its seam shares from its own arrays as its
``main`` returns).
"""

import contextlib
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts import decide13 as jax_decide13
from scripts import decide14 as jax_decide14
from scripts import decide20 as jax_decide20
from scripts import distsort_bench as jax_distsort
from scripts import nbody_scan2 as jax_scan2
from scripts import seam_analysis as jax_seam
from spatialsim_tpu.config import nbody as jax_nbody
from spatialsim_tpu.ops import bh_window as jbw
from spatialsim_tpu.parallel import sharded as jax_sharded
from spatialsim_tpu_torch.config import nbody as nbody_cfg
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools import (
    decide13, decide14, decide20, distsort_bench, nbody_scan2, seam_analysis)
from spatialsim_tpu_torch.tools.chain import Marginal
from spatialsim_tpu_torch.tools.oracle import (
    exact_accel_at, initial_conditions, sample_ids)
from _jax_tools import _port, _quiet_cpu, _script, _to_jax

N = 2048
TOL = 1e-4
TOOLS = (decide20, decide14, distsort_bench, seam_analysis, nbody_scan2)
CAP_20 = 256            # decide20's list cap on both sides
POOL_CAP_13 = 16        # decide13's pool tiles on both sides
N_SEAM = 2049          # seam_analysis and nbody_scan2: npad 2,304 > n
N_SORT = 4096


def _once(fn, *args, **kwargs):
    fn()
    return Marginal(0.0, 0.0, None, None)


def _once_ms(fn, k, device, reps=3):
    fn()
    return 0.0, None


def _tool(module, argv, patches=()):
    """The port tool's ``main`` on the CPU with each timed call run once."""
    with pytest.MonkeyPatch.context() as mp:
        for name, stub in (("marginal", _once), ("chain_ms", _once_ms)):
            if hasattr(module, name):
                mp.setattr(module, name, stub)
        for obj, name, value in patches:
            mp.setattr(obj, name, value)
        return _port(module.main, argv)


def _port_exact(tgt, pos, mass, G, soft_sq):
    """The scripts' direct sum (``exact_at`` / ``exact_accel_at``) by the
    port's oracle on the CPU: both sides' errors are then against one
    oracle, and the JAX side compiles none."""
    def t(a):
        return torch.tensor(np.array(a))
    out = exact_accel_at(t(tgt), t(pos), t(mass), float(G),
                         float(soft_sq) ** 0.5)
    return jnp.asarray(out.numpy())


_PORT_BUILDS = {}


def _port_build(pos, vel, mass, acc=None, **kw):
    """The port's build of a script's bodies, handed to the script as the
    JAX package's ``BHLists`` (each body count and configuration once):
    the script's analysis and eval then read the port's lists.  Used where
    the build itself is held to JAX's elsewhere and the script only reads
    its lists (a JAX build traces for ~7 s on the CPU, which the test
    budget leaves no room for)."""
    assert acc is None
    key = repr((pos.shape, sorted(kw.items())))
    if key not in _PORT_BUILDS:
        def t(a):
            return torch.tensor(np.array(a))

        def j(x):
            return None if x is None else jnp.asarray(x.numpy())
        lists = bw.build_lists(t(pos), t(vel), t(mass), **kw)
        _PORT_BUILDS[key] = jbw.BHLists(
            order=j(lists.order), inv_order=j(lists.inv_order),
            far=j(lists.far), far_n=j(lists.far_n),
            ref_pos=j(lists.ref_pos), steps_since=jnp.int32(0),
            far_range=j(lists.far_range), steps_build=jnp.int32(0),
            pool=j(lists.pool), pstart=j(lists.pstart))
    return _PORT_BUILDS[key]


def _mask(label):
    return re.sub(r"\d+(\.\d+)?", "#", label)


def _numbers(text):
    return {k: float(v) for k, v in
            re.findall(r"([\w-]+)=(-?[\d.]+(?:e[-+]?\d+)?)", text)}


def _lines(text, start):
    return [x for x in text.splitlines() if x.strip().startswith(start)]


def _assert_close(got, want, exact=(), label=""):
    assert set(want) <= set(got), (label, got, want)
    for k, w in want.items():
        if k in exact:
            assert got[k] == w, (label, k, got[k], w)
        else:
            assert abs(got[k] - w) <= TOL + 1e-9, (label, k, got[k], w)


@pytest.mark.parametrize("tool", TOOLS,
                         ids=lambda m: m.__name__.split(".")[-1])
def test_tool_needs_a_card_unless_cpu_is_asked(tool, monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    try:
        rc = tool.main([])
    except SystemExit as exc:
        rc = exc.code
    assert rc == 1
    assert "--device cpu" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# decide20: the 10M tail's split
# ---------------------------------------------------------------------------

def _capped(cls):
    return lambda **kw: cls(**dict(kw, list_capacity=CAP_20))


class _Skipped(Exception):
    """The script reports it as the variant's FAILED line."""


@pytest.fixture(scope="module")
def decide20_runs():
    """The port's run (its text and records) and the script's (its text
    and its per-group residual sums), both at list cap 256 (``cal_L16k``
    replaces it by 16,384)."""
    cals, seg = [], []
    calibrate = bw.calibrate_config

    def port_calibrate(cfg, *args, **kwargs):
        cals.append((cfg, calibrate(cfg, *args, **kwargs)))
        return cals[-1][1]
    with pytest.MonkeyPatch.context() as mp, _quiet_cpu() as out:
        mp.setattr(decide20, "NBodyConfig", _capped(nbody_cfg.NBodyConfig))
        mp.setattr(bw, "calibrate_config", port_calibrate)
        recs = decide20.run(N, torch.device("cpu"))
    got = out.getvalue()
    (base, cal), = cals

    def jax_calibrate(cfg, pos, vel, mass, **kwargs):
        assert _to_jax(base) == cfg
        return _to_jax(cal)
    segment_sum = jax.ops.segment_sum

    built = []

    def variant_builds(*args, **kw):
        # prod_uncal and calibrated: the port's lists at the cap of 256;
        # cal_L16k: JAX's own build.
        built.append(kw["list_cap"])
        if len(built) < 3:
            assert kw["list_cap"] == CAP_20
            return _port_build(*args, **kw)
        assert kw["list_cap"] == 16384
        return jbw.build_lists(*args, **kw)

    def keep_sums(*args, **kwargs):
        out = segment_sum(*args, **kwargs)
        # The script's own call only (the JAX package calls it too).
        if sys._getframe(1).f_globals["__name__"] == jax_decide20.__name__:
            seg.append(np.asarray(out, np.float64))
        return out
    cfg = decide20.cluster_config(N)
    pos, _, mass = initial_conditions("cluster", N, cfg.spawn_radius,
                                      cfg.G, torch.device("cpu"))
    idx = torch.as_tensor(sample_ids(N, decide20.SAMPLE))
    exact = exact_accel_at(pos[:, idx], pos, mass, cfg.G, cfg.softening)
    real_map = jax.lax.map

    def lax_map(f, xs, *args, **kwargs):
        # The script's own direct sum only: the port's oracle (above).
        if sys._getframe(1).f_globals["__name__"] == jax_decide20.__name__:
            return jnp.asarray(exact.numpy().T)
        return real_map(f, xs, *args, **kwargs)
    want = _script(jax_decide20, [str(N)], [
        (jax.lax, "map", lax_map),
        (jax_decide20, "NBodyConfig", _capped(jax_nbody.NBodyConfig)),
        (jbw, "calibrate_config", jax_calibrate),
        (jax_decide20, "build_lists", variant_builds),
        (jax.ops, "segment_sum", keep_sums),
        (jax, "clear_caches", lambda: None)])
    return got, recs, want, seg


def _variant_block(text, tag):
    lines = text.splitlines()
    i = next(k for k, x in enumerate(lines) if x.startswith(f"[{tag}]"))
    block = [lines[i]]
    for x in lines[i + 1:]:
        if not x.startswith("  "):
            break
        block.append(x)
    return block


def test_decide20_matches_the_script(decide20_runs):
    """Every variant line by line: the two at the cap of 256 with the
    script reading the port's lists, ``cal_L16k`` with JAX's own build.
    At the cap of 256 the lists saturate; at 16,384 no group is at the
    cap."""
    got, _, want, _ = decide20_runs
    assert "FAILED" not in got and "FAILED" not in want
    assert (_lines(got, "calibrate:")[0].split(" s ")[1]
            == _lines(want, "calibrate:")[0].split(" s ")[1])
    for tag, _ in decide20.VARIANTS:
        w, g = _variant_block(want, tag), _variant_block(got, tag)
        assert len(g) == len(w) == 7, tag
        assert [_mask(x.split("rel")[0]) for x in g[1:]] == [
            _mask(x.split("rel")[0]) for x in w[1:]]
        hw, hg = _numbers(w[0]), _numbers(g[0])
        _assert_close(hg, {k: hw[k] for k in ("mean", "p99", "at_cap",
                                              "res_mass_frac")},
                      exact=("mean", "p99", "at_cap"), label=tag)
        for xw, xg in zip(w[1:], g[1:]):
            for pw, pg in zip(xw.split("|"), xg.split("|")):
                _assert_close(_numbers(pg), _numbers(pw), exact=("n",),
                              label=(tag, pw))
    assert _numbers(_variant_block(want, "prod_uncal")[0])["at_cap"] > 0
    assert _numbers(_variant_block(want, "cal_L16k")[0])["at_cap"] == 0


def test_decide20_residual_fraction_matches_unrounded(decide20_runs):
    """Each variant's residual-mass fraction against the script's own
    segment sums over the same masses, unrounded."""
    _, recs, _, seg = decide20_runs
    from spatialsim_tpu import distributions
    cfg = decide20.cluster_config(N)
    _, _, m = distributions.generate_distribution(
        "cluster", N, cfg.spawn_radius, cfg.G, seed=0)
    mtot = float(np.asarray(m, np.float32).astype(np.float64).sum())
    assert len(seg) == len(recs) == 3
    for rec, res_g in zip(recs, seg):
        frac = float(res_g.sum()) / mtot
        assert abs(rec["res_mass_frac"] - frac) <= TOL, (rec["tag"], frac)
    assert recs[0]["res_mass_frac"] > 0


# ---------------------------------------------------------------------------
# decide14: the pooled engine's rates
# ---------------------------------------------------------------------------

def _no_timeit(fn, reps=3):
    return 1.0


_GALAXY_BUILDS = {}
_BUILD = jbw.build_lists


def _galaxy_build(*args, **kw):
    """JAX's ``build_lists`` of the galaxy, each body count and
    configuration once in this module (decide13's and decide14's scripts
    build the same one under the pool cap)."""
    key = repr((args[0].shape, sorted(kw.items())))
    if key not in _GALAXY_BUILDS:
        _GALAXY_BUILDS[key] = _BUILD(*args, **kw)
    return _GALAXY_BUILDS[key]


def _pool_capped(cfg):
    return dict(jbw._build_kw(cfg), pool_cap=POOL_CAP_13)


def test_decide14_matches_the_script():
    """Under decide13's pool cap of 16 tiles on both sides (the script's
    build is then decide13's: one JAX build for both tests), the pool's
    tiles and those in use agree."""
    stand_in = types.SimpleNamespace(pos=np.zeros((1, 1)))
    want = _script(jax_decide14, [str(N)], [
        (jax_decide14, "timeit", _no_timeit),
        (jax_decide14, "_build_kw", _pool_capped),
        (jax_decide14, "build_lists", _galaxy_build),
        (jax_decide14, "init_window_state", lambda *a: None),
        (jax_decide14, "make_window_step",
         lambda cfg, n, substeps: (lambda st, dt: stand_in))])
    build_kw = bw._build_kw

    class _Step:
        rebuilds = refreshes = 0

        def __call__(self, st, dt):
            return st
    got = _tool(decide14, [str(N)], [
        (bw, "_build_kw", lambda cfg: dict(build_kw(cfg),
                                           pool_cap=POOL_CAP_13)),
        (bw, "init_window_state", lambda *a: None),
        (bw, "make_window_step", lambda cfg, n, substeps: _Step())])
    assert _lines(got, "platform=")[0].split(" ", 1)[1] == \
        _lines(want, "platform=")[0].split(" ", 1)[1]

    def labels(text):
        return [_mask(x.split(":")[0]) for x in text.splitlines()
                if x.startswith("  ")]
    assert labels(got) == labels(want)
    tiles = re.compile(r"pool tiles (\d+) used (\d+)")
    (w,), (g,) = (tiles.findall(t) for t in (want, got))
    assert g == w and int(w[0]) == POOL_CAP_13 and int(w[1]) > 0


# ---------------------------------------------------------------------------
# distsort_bench: the sample sort against the replicated fallback
# ---------------------------------------------------------------------------

def test_distsort_bench_matches_the_script_and_counts_its_fallbacks(tmp_path):
    """The script's lines with its sharded step stood in for; the port's
    8 gloo ranks, whose two variants both fall back on every rebuild: at
    8 ranks a rank's bin to itself (its whole, already sorted shard)
    outgrows the capacity 2 nl / D, the JAX package's as the port's
    (``tests/test_torch_sharded.py`` holds the two sample sorts to each
    other)."""
    stand_in = types.SimpleNamespace(pos=np.zeros((1, 1)))
    want = _script(jax_distsort, [str(N_SORT)], [
        (jax_sharded, "make_sharded_window_step",
         lambda cfg, n, mesh, substeps: (lambda st, dt: stand_in,
                                         lambda *a: stand_in))])
    with _quiet_cpu() as out:
        res = distsort_bench.run(N_SORT, torch.device("cpu"))
    got = out.getvalue()

    def labels(text):
        return [x.split(":")[0] for x in text.splitlines()
                if x.startswith("  ")]
    assert labels(got) == labels(want)
    for tag, _ in distsort_bench.VARIANTS:
        r = res[tag]
        assert r["ranks"] == distsort_bench.RANKS == 8
        # 1 warm-up and 3 timed calls of 2 substeps, a rebuild every
        # substep after the first: 7 rebuilds, 6 of them timed.
        assert (r["rebuilds"], r["timed_rebuilds"]) == (7, 6), r
        assert (r["fallbacks"], r["timed_fallbacks"]) == (7, 6), r
        assert "fallbacks 7 of 7 rebuilds, timed 6 of 6" in got


# ---------------------------------------------------------------------------
# seam_analysis: the far entries' distances in group radii
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _locals_at_return(fn):
    """Keeps the local variables of ``fn``'s frame as it returns."""
    kept = {}

    def hook(frame, event, arg):
        if event == "return" and frame.f_code is fn.__code__:
            kept.update(frame.f_locals)
    before = sys.getprofile()
    sys.setprofile(hook)
    try:
        yield kept
    finally:
        sys.setprofile(before)


def test_seam_analysis_matches_the_script():
    """At 2,049 bodies (the group padding: npad > n), the script reading
    the port's dense lists: the shares against the script's own, its
    expressions evaluated on its own arrays (``ratio``, ``valid``,
    ``mass_e``, kept as its ``main`` returns), unrounded; the pad slots'
    gather and the printed lines agree."""
    kept = []

    def keep(*args, **kw):
        kept.append(_port_build(*args, **kw))
        return kept[-1]
    with _locals_at_return(jax_seam.main) as script:
        want = _script(jax_seam, [str(N_SEAM)], [
            (jax_seam, "build_lists", keep)])
    with _quiet_cpu() as out:
        rec = seam_analysis.run(N_SEAM, torch.device("cpu"))
    got = out.getvalue()
    (lists,) = kept
    order = np.asarray(lists.order)
    assert order.shape[0] > N_SEAM and order.max() < N_SEAM
    ratio, total, mass_e = (script[k] for k in ("ratio", "total", "mass_e"))
    assert (rec["total"], rec["ng"]) == (int(total), script["ng"])
    assert set(rec["within"]) == set(seam_analysis.RADII)
    for t, share in rec["within"].items():
        want_share = (ratio < t).sum() / total
        assert abs(share - want_share) <= TOL, ("within", t)
    for t, share in rec["mass_within"].items():
        want_share = mass_e[ratio < t].sum() / mass_e.sum()
        assert abs(share - want_share) <= TOL, ("mass_within", t)
    assert 0 < rec["within"][1.5] < 1

    def printed(text):
        return [(_mask(x.split(":")[0]), x.split(":")[1].split("%")[0])
                for x in text.splitlines() if x.startswith("  ")]
    assert printed(got) == printed(want)
    assert _lines(got, "n=")[0] == _lines(want, "n=")[0]


# ---------------------------------------------------------------------------
# nbody_scan2: depth-8 refinements
# ---------------------------------------------------------------------------

def test_nbody_scan2_matches_the_script(monkeypatch):
    """The unpatched script (its default pooled lists) at 2,049 bodies,
    where the default pool folds no group: the script's first variant
    builds with the port's build arguments (the same pooled layout) and
    reads the port's lists; its errors, the lines' keys and the fold
    count (0 of 9) agree."""
    first, script_kw, read = {}, [], []
    accel = jax_scan2.window_bh_accel

    def port_build(*args, **kw):
        script_kw.append(kw)
        read.append(_port_build(*args, **kw))
        return read[-1]
    monkeypatch.setattr(jbw, "build_lists", port_build)

    def first_variant(pos, vel, mass, cfg):
        if "acc" not in first:
            first["cfg"] = cfg
            first["acc"] = accel(pos, vel, mass, cfg)
        return first["acc"]
    stand_in = types.SimpleNamespace(pos=np.zeros((1, 1)))
    want = _script(jax_scan2, [str(N_SEAM)], [
        (jax_scan2, "window_bh_accel", first_variant),
        (jax_scan2, "exact_accel_at", _port_exact),
        (jax_scan2, "build_diagnostics", lambda *a: dict.fromkeys(
            nbody_scan2.DIAG_KEYS)),
        (jax_scan2, "init_window_state", lambda *a: None),
        (jax_scan2, "make_step_fn",
         lambda cfg, n, substeps: (lambda st, dt: stand_in))])
    assert first["cfg"].window_groups == 2
    port_kw, build = [], bw.build_lists

    def keep_kw(*args, **kw):
        port_kw.append(kw)
        return build(*args, **kw)
    got = _tool(nbody_scan2, [str(N_SEAM)], [
        (bw, "build_lists", keep_kw),
        (bw, "init_window_state", lambda *a: None),
        (nbody_scan2, "make_step_fn",
         lambda cfg, n, substeps: (lambda st, dt: st))])
    (kw,) = script_kw
    assert kw["pool_tile"] == 512 and port_kw[0] == kw

    def records(text):
        return [eval(x.replace("null", "None")) for x in text.splitlines()
                if x.startswith("{")]
    rw, rg = records(want), records(got)
    assert [r.get("cfg") for r in rg] == [r.get("cfg") for r in rw]
    assert [set(r) for r in rg[:3]] == [set(r) | {"folded", "groups"}
                                        for r in rw[:3]]
    assert [set(r) for r in rg[3:]] == [
        set(r) | ({"ms_per_step_unrounded"} if "sustained_interval" in r
                  else set()) for r in rw[3:]]
    for k in ("median", "p99", "rms"):
        assert abs(rg[0][k] - rw[0][k]) <= TOL, (k, rg[0], rw[0])
    jfar_n = np.asarray(read[0].far_n)
    assert rg[0]["folded"] == int((jfar_n <= 1).sum()) == 0
    assert rg[0]["groups"] == jfar_n.shape[0] == 9
    # build_diagnostics' values are held to JAX's by
    # test_torch_pooled_finishes.py; here its line's keys.
    assert set(rg[3]) == set(rw[3]) == set(nbody_scan2.DIAG_KEYS)
    assert rg[3]["wl_caps"] and rg[3]["far_n_max"] > 0


# ---------------------------------------------------------------------------
# decide13: the pool's folds
# ---------------------------------------------------------------------------

def test_decide13_folds_as_the_script_under_a_pool_cap():
    """Group 256, window 1, the auto budget, under a pool of 16 tiles: 4
    of the 8 groups fold whole on both sides (far_n <= 1), and the errors,
    far_n statistics and fold count agree; the dense line folds none (the
    port runs these two lines; ``test_torch_jax_decomp_tools.py`` runs all
    seven)."""
    kept = []
    build = _galaxy_build

    def first_only(*args, worklist_budget=0, **kw):
        if worklist_budget or kw["group_size"] != 256 or kw[
                "window_groups"] != 1:
            raise _Skipped("stood in for")
        assert kw["pool_cap"] == POOL_CAP_13 and kw["pool_tile"] == 512
        kept.append(build(*args, worklist_budget=worklist_budget, **kw))
        return kept[-1]
    want = _script(jax_decide13, [str(N)], [
        (jax_decide13, "timeit", lambda fn, reps=3: (0.0, fn())),
        (jax_decide13, "exact_at", _port_exact),
        (jax_decide13, "_build_kw",
         lambda cfg: dict(jbw._build_kw(cfg), pool_cap=POOL_CAP_13)),
        (jax_decide13, "build_lists", first_only)])
    build_kw = bw._build_kw
    with pytest.MonkeyPatch.context() as mp, _quiet_cpu() as out:
        mp.setattr(decide13, "chain_ms", _once_ms)
        mp.setattr(bw, "_build_kw", lambda cfg: dict(
            build_kw(cfg), pool_cap=POOL_CAP_13))
        decide13.run(N, torch.device("cpu"), variants=(
            decide13.VARIANTS[0], decide13.VARIANTS[-1]))
    got = out.getvalue()
    (lists,) = kept
    jfolded = int((np.asarray(lists.far_n) <= 1).sum())

    def row(text, label):
        (x,) = [x for x in text.splitlines()
                if x.startswith(f"  {label}:") and "|" in x]
        return _numbers(x.split("|", 1)[1])
    w, g = row(want, "gsz=256 W1 B=auto"), row(got, "gsz=256 W1 B=auto")
    _assert_close(g, w, exact=("mean", "max"))
    assert g["folded"] == jfolded > 0
    assert f"folded={jfolded}/8" in got
    dense = row(got, "gsz=256 W1 B=auto dense")
    assert dense["folded"] == 0 and dense["rms"] < g["rms"]
