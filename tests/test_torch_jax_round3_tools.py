"""The port's round-3 eval and rebuild sweeps against the JAX scripts they
port, on the CPU, times not compared: ``tools/decide2``-``decide6``,
``decide19`` and ``decide8``-``decide11`` against the ``main`` (or the
per-size parts) of ``scripts/`` of the same names, at 2,048 bodies
(boids 1,024; decide19's table at 20,000 columns and 40,000 slots).

The scripts' ``timeit`` gets a stand-in that runs nothing, so the JAX
side computes only what its printed values need, and ``build_lists`` one
that builds once (``_Builds``): the pooled lists at group 256, window 1
serve every script (the dense window-1 lists too: at this size no pool
folds a group, so their far_n is the same).  Lines whose builds the
scripts only time (decide9's other caps, decide11's other geometries,
the window-2 rows of decide4 and decide6) are compared by label.
decide2's group-128 window-2 line gets JAX's own build.  The other group
sizes 128 and 64 and decide3's window 2 get a build that raises, which
the scripts report as FAILED (labels; the port runs only the lines the
script computes -- decide2's group-128 window-2 and group-256 lines,
decide3's first two: its 12M and 16M budgets' pools cost the CPU
seconds and a GB -- and its variant lists are checked against the
script's lines).  The JAX side computes one eval a set of pooled lists
and state (``_shared_eval``), shared by the scripts whose calls differ
only in knobs its pooled kernel does not read (``use_cols``,
``far_tile``, ``iblk``, the groups a program), and decide2's and
decide3's own direct sums are stood in for: their errors are compared
through the scripts' captured accelerations.  The ports run each timed
call once.

Compared: each line's label (numbers masked), far_n statistics, pairs a
body and counts exactly, the errors of decide2 and decide3 unrounded
within 1e-4 (the script's own accelerations, captured, against the same
direct sum), the kernels' relative deviations within 1e-4.  The scripts'
"pallas" boids row is kernel 4's wrapper, their "xla" row the port's
plain version.
"""

import hashlib
import re

import numpy as np
import pytest
import torch

from scripts import decide2 as jax_decide2
from scripts import decide3 as jax_decide3
from scripts import decide4 as jax_decide4
from scripts import decide5 as jax_decide5
from scripts import decide6 as jax_decide6
from scripts import decide8 as jax_decide8
from scripts import decide9 as jax_decide9
from scripts import decide10 as jax_decide10
from scripts import decide11 as jax_decide11
from scripts import decide19 as jax_decide19
from spatialsim_tpu.ops import bh_window as jbw
from spatialsim_tpu_torch.tools import (
    decide2, decide3, decide4, decide5, decide6, decide8, decide9, decide10,
    decide11, decide19, round3)
from spatialsim_tpu_torch.tools.chain import Marginal
from _jax_tools import _port, _quiet_cpu, _script

N = 2048
N_BOIDS = 1024
D19 = dict(k=6, n=20_000, w=40_000)
TOL = 1e-4
TOOLS = (decide2, decide3, decide4, decide5, decide6, decide19, decide8,
         decide9, decide10, decide11)
SCRIPTS = {decide2: jax_decide2, decide3: jax_decide3, decide4: jax_decide4,
           decide5: jax_decide5, decide6: jax_decide6, decide8: jax_decide8,
           decide9: jax_decide9, decide10: jax_decide10,
           decide11: jax_decide11, decide19: jax_decide19}


class _Skipped(Exception):
    """The script reports it as the variant's FAILED line."""


class _Builds:
    """``build_lists`` for the scripts: one JAX build serves them all, the
    pooled lists at group 256 and window 1.  A window-1 build with the
    dense layout (decide8-11) is that build too: the scripts read only its
    far_n (and time the rest), and at 2,048 bodies no pool folds a group,
    so the pooled far_n is the dense one (``tools/decide13``'s dense line
    reads the pooled line's far_n at this size).  Builds the scripts only
    time (decide9's list caps 2,048 and 512; decide11's other geometries;
    the window-2 lines of decide4 and decide6) are that build as well, and
    their lines are compared by label.  Group sizes 128 and 64 (decide2,
    decide3) get a build that raises, which the scripts report as FAILED.
    No worklist budget or list cap binds at 2,048 bodies (far_n < 1,200).
    """

    def __init__(self):
        self.lists = None

    def __call__(self, *args, **kw):
        if kw["group_size"] != 256 and kw["pool_tile"]:
            raise _Skipped("stood in for")
        if self.lists is None:
            kw.update(worklist_budget=0, list_cap=6144, group_size=256,
                      window_groups=1, pool_tile=512)
            self.lists = jbw.build_lists(*args, **kw)
        return self.lists


@pytest.fixture(scope="module")
def builds():
    return _Builds()


def _script_run(module, argv, builds, patches=()):
    """The script's ``main`` with its timeit and builds stood in for."""
    return _script(module, argv, [
        (module, "timeit", lambda *a, reps=3: 0.0),
        (module, "build_lists", builds)] + list(patches))


def _once(fn, *args, **kwargs):
    fn()
    return Marginal(0.0, 0.0, None, None)


def _once_ms(fn, k, device, reps=3):
    fn()
    return 0.0, None


def _timed_once():
    """The ports' timing chains, each timed call run once."""
    patches = [(round3, "chain_ms", _once_ms)]
    for module in TOOLS:
        if hasattr(module, "marginal"):
            patches.append((module, "marginal", _once))
    return patches


def _port_run(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` of a port with its timing run once: (its
    return, its stdout)."""
    with pytest.MonkeyPatch.context() as mp, _quiet_cpu() as out:
        for obj, name, value in _timed_once():
            mp.setattr(obj, name, value)
        ret = fn(*args, **kwargs)
    return ret, out.getvalue()


def _port_main(module, argv):
    with pytest.MonkeyPatch.context() as mp:
        for obj, name, value in _timed_once():
            mp.setattr(obj, name, value)
        return _port(module.main, argv)


def _mask(label):
    return re.sub(r"\d+(\.\d+)?", "#", label)


def _labels(text):
    """Each line's label (before its first colon), numbers masked; the
    port's own lines (``#``, the device line) left out."""
    return [_mask(x.split(":")[0].strip()) for x in text.splitlines()
            if ":" in x and not x.startswith(("#", "device "))]


def _numbers(text):
    return {k: float(v) for k, v in
            re.findall(r"([\w/-]+)=(-?[\d.]+(?:e[-+]?\d+)?)", text)}


def _line(text, start):
    (x,) = [x for x in text.splitlines() if x.strip().startswith(start)]
    return x


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
# decide2, decide3: the sweeps with errors
# ---------------------------------------------------------------------------

_EVALS = []        # (lists, key, output) of JAX's pooled evals


def _digest(x):
    return hashlib.sha1(np.asarray(x).tobytes()).hexdigest()


def _shared_eval(fn, lists, pos_s, mass_s, dt, **kw):
    """``fn``, a script's ``eval_accel_sorted``, once a set of pooled lists,
    state and configuration in this module: on pooled lists the eval
    reads none of the knobs the scripts vary (``use_cols``, ``far_tile``,
    ``iblk``, the groups a program), so decide2's, decide3's, decide4's
    and decide5's calls on the shared build share one output."""
    free = ("use_cols", "far_tile", "iblk", "gpp")
    key = (_digest(pos_s), _digest(mass_s), float(dt),
           sorted((k, v) for k, v in kw.items() if k not in free))
    if lists.pool is not None:
        for done, k, out in _EVALS:
            if done is lists and k == key:
                return out
    out = fn(lists, pos_s, mass_s, dt, **kw)
    if lists.pool is not None:
        _EVALS.append((lists, key, out))
    return out


def _captured_evals(module):
    """A stand-in for the script's ``eval_accel_sorted`` that keeps each
    call's lists and output (:func:`_shared_eval`)."""
    kept = []
    fn = module.eval_accel_sorted

    def keep(lists, *args, **kwargs):
        out = _shared_eval(fn, lists, *args, **kwargs)
        kept.append((lists, out))
        return out
    return kept, (module, "eval_accel_sorted", keep)


def _no_oracle(module):
    """A stand-in for ``jax.lax.map`` in the script's own direct sum (its
    printed errors are not compared: the captured accelerations are, with
    the port's direct sum); every other caller gets the real one."""
    import sys
    import jax
    real = jax.lax.map

    def lax_map(f, xs, *args, **kwargs):
        if sys._getframe(1).f_globals["__name__"] == module.__name__:
            return jax.numpy.ones((xs.shape[0], 3), xs.dtype)
        return real(f, xs, *args, **kwargs)
    return (jax.lax, "map", lax_map)


def _want_errors(lists, acc):
    """The script's error statistics of its own accelerations against the
    port's direct sum on the same 1,024 samples, unrounded."""
    cfg = round3.ab_config(N)
    dev = torch.device("cpu")
    pos, _, mass = round3.initial_state(cfg, dev)
    ora = round3.oracle(pos, mass, cfg, decide2.SAMPLE, dev)
    view = type("L", (), {"inv_order": torch.tensor(
        np.array(lists.inv_order))})
    err, errn = round3.errors(torch.tensor(np.array(acc)), view, *ora)
    return dict(err_med=np.median(err), err_p99=np.percentile(err, 99),
                errn_med=np.median(errn), errn_p99=np.percentile(errn, 99),
                errn_rms=np.sqrt((errn ** 2).mean()))


def _far_fields(line):
    """far_n's mean, p99, max and at_cap, and pairs/body, of a line."""
    parts = [p for p in line.split(" | ")
             if p.startswith(("far_n", "pairs/body"))]
    return _numbers(" ".join(parts))


def _assert_sweep_row(rec, text, want_text, tag, lists, acc):
    w = _far_fields(_line(want_text, f"{tag}:"))
    g = _far_fields(_line(text, f"{tag}:"))
    assert len(w) == 5
    for k in ("mean", "p99", "max", "at_cap", "pairs/body"):
        assert g[k] == w[k], (tag, k, g[k], w[k])
    for k, x in _want_errors(lists, acc).items():
        assert abs(rec[k] - x) <= TOL, (tag, k, rec[k], x)


def test_decide2_matches_the_script(builds):
    """The script's group-256 line on the shared build and its first
    line, group 128 at window 2, on JAX's own build; the other three
    (group 128 at window 1 and list cap 4,096, group 64) are stood in for
    (FAILED there) and run on the port only."""
    kept, patch = _captured_evals(jax_decide2)
    computed = ("G128_W2_L6144", "G256_W1_L6144")

    def g128_w2(*args, **kw):
        if (kw["group_size"], kw["window_groups"], kw["list_cap"]) == (
                128, 2, 6144):
            return jbw.build_lists(*args, **kw)
        return builds(*args, **kw)
    want = _script_run(jax_decide2, [str(N)], g128_w2,
                       [patch, _no_oracle(jax_decide2)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decide2, "VARIANTS", tuple(
            v for v in decide2.VARIANTS if v[0] in computed))
        recs, got = _port_run(decide2.run, N, torch.device("cpu"))
    assert "FAILED" not in got
    assert want.count("BUILD FAILED") == 3
    assert _labels(got) == [_mask(t) for t in computed]
    assert _labels(want) == [_mask(t) for t, *_ in decide2.VARIANTS]
    assert _line(got, "n=") == _line(want, "n=")
    assert len(kept) == 2
    for tag, (lists, acc) in zip(computed, kept):
        _assert_sweep_row(recs[tag], got, want, tag, lists, acc)


def test_decide3_matches_the_script(builds):
    """The script computes its window-1 line at group 256; its window-2
    line is stood in for (FAILED there) and compared by label."""
    kept, patch = _captured_evals(jax_decide3)

    def window_1(*args, **kw):
        if kw["window_groups"] != 1:
            raise _Skipped("stood in for")
        return builds(*args, **kw)
    want = _script_run(jax_decide3, [str(N)], window_1,
                       [patch, _no_oracle(jax_decide3)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decide3, "VARIANTS", decide3.VARIANTS[:2])
        recs, got = _port_run(decide3.run, N, torch.device("cpu"))
    assert "FAILED" not in got
    assert _labels(got) == _labels(want)[:2]
    assert [_mask(x.split(":")[0]) for x in want.splitlines()
            if "FAILED" in x] == [_mask(t) for t, *_ in decide3.VARIANTS
                                  if t != "G256_W1_L6144_B0"]
    # The configuration's two evals (old, cols): the errors are cols'.
    assert len(kept) == 2
    tag = "G256_W1_L6144_B0"
    lists, acc = kept[1]
    _assert_sweep_row(recs[tag], got, want, tag, lists, acc)
    w = float(re.search(r"kern_dev (\S+)\)",
                        _line(want, f"{tag}:")).group(1))
    assert abs(recs[tag]["kern_dev"] - w) <= TOL
    assert recs["G256_W2_L6144_B0"]["kern_dev"] == 0.0


# ---------------------------------------------------------------------------
# decide4-6: the eval's rows on pooled lists, the boids A/B
# ---------------------------------------------------------------------------

def _devs(text):
    return {x.split(":")[0].strip(): float(re.search(
        r"\(dev (-?[\w.+-]+)\)", x).group(1)) for x in text.splitlines()
        if "(dev " in x}


def test_decide4_matches_the_script(builds):
    """Every row of the script is the pooled kernel at window 1 and 4
    groups a program, one JAX eval (the pooled kernel reads neither
    ``use_cols`` nor ``far_tile``, and its output does not depend on the
    groups a program; the window-2 rows, on the window-1 build, are
    compared by label): the deviations are each row's against the first
    on the same lists, on both sides."""
    fn = jax_decide4.eval_accel_sorted

    def window_1(*args, **kw):
        return _shared_eval(fn, *args, **dict(kw, gpp=4, window_groups=1))
    want = _script_run(jax_decide4, [str(N)], builds, [
        (jax_decide4, "eval_accel_sorted", window_1)])
    got = _port_main(decide4, [str(N)])
    assert _labels(got) == _labels(want)
    dw, dg = _devs(want), _devs(got)
    assert set(dw) == set(dg) and len(dw) == 8
    for k, x in dw.items():
        assert abs(dg[k] - x) <= TOL, (k, dg[k], x)
    assert "(no counterpart on the card: gpp=8)" in got


def test_decide5_matches_the_script(builds):
    """The script's six rows differ only in ``iblk`` (which its pooled
    kernel does not read) and far_n: one JAX eval each with and without
    the far lists serves them."""
    fn, nofar = jax_decide5.eval_accel_sorted, []

    def once(lists, pos_s, mass_s, dt, **kw):
        if np.asarray(lists.far_n).any():
            return _shared_eval(fn, lists, pos_s, mass_s, dt, **kw)
        if not nofar:
            nofar.append(fn(lists, pos_s, mass_s, dt, **kw))
        return nofar[0]
    want = _script_run(jax_decide5, [str(N)], builds, [
        (jax_decide5, "boids_part", lambda n: None),
        (jax_decide5, "eval_accel_sorted", once)])
    got = _port_main(decide5, [str(N), "--boids"])
    assert _labels(got) == _labels(want)
    dw, dg = _devs(want), _devs(got)
    assert set(dw) == set(dg) and len(dw) == 6
    for k, x in dw.items():
        assert (np.isnan(x) and np.isnan(dg[k])) or abs(dg[k] - x) <= TOL
    assert got.count("(no counterpart on the card: iblk=") == 6


def test_decide5_and_decide6_boids_rows_match_the_script(monkeypatch):
    """The boids part of both scripts (the same function) at 1,024 boids:
    the header and the two rows."""
    monkeypatch.setattr(jax_decide5, "timeit", lambda *a, reps=3: 0.0)
    with _quiet_cpu() as out:
        jax_decide5.boids_part(N_BOIDS)
    want = out.getvalue()
    for module in (decide5, decide6):
        _, got = _port_run(module.boids_part, N_BOIDS, torch.device("cpu"))
        assert _line(got, "boids n=") == _line(want, "boids n=")
        assert _labels(got) == _labels(want)


def test_decide6_matches_the_script(builds):
    want = _script_run(jax_decide6, [str(N)], builds, [
        (jax_decide6, "boids_part", lambda n: None)])
    got = _port_main(decide6, [str(N), "--boids"])
    assert _labels(got) == _labels(want)
    means = re.compile(r"^(W1_\w+): .*far_n mean=(\d+)", re.M)
    assert means.findall(got) == means.findall(want)
    assert len(means.findall(got)) == 3


# ---------------------------------------------------------------------------
# decide19: the packed-gather layouts
# ---------------------------------------------------------------------------

def test_decide19_matches_the_script(monkeypatch):
    monkeypatch.setattr(jax_decide19, "timeit", lambda fn, reps=3: 0.0)
    with _quiet_cpu() as out:
        jax_decide19.bench(D19["k"], D19["n"], D19["w"])
    want = out.getvalue()
    _, got = _port_run(decide19.bench, D19["k"], D19["n"], D19["w"],
                       torch.device("cpu"))
    assert _labels(got) == _labels(want) and len(_labels(got)) == 3
    assert [k for k in decide19.KS] == [6, 10, 2]


def test_decide19_layouts_sum_the_same_rows():
    """The three layouts' one call gives one answer (the chained ids stay
    inside the table)."""
    rows = torch.rand((6, 1000), generator=torch.Generator().manual_seed(0))
    idx = torch.randint(0, 1000, (5000,),
                        generator=torch.Generator().manual_seed(1))
    a = rows[:, idx].sum(0)
    b = sum(rows[r][idx] for r in range(6))
    c = rows.T.contiguous()[idx, :].sum(1)
    assert torch.allclose(a, b) and torch.allclose(a, c)


# ---------------------------------------------------------------------------
# decide8-11: the dense kernel's round-3 decomposition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool", (decide8, decide9, decide10, decide11),
                         ids=lambda m: m.__name__.split(".")[-1])
def test_dense_decomposition_matches_the_script(builds, tool):
    want = _script_run(SCRIPTS[tool], [str(N)], builds)
    got = _port_main(tool, [str(N)])
    assert "FAILED" not in want and "FAILED" not in got
    assert _labels(got) == _labels(want)
    if tool in (decide8, decide10):
        assert _line(got, "n=") == _line(want, "n=")
    if tool is decide11:
        first = "gsz=256 W1 g4 mxu:"
        assert (_numbers(_line(got, first))["far_mean"]
                == _numbers(_line(want, first))["far_mean"])


def test_dense_decomposition_rows_name_what_the_card_ignores():
    """Every knob without a counterpart on the card is named on its row."""
    for tag, dbg, knobs in decide8.ROWS:
        assert ("vm" in tag) == any("vmem_mb" in k for k in knobs)
        assert ("nocost" in tag) == ("no_cost" in knobs)
        assert (dbg == decide8.EMPTY) == tag.startswith("empty")
    for tag, dbg, keep, knobs in decide10.ROWS:
        assert knobs[0] == f"tgt_mode={tag.split('_')[0]}"
        assert keep == (tag != "mxu_nofar")


def test_decide10_target_transpose_matches_the_script():
    """The port's ``tgt_transpose`` against the script's ``mk_tgtT`` (its
    lines, in jax.numpy) on sorted positions of 9 groups: padded to whole
    programs of 4, permuted, padded to 16 lanes and to 128."""
    import jax.numpy as jnp
    gsz, gpp, lanes = 64, decide10.GPP, decide10.TGT_LANES
    npad = 9 * gsz
    sp = np.random.default_rng(2).normal(size=(3, npad)).astype(np.float32)
    ng = npad // gsz
    ng2 = ((ng + gpp - 1) // gpp) * gpp
    nprog = ng2 // gpp
    width = ((lanes * gpp + 127) // 128) * 128
    t = jnp.pad(jnp.asarray(sp), ((0, 0), (0, (ng2 - ng) * gsz)))
    t = t.reshape(3, nprog, gpp, gsz).transpose(3, 1, 2, 0)
    t = jnp.pad(t, ((0, 0), (0, 0), (0, 0), (0, lanes - 3)))
    t = t.reshape(gsz, nprog, gpp * lanes)
    if width != gpp * lanes:
        t = jnp.pad(t, ((0, 0), (0, 0), (0, width - gpp * lanes)))
    want = np.asarray(t.reshape(gsz, nprog * width))
    got = decide10.tgt_transpose(torch.tensor(sp), gsz)
    np.testing.assert_array_equal(got.numpy(), want)
