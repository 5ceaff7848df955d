"""The port's rebuild and eval measurement tools against the JAX scripts
they port, on the CPU (the cases of ``tests/test_torch_jax_tools.py``'s
kind, in a file of their own so that the suite's workers share them):
``tools/decide7.py``, ``prof_rebuild.py``, ``eval_bench.py`` (its first
variant), ``diag10m.py`` and ``decide29.py`` against the ``main`` of
``scripts/`` of the same names at 2,048 bodies (JAX with Pallas in
interpret mode; the port's wrappers take their plain versions), field by
field, times not compared.

``scripts/decide_1m.py`` and ``scripts/quick_metrics.py`` do not compile:
``kw["pool_tile"] = 0`` is dedented out of its ``for`` loop
(``decide_1m.py:87``, ``quick_metrics.py:49``), an ``IndentationError``.
Their ports build dense lists in every variant, as the scripts mean to;
they are held to the JAX functions the scripts call: ``build_lists`` with
``pool_tile=0``, ``eval_accel_sorted`` and ``refresh_lists``.

Where the port calibrates (``diag10m``, ``decide29``), the script's
calibration returns the port's calibrated configuration, after checking
that its own input equals the port's (as ``test_torch_jax_tools.py``
does for ``extreme_run``): the two packages size the pool differently on
purpose (``ROADMAP.md``, "Pool cap").

Tolerance: the ablation rows' accelerations within 1e-4 of max|a| (of
the largest block sum for ``nouttr``: ``tests/test_torch_ablation.py``);
error statistics within 1e-4 absolute; counts, caps and the printed
lines' integers exact.
"""

import dataclasses
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts import decide7 as jax_decide7
from scripts import decide29 as jax_decide29
from scripts import diag10m as jax_diag10m
from scripts import eval_bench as jax_eval_bench
from scripts import prof_rebuild as jax_prof_rebuild
from spatialsim_tpu.config import nbody as jax_nbody
from spatialsim_tpu.ops import bh_window as jax_bw
from spatialsim_tpu_torch.config.nbody import NBodyConfig
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools import (
    decide7, decide29, decide_1m, diag10m, eval_bench, prof_rebuild,
    quick_metrics)
from spatialsim_tpu_torch.tools.oracle import initial_conditions
from test_torch_jax_tools import _port, _quiet_cpu, _script, _to_jax

N = 2048
TOL = 1e-4


def _rel(got, want):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    return err / scale if scale else (0.0 if err == 0 else np.inf)


def _fields(line):
    """``key=value`` pairs of a printed line (numbers as floats)."""
    return {k: float(v.rstrip(",")) for k, v in
            re.findall(r"(\w+)=(-?[\d.]+(?:e[-+]?\d+)?)", line)}


def _calibrated_like(distribution):
    """A stand-in for the JAX ``calibrate_config``: the port's calibration
    of the same configuration on the port's initial conditions, as the JAX
    package's type.  Records each configuration it was given."""
    seen = []

    def calibrate(c, pos, vel, mass):
        assert pos.shape[1] == N
        port_cfg = NBodyConfig(**{f.name: getattr(c, f.name)
                                  for f in dataclasses.fields(c)})
        with _quiet_cpu():
            p, v, m = initial_conditions(distribution, N,
                                         port_cfg.spawn_radius, port_cfg.G,
                                         torch.device("cpu"))
            out = bw.calibrate_config(port_cfg, p, v, m)
        seen.append(c)
        return _to_jax(out)
    return calibrate, seen


# ---------------------------------------------------------------------------
# decide7: the ablation rows' accelerations, both geometries
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decide7_runs():
    jax_out, port_out = [], []

    def jax_timeit(fn, reps=3):
        jax_out.append(np.asarray(fn()))
        return 0.0

    def port_time(fn, reps, device):
        port_out.append(fn().numpy())
        return 0.0
    text = _script(jax_decide7, [str(N)],
                   [(jax_decide7, "timeit", jax_timeit)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decide7, "time_ms", port_time)
        got = _port(decide7.main, [str(N)])
    return text, got, jax_out, port_out


def test_decide7_lines_match_the_script(decide7_runs):
    text, got, _, _ = decide7_runs
    want = [x for x in text.splitlines() if x.startswith("n=")]
    mine = [x for x in got.splitlines() if x.startswith("n=")]
    assert len(want) == len(mine) == len(decide7.GEOMETRIES)
    for w, g in zip(want, mine):
        assert g.startswith(w.split("far_mean=")[0])
        assert _fields(g)["far_mean"] == _fields(w)["far_mean"]
        assert "ignored on the card" in g
    tags = [t for t, _, _ in decide7.ROWS] * len(decide7.GEOMETRIES)
    assert [x.split(":")[0].strip() for x in text.splitlines()
            if x.startswith("  ")] == tags
    assert [x.split(":")[0].strip() for x in got.splitlines()
            if x.startswith("  ")] == tags


@pytest.mark.parametrize("geometry", [0, 1], ids=["g256", "g512"])
@pytest.mark.parametrize("row", range(len(decide7.ROWS)),
                         ids=[t for t, _, _ in decide7.ROWS])
def test_decide7_rows_match_the_script(decide7_runs, geometry, row):
    _, _, jax_out, port_out = decide7_runs
    assert len(jax_out) == len(port_out) == 2 * len(decide7.ROWS)
    i = geometry * len(decide7.ROWS) + row
    got, want = port_out[i], jax_out[i]
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL, (decide7.ROWS[row], _rel(got, want))


# ---------------------------------------------------------------------------
# prof_rebuild and eval_bench
# ---------------------------------------------------------------------------

def _diag(text):
    """The ``build_diagnostics`` JSON block of a printed run."""
    start = text.index("{\n")
    return json.loads(text[start:text.index("\n}", start) + 2])


def test_prof_rebuild_matches_the_script():
    want = _script(jax_prof_rebuild, [str(N)])
    got = _port(prof_rebuild.main, [str(N)])
    dw, dg = _diag(want), _diag(got)
    for key, x in dw.items():
        if isinstance(x, float):
            assert abs(dg[key] - x) <= TOL * max(1.0, abs(x)), key
        else:
            assert dg[key] == x, key
    for marker in ("per-level fill:", "total slots="):
        (w,) = [x for x in want.splitlines() if x.startswith(marker)]
        (g,) = [x for x in got.splitlines() if x.startswith(marker)]
        assert g == w
    for marker in ("built lists:", "rebuild:", "eval:", "sustained:"):
        assert marker in got
    assert "at_cap=0" in got and "folded=0/" in got


def test_eval_bench_first_variant_matches_the_script():
    want = _script(jax_eval_bench, [str(N)])
    got = _port(eval_bench.main, [str(N)])
    (w,) = [x for x in want.splitlines() if "ms/step" in x]
    (g,) = [x for x in got.splitlines() if "ms/step" in x]
    tag = next(iter(eval_bench.VARIANTS))
    assert w.split(":")[0].strip() == g.split(":")[0].strip() == tag
    assert "pooled, 0 rebuilds" in g


def test_eval_bench_notes_the_knobs_without_effect():
    assert eval_bench.note("tile256_wg2") == \
        "  (no effect on the card: eval_far_tile)"
    assert "eval_groups_per_program" in eval_bench.note("probe_gpp8")
    assert "plain versions" in eval_bench.note("xla_fallback")
    assert eval_bench.note("probe_wg1") == ""
    assert list(eval_bench.VARIANTS) == list(jax_eval_bench.VARIANTS)
    assert eval_bench.VARIANTS == jax_eval_bench.VARIANTS


def test_eval_bench_plain_variant_is_the_plain_step():
    """``xla_fallback`` (``eval_bench.plain_step``: dense lists, the dense
    kernel's plain version) against the JAX step with
    ``use_pallas_eval=False`` on the same inputs, two substeps: the same
    lists, the accelerations within 2e-4 of max|a|, positions and
    velocities within 1e-5 of their largest.  2e-4 is the bar at which the
    JAX package holds that plain eval to its Pallas one
    (``tests/test_bh_window.py::test_near_groups_pallas_matches_xla``,
    rtol = atol = 2e-4): it sums ``w s - t sum(w)`` about the group's
    mean, which loses about 1e-4 of max|a| to cancellation here.  On the
    CPU the production step takes the same plain version, so the chain
    must equal it bit for bit."""
    cfg = eval_bench.base_config(N).replace(use_pallas_eval=False)
    with _quiet_cpu():
        pos, vel, mass = initial_conditions("galaxy", N, cfg.spawn_radius,
                                            cfg.G, torch.device("cpu"))
        st = bw.init_window_state(pos, vel, mass, cfg)
        got = eval_bench.plain_step(cfg, N, 2)(st, 0.02)
        prod = bw.make_window_step(cfg, N, substeps=2)(st, 0.02)
        jcfg = _to_jax(cfg)
        jst = jax_bw.init_window_state(
            *(jnp.asarray(x.numpy()) for x in (pos, vel, mass)), jcfg)
        want = jax_bw.make_window_step(jcfg, N, substeps=2)(
            jst, jnp.float32(0.02))
    assert st.lists.pool is None
    assert np.array_equal(got.lists.order.numpy(),
                          np.asarray(want.lists.order))
    assert np.array_equal(got.lists.far_n.numpy(),
                          np.asarray(want.lists.far_n))
    assert int(got.lists.steps_since) == int(want.lists.steps_since) == 2
    assert _rel(got.acc.numpy(), np.asarray(want.acc)) <= 2e-4
    for a, b in ((got.pos, want.pos), (got.vel, want.vel)):
        assert _rel(a.numpy(), np.asarray(b)) <= 1e-5
    for a, b in ((got.pos, prod.pos), (got.vel, prod.vel),
                 (got.acc, prod.acc)):
        assert torch.equal(a, b)


def test_eval_bench_plain_step_refuses_a_rebuilding_chain():
    cfg = eval_bench.base_config(N).replace(use_pallas_eval=False,
                                            rebuild_interval=24)
    with pytest.raises(ValueError):
        eval_bench.plain_step(cfg, N, 2)


# ---------------------------------------------------------------------------
# diag10m and decide29 (10M tools; long on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_diag10m_matches_the_script():
    calibrate, seen = _calibrated_like("cluster")
    want = _script(jax_diag10m, [str(N)],
                   [(jax_bw, "calibrate_config", calibrate)])
    assert len(seen) == 1
    assert seen[0] == _to_jax(diag10m.diag_config(N))
    got = _port(diag10m.main, [str(N)])
    head_w = _fields(next(x for x in want.splitlines()
                          if x.startswith("platform=")))
    head_g = _fields(next(x for x in got.splitlines()
                          if x.startswith("device=")))
    for key in ("depth", "gsz", "L", "pool", "adv"):
        assert head_g[key] == head_w[key], key
    for marker in ("  tree_caps=", "  wl_caps=", "  pool cap_tiles="):
        lines_w = [x for x in want.splitlines() if x.startswith(marker)]
        lines_g = [x for x in got.splitlines() if x.startswith(marker)]
        assert lines_g == lines_w, marker
    labels = re.compile(r"(dispatch \d \([a-z+-]+\)|init_window_state) OK")
    assert labels.findall(got) == labels.findall(want)
    assert "sustained" in got and "ledger GB:" in got


@pytest.mark.slow
def test_decide29_matches_the_script():
    calibrate, seen = _calibrated_like("cluster")
    want = _script(jax_decide29, [str(N)],
                   [(jax_bw, "calibrate_config", calibrate)])
    base = decide29.scan_config(N)
    assert seen == [_to_jax(base.replace(**over))
                    for _, over in decide29.VARIANTS]
    got = _port(decide29.main, [str(N)])
    for tag, _ in decide29.VARIANTS:
        (w,) = [x for x in want.splitlines() if x.startswith(f"[{tag}] err")]
        (g,) = [x for x in got.splitlines() if x.startswith(f"[{tag}] err")]
        fw, fg = _fields(w), _fields(g)
        assert set(fw) == set(fg) == {"median", "p99", "rms"}
        assert all(abs(fg[k] - fw[k]) <= TOL + 1e-9 for k in fw)
    cfgs = [json.loads(x)["cfg"] for x in got.splitlines()
            if x.startswith("{")]
    assert cfgs == [json.loads(x)["cfg"] for x in want.splitlines()
                    if x.startswith("{")] == [t for t, _ in decide29.VARIANTS]


# ---------------------------------------------------------------------------
# decide_1m and quick_metrics against the JAX functions
# ---------------------------------------------------------------------------

def _jax_matrix(n, variants, sample):
    """What the two scripts mean to print, through the JAX functions they
    call: dense lists (``pool_tile=0``) for each (tag, K, L, B), far_n's
    statistics, and the sampled error of ``eval_accel_sorted`` (Pallas in
    interpret mode) against a float64 direct sum, mapped through
    ``inv_order``; ``refresh_lists`` runs once on each."""
    base = jax_nbody.resolve_config(jax_nbody.NBodyConfig(
        num_bodies=n, theta=0.8, G=0.1, softening=2.0, damping=1.0,
        spawn_radius=500.0, distribution="galaxy", engine="window",
        skin=2.0, rebuild_interval=48, rebuild_drift_mode="off"), n)
    with _quiet_cpu():
        pos, vel, mass = (t.numpy() for t in initial_conditions(
            "galaxy", n, base.spawn_radius, base.G, torch.device("cpu")))
    idx = np.sort(np.random.default_rng(1).choice(n, sample, replace=False))
    d = pos[:, None, :].astype(np.float64) - pos[:, idx, None]
    r2 = (d * d).sum(0) + base.softening ** 2
    w = np.where(r2 > base.softening ** 2,
                 base.G * mass[None, :] * r2 ** -1.5, 0.0)
    exact = (w[None] * d).sum(2)
    mag = np.linalg.norm(exact, axis=0)
    rms_mag = np.sqrt((mag ** 2).mean())
    jpos, jvel, jmass = (jnp.asarray(a) for a in (pos, vel, mass))
    recs = {}
    for tag, K, L, B in variants:
        cfg = base.replace(list_capacity=L, near_groups=K, worklist_budget=B)
        kw = jax_bw._build_kw(cfg)
        kw["pool_tile"] = 0
        lists = jax_bw.build_lists(jpos, jvel, jmass, jnp.zeros_like(jpos),
                                   **kw)
        order = np.asarray(lists.order)[:n]
        pos_s, vel_s, mass_s = (jnp.asarray(a[..., order])
                                for a in (pos, vel, mass))
        acc = np.asarray(jax_bw.eval_accel_sorted(
            lists, pos_s, mass_s, jnp.float32(0.02), G=cfg.G,
            softening=cfg.softening, group_size=cfg.group_size,
            window_groups=cfg.window_groups, use_pallas=True), np.float64)
        refreshed = jax_bw.refresh_lists(lists, pos_s, vel_s, mass_s,
                                         jnp.zeros_like(jpos), 0.02, 24.0)
        assert np.isfinite(np.asarray(refreshed.far)).all()
        acc_o = acc[:, np.asarray(lists.inv_order)[idx]]
        aerr = np.linalg.norm(acc_o - exact, axis=0)
        err, errn = aerr / np.maximum(mag, 1e-12), aerr / rms_mag
        fn = np.asarray(lists.far_n)
        recs[tag] = dict(
            far_n_mean=float(fn.mean()),
            far_n_p90=float(np.percentile(fn, 90)),
            far_n_p99=float(np.percentile(fn, 99)),
            far_n_max=int(fn.max()), at_cap=int((fn >= L - 1).sum()),
            err_med=float(np.median(err)),
            err_p99=float(np.percentile(err, 99)),
            errn_med=float(np.median(errn)),
            errn_p99=float(np.percentile(errn, 99)),
            errn_rms=float(np.sqrt((errn ** 2).mean())),
            far_shape=tuple(np.asarray(lists.far).shape))
    return recs


def _assert_record(got, want):
    for key, x in want.items():
        if isinstance(x, float):
            assert abs(got[key] - x) <= TOL * max(1.0, abs(x)), (key, got,
                                                                   want)
        else:
            assert got[key] == x, (key, got, want)


N_MATRIX = 8192        # 32 groups: K = 8 near groups leave far lists
QUICK = [("K0_L6144_B0", 0, 6144, 0), ("K8_L2048_B0", 8, 2048, 0)]


@pytest.mark.parametrize("variant", QUICK, ids=[v[0] for v in QUICK])
def test_decide_1m_matches_the_jax_functions(variant):
    want = _jax_matrix(N_MATRIX, [variant], 256)[variant[0]]
    with pytest.MonkeyPatch.context() as mp, _quiet_cpu():
        mp.setattr(decide_1m, "REPS", 1)
        (got,) = decide_1m.run(N_MATRIX, "cpu", sample=256,
                               variants=[variant], out=lambda *a, **k: None)
    assert got["cfg"] == variant[0]
    _assert_record(got, {k: v for k, v in want.items() if k != "far_n_p90"})
    assert got["far_n_mean"] > 0


@pytest.mark.slow
def test_decide_1m_every_variant_matches_the_jax_functions():
    want = _jax_matrix(N_MATRIX, decide_1m.VARIANTS, 256)
    with pytest.MonkeyPatch.context() as mp, _quiet_cpu():
        mp.setattr(decide_1m, "REPS", 1)
        got = decide_1m.run(N_MATRIX, "cpu", sample=256,
                            out=lambda *a, **k: None)
    assert [r["cfg"] for r in got] == [v[0] for v in decide_1m.VARIANTS]
    for rec in got:
        _assert_record(rec, {k: v for k, v in want[rec["cfg"]].items()
                             if k != "far_n_p90"})


def test_quick_metrics_matches_the_jax_functions():
    variants = [(f"L{L}", 0, L, 0) for L in quick_metrics.CAPS]
    want = _jax_matrix(N, variants, 64)
    with pytest.MonkeyPatch.context() as mp, _quiet_cpu():
        mp.setattr(quick_metrics, "REPS", 1)
        got = quick_metrics.run(N, "cpu", out=lambda *a, **k: None)
    assert [r["L"] for r in got] == list(quick_metrics.CAPS)
    for rec in got:
        w = want[f"L{rec['L']}"]
        _assert_record(rec, {k: w[k] for k in (
            "far_n_mean", "far_n_p90", "far_n_p99", "far_n_max", "at_cap")})
        assert all(np.isfinite(rec[k]) for k in ("eval_ms", "refresh_ms"))
