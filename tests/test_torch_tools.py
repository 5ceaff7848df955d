"""The port's measurement tools (ports of ``scripts/``) at ``--device cpu``
and a few thousand bodies: without a card each exits 1 unless ``--device
cpu`` is given; the oracle's and ``prof_parts``' mains print their lines;
the staleness taus and the grown caps.  The mains of ``staleness_scan``,
``nbody_error``, ``nbody_error_scan``, ``quad_scan`` and ``extreme_run``
are held to the JAX scripts they port in ``test_torch_jax_tools.py``,
``test_torch_jax_quad_tools.py``, ``test_torch_jax_stale_tools.py`` and
``test_torch_jax_extreme_tools.py``.
The tools' numbers on the card are in ``PERF.md``; here the wrappers
take their plain versions because the tensors lie on the CPU.
"""

import json

import pytest
import torch

from spatialsim_tpu_torch.tools import (
    extreme_run, nbody_error, nbody_error_scan, oracle, prof_parts,
    quad_scan, staleness_scan, verify_drive)

TOOLS = (oracle, staleness_scan, nbody_error, nbody_error_scan, quad_scan,
         extreme_run, prof_parts, verify_drive)


# Few threads a test: the suite runs several worker processes at once.
THREADS = 2


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__)
def test_tool_needs_a_card_unless_cpu_is_asked(tool, monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    try:
        rc = tool.main([])
    except SystemExit as exc:
        rc = exc.code
    assert rc == 1
    assert "--device cpu" in capsys.readouterr().err


def test_oracle_main(capsys):
    assert oracle.main(["--device", "cpu", "--sources", "2000",
                        "--targets", "128", "--ring", "512",
                        "--reps", "1"]) == 0
    recs = _json_lines(capsys.readouterr().out)
    modes = [r["mode"] for r in recs]
    assert modes == ["allpairs_at"] + ["ring_hops"] * 4 + ["allpairs"]
    assert recs[0]["bit_equal"] and recs[0]["rel_err"] == 0.0
    assert recs[0]["rel_err_f64"] <= 1e-5 and recs[0]["device"] == "cpu"
    assert [r["D"] for r in recs[1:5]] == [1, 2, 4, 8]
    assert all(r["rel_err"] <= 1e-5 for r in recs[1:5])


def test_staleness_taus_must_be_multiples_of_8():
    with pytest.raises(ValueError, match="multiples of 8"):
        staleness_scan.scan(512, taus=[0, 12], device="cpu")


def test_quad_scan_grows_caps_to_their_demand():
    import torch
    cfg = quad_scan.production_base(3000).replace(
        wl_caps=(1024,) + (128,) * 6)
    pos, vel, mass = oracle.initial_conditions("cluster", 3000, 500.0, 0.1,
                                               torch.device("cpu"))
    from spatialsim_tpu_torch.ops import bh_window as bw
    before = bw.build_diagnostics(pos, vel, mass, cfg)
    assert any(d > c for d, c in zip(before["wl_demand"], before["wl_caps"]))
    caps = quad_scan.grown_caps(cfg, pos, vel, mass)
    after = bw.build_diagnostics(pos, vel, mass,
                                 cfg.replace(wl_caps=tuple(caps)))
    assert all(d <= c for d, c in zip(after["wl_demand"], after["wl_caps"]))


def test_prof_parts_main(capsys):
    assert prof_parts.main(["3000", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for part in ("sort+morton:", "state gather:", "octree:", "build_lists:",
                 "traversal+finish:", "eval:"):
        assert part in out


@pytest.mark.slow
def test_quad_frontier_matches_jax_at_65k():
    """The 1M frontier's ``quad_d6_s1.0`` variant at 65,536 bodies reads
    |da| up to hundreds of |a| on a few bodies; the JAX package's function
    (its XLA eval) gives the same accelerations, so the error is the
    reference's behaviour, not the port's (~30 s on the CPU; ``-s``
    prints the error)."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    from spatialsim_tpu import distributions as jd
    from spatialsim_tpu.ops import bh_window as jbw
    from spatialsim_tpu_torch.ops import bh_window as bw
    n = 65_536
    cfg = quad_scan.frontier_base(n).replace(
        **dict(quad_scan.FRONTIER)["quad_d6_s1.0"])
    p, v, m = jd.generate_distribution("galaxy", n, 500.0, 0.1, seed=0)
    pos, vel, mass = (np.ascontiguousarray(a, np.float32)
                      for a in (p.T, v.T, m))
    idx = oracle.sample_ids(n, 2048)
    lists = jbw.build_lists(jnp.asarray(pos), jnp.asarray(vel),
                            jnp.asarray(mass), **jbw._build_kw(cfg))
    want = np.asarray(jbw.eval_accel(
        lists, jnp.asarray(pos), jnp.asarray(mass), jnp.float32(0.02),
        G=cfg.G, softening=cfg.softening, group_size=cfg.group_size,
        window_groups=cfg.window_groups, use_pallas=False, quadrupole=True,
        tau_clamp=float(cfg.advance_tau_clamp)))[:, idx]
    tp, tv, tm = map(torch.from_numpy, (pos, vel, mass))
    got = bw.eval_accel(bw.build_lists(tp, tv, tm, **bw._build_kw(cfg)),
                        tp, tm, 0.02, **bw._eval_kw(cfg))[:, idx].numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    exact = oracle.exact_accel_at(tp[:, idx], tp, tm, cfg.G, cfg.softening)
    err = oracle.relative_errors(want, exact)
    print(f"quad_d6_s1.0 at {n}: rms of |da|/|a| "
          f"{np.sqrt((err ** 2).mean()):.4f}, max {err.max():.2f}")
