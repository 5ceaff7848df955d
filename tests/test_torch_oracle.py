"""Kernel 1's targets-and-sources mode and the direct-sum oracle of the
port's measurement tools (``ops/allpairs.py`` ``allpairs_accel_at``,
``tools/oracle.py``) against the JAX scripts' oracle, the JAX ring's hop
sum and the JAX all-pairs kernel (Pallas in interpret mode), on the CPU.

The CUDA mode runs only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 22); here the wrapper takes its plain version
because the tensors lie on the CPU.  Tolerance: max|da| / max|a| <= 1e-5,
as kernel 1's: the same pairs summed in another order (JAX's chunks of
256 targets, XLA's reductions).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts import nbody_error_scan as jax_scan
from scripts import staleness_scan as jax_stale
from spatialsim_tpu.ops.allpairs import allpairs_accel as jax_allpairs
from spatialsim_tpu.parallel import sharded as jax_sharded
from spatialsim_tpu_torch.ops.allpairs import (
    ALLPAIRS_TILE, allpairs_accel_at, allpairs_accel_reference,
    allpairs_at_launch, allpairs_at_plan, allpairs_at_reference)
from spatialsim_tpu_torch.tools import oracle

G, SOFT = 0.1, 2.0
TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _targets_and_sources(k=256, n=3000, seed=3):
    """Sources of a seeded cluster and ``k`` targets, a quarter of them
    exactly on sources (coincident pairs, which the gate drops)."""
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((3, n)) * 50.0).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    tgt = (rng.standard_normal((3, k)) * 50.0).astype(np.float32)
    on = rng.choice(n, k // 4, replace=False)
    tgt[:, :k // 4] = pos[:, on]
    return tgt, pos, mass


def test_plain_mode_matches_the_jax_oracle_and_ring_hop():
    tgt, pos, mass = _targets_and_sources()
    got = allpairs_at_reference(torch.from_numpy(tgt), torch.from_numpy(pos),
                                torch.from_numpy(mass), G, SOFT).numpy()
    oracle_want = np.asarray(jax_scan.exact_accel_at(
        jnp.asarray(tgt), jnp.asarray(pos), jnp.asarray(mass), G, SOFT ** 2))
    hop_want = np.asarray(jax_sharded._partial_accel(
        jnp.asarray(tgt), jnp.asarray(pos), jnp.asarray(mass), G,
        SOFT ** 2))
    assert got.shape == (3, 256) and np.isfinite(got).all()
    assert _rel(got, oracle_want) <= TOL
    assert _rel(got, hop_want) <= TOL


def test_coincident_pairs_are_dropped_at_zero_softening():
    tgt, pos, mass = _targets_and_sources(k=64, n=500, seed=4)
    got = allpairs_at_reference(torch.from_numpy(tgt), torch.from_numpy(pos),
                                torch.from_numpy(mass), G, 0.0).numpy()
    want = np.asarray(jax_scan.exact_accel_at(
        jnp.asarray(np.pad(tgt, ((0, 0), (0, 192)))), jnp.asarray(pos),
        jnp.asarray(mass), G, 0.0))[:, :64]
    assert np.isfinite(got).all()
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("n", [1000, 2048])
def test_targets_equal_to_sources_give_the_all_pairs_sum(n):
    rng = np.random.default_rng(n)
    pos = (rng.standard_normal((3, n)) * 80.0).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    got = allpairs_accel_at(p, p, m, G, SOFT).numpy()
    assert _rel(got, allpairs_accel_reference(p, m, G, SOFT).numpy()) <= TOL
    want = np.asarray(jax_allpairs(jnp.asarray(pos), jnp.asarray(mass), G,
                                   SOFT))
    assert _rel(got, want) <= TOL


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    tgt, pos, mass = _targets_and_sources(k=100, n=700, seed=5)
    t, p, m = map(torch.from_numpy, (tgt, pos, mass))
    before = allpairs_accel_at.launches
    got = oracle.exact_accel_at(t, p, m, G, SOFT)
    assert allpairs_accel_at.launches == before
    np.testing.assert_array_equal(
        got.numpy(), allpairs_at_reference(t, p, m, G, SOFT).numpy())
    with pytest.raises(ValueError, match="unsupported devices"):
        allpairs_at_launch(t, p, m, G, SOFT, threads=128,
                           targets_per_thread=2, tiles_per_slice=1)


def test_plain_version_keeps_float64():
    tgt, pos, mass = _targets_and_sources(k=32, n=400, seed=6)
    got = allpairs_at_reference(*(torch.from_numpy(a).double()
                                  for a in (tgt, pos, mass)), G, SOFT)
    assert got.dtype == torch.float64
    want = allpairs_at_reference(*map(torch.from_numpy, (tgt, pos, mass)),
                                 G, SOFT)
    assert _rel(want.numpy(), got.numpy()) <= TOL


@pytest.mark.parametrize("k,n", [(4096, 1_048_576), (4096, 10_000_000),
                                 (4096, 50_000_000), (64, 50_000_000),
                                 (32_768, 32_768), (4096, 4096), (1, 1),
                                 (1000, 257)])
def test_plan_fills_the_card_within_the_grid_limits(k, n):
    threads, T, per = allpairs_at_plan(k, n)
    tiles = -(-n // ALLPAIRS_TILE)
    slices = -(-tiles // per)
    tblocks = -(-k // (threads * T))
    assert (threads, T) == (128, 2) and 1 <= per <= tiles
    assert 1 <= slices <= 65_535
    # At least about 8 waves of blocks where the work allows it.
    assert tblocks * slices >= min(tblocks * tiles, 8 * 12 * 132 // 2)


def test_err_stats_and_report_equal_the_jax_scripts(capsys):
    rng = np.random.default_rng(7)
    exact = rng.standard_normal((3, 300)).astype(np.float32)
    acc = exact + 1e-3 * rng.standard_normal((3, 300)).astype(np.float32)
    acc_full = rng.standard_normal((3, 1000)).astype(np.float32)
    idx = np.sort(rng.choice(1000, 300, replace=False))
    acc_full[:, idx] = acc
    assert oracle.err_stats(torch.from_numpy(acc_full), exact, idx) == \
        jax_stale.err_stats(jnp.asarray(acc_full), jnp.asarray(exact), idx)
    for t_build in (None, 0.1234):
        jax_scan.report("cfg", jnp.asarray(acc), jnp.asarray(exact), t_build)
        want = capsys.readouterr().out
        rec = oracle.report("cfg", torch.from_numpy(acc), exact, t_build)
        assert capsys.readouterr().out == want
        assert rec == json.loads(want)


def test_sample_ids_are_the_scripts_sample():
    want = np.sort(np.random.default_rng(1).choice(5000, 256, replace=False))
    np.testing.assert_array_equal(oracle.sample_ids(5000, 256), want)


def test_bound_counts_19_operations_a_pair():
    ms, by = oracle.bound_ms(4096, 1_048_576)
    assert by == "operations"
    assert ms == pytest.approx(19 * 4096 * 1_048_576 / 67e12 * 1e3)
    assert ms == pytest.approx(1.218, abs=1e-3)
    assert oracle.bound_ms(4096, 50_000_000)[0] == pytest.approx(58.1,
                                                                 abs=0.05)
