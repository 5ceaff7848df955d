"""Compact emission on the PyTorch port against the JAX package, on the CPU.

The scatter-free helpers (``_tile_compact``, a stable sort, and
``_tile_assemble``) must equal the JAX functions bit for bit (against
JAX's one-hot contraction, the compacted prefixes);
the traversal's ``CompactEmits`` must equal JAX's; ``build_lists`` with
``emit_mode`` "compact" / "compact-mm" must equal the port's own "ranges"
pool bit for bit (the same entries summed in the same order) and JAX's
compact lists within the bound ``tests/test_torch_bh_window.py`` uses
(integer rows exact, moments rtol 2e-5 / atol 2e-3).  The sizes are the
JAX suite's (``tests/test_bh_window.py``: the 12K cluster).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu import distributions
from spatialsim_tpu.ops import bh_window as jbw
from spatialsim_tpu_torch.convert import compact_emits_from_numpy
from spatialsim_tpu_torch.ops import bh_window as tbw

N = 12_000
# tests/test_bh_window.py::test_compact_emission_pool_bitexact: order-2
# acc rows, list_cap overflow -> residual folds, window-straddle slivers.
KW_FOLDS = dict(theta=0.6, softening=2.0, skin=2.0, max_depth=7,
                group_size=128, window_groups=2, list_cap=256, pool_tile=128,
                with_ranges=True)
# ...::test_compact_emission_unfit_group_fold_matches: the pool-capacity
# guard folds whole groups.
KW_UNFIT = dict(theta=0.7, softening=2.0, skin=2.0, max_depth=7,
                group_size=128, window_groups=2, list_cap=512, pool_tile=64,
                with_ranges=True)
UNFIT_CAP = 40 + -(-N // 128) + 1


def _cluster(seed, acc=False):
    p, v, m = distributions.generate_distribution("cluster", N, 200.0, 0.1,
                                                  seed=seed)
    out = [np.ascontiguousarray(p.T, np.float32),
           np.ascontiguousarray(v.T, np.float32), m.astype(np.float32)]
    if acc:
        out.append((np.random.default_rng(1234).standard_normal((3, N))
                    * 0.1).astype(np.float32))
    return out


def _assert_jax_close(jl, tl):
    for f in ("order", "inv_order", "far_n", "pstart"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), err_msg=f)
    jp, tp = np.asarray(jl.pool), tl.pool.numpy()
    assert jp.shape == tp.shape
    np.testing.assert_array_equal(tp[:, 10:14], jp[:, 10:14])
    np.testing.assert_allclose(tp, jp, rtol=2e-5, atol=2e-3)


def _assert_pools_equal(a, b):
    for f in ("order", "inv_order", "far_n", "pstart", "pool"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _mask_cases():
    """(mask, payloads) cases: random masks with a partly masked last
    tile (the traversal's padding), one all-masked and one empty tile."""
    rng = np.random.default_rng(3)
    W = 32 * 11
    mask = rng.random(W) < 0.35
    mask[-20:] = False                    # the last tile is ragged
    mask[64:96] = True                    # a tile of 32 entries
    mask[96:128] = False                  # a tile of none
    s = rng.integers(0, 1 << 20, W)
    return mask, (s, s + rng.integers(1, 4096, W))


def _front(counts, W, tile=32):
    """(W,) bool: the slots that hold a tile's compacted prefix."""
    lane = torch.arange(W) % tile
    return lane < torch.as_tensor(np.asarray(counts)).repeat_interleave(tile)


@pytest.mark.parametrize("method", ["sort", "matmul"])
def test_tile_compact_matches_jax(method):
    """The port's sort equals JAX's sort bit for bit, and its compacted
    prefixes equal JAX's one-hot contraction's (whose unfilled slots are
    0 where the sort's keep the unmasked payloads)."""
    mask, pays = _mask_cases()
    want, wcnt = jbw._tile_compact(jnp.asarray(mask),
                                   tuple(jnp.asarray(p, jnp.int32)
                                         for p in pays), method=method)
    got, gcnt = tbw._tile_compact(torch.from_numpy(mask),
                                  tuple(torch.from_numpy(p) for p in pays))
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(wcnt))
    if method == "sort":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    front = _front(gcnt, mask.size).numpy()
    np.testing.assert_array_equal(got.numpy()[:, front],
                                  np.asarray(want)[:, front])


@pytest.mark.parametrize("method", ["sort", "matmul"])
@pytest.mark.parametrize("cap", [32 * 11, 64])
def test_tile_assemble_matches_jax(method, cap):
    """The dense rows and total against JAX's compaction by ``method`` and
    its assembly; ``cap`` 64 lies below the total, whose tail is
    dropped."""
    mask, pays = _mask_cases()
    comp, cnt = jbw._tile_compact(jnp.asarray(mask),
                                  tuple(jnp.asarray(p, jnp.int32)
                                        for p in pays), method=method)
    want, wtot = jbw._tile_assemble(cnt, comp, cap)
    tcomp, tcnt = tbw._tile_compact(torch.from_numpy(mask),
                                    tuple(torch.from_numpy(p) for p in pays))
    got, gtot = tbw._tile_assemble(tcnt, tcomp, cap)
    assert int(gtot) == int(wtot) == min(int(mask.sum()), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The entries in their global order, then zeros.
    keep = np.flatnonzero(mask)[:cap]
    np.testing.assert_array_equal(got.numpy()[:, :keep.size],
                                  np.stack(pays)[:, keep])
    assert not got.numpy()[:, keep.size:].any()


def test_tile_assemble_of_no_entries_matches_jax():
    """An empty mask: no runs, total 0, rows all zero, as in JAX."""
    W = 32 * 4
    mask = np.zeros(W, bool)
    pays = (np.arange(W), np.arange(W) + 7)
    comp, cnt = jbw._tile_compact(jnp.asarray(mask),
                                  tuple(jnp.asarray(p, jnp.int32)
                                        for p in pays))
    want, wtot = jbw._tile_assemble(cnt, comp, W)
    tcomp, tcnt = tbw._tile_compact(torch.from_numpy(mask),
                                    tuple(torch.from_numpy(p) for p in pays))
    got, gtot = tbw._tile_assemble(tcnt, tcomp, W)
    assert int(gtot) == int(wtot) == 0
    assert not tcnt.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.numpy().any()


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_mm_equals_jax_one_hot_up_to_2_24(seed):
    """"compact-mm" on the port (the sort) equals the JAX package's one-hot
    contraction for payloads up to 2^24 - 1: every tile's compacted
    prefix, and the assembled rows bit for bit."""
    rng = np.random.default_rng(seed)
    W = 32 * 64
    mask = rng.random(W) < 0.5
    top = (1 << 24) - 1
    p = rng.integers(0, top + 1, (2, W))
    p[0, :8] = top
    mask[:8] = True
    mm, cnt = jbw._tile_compact(jnp.asarray(mask),
                                tuple(jnp.asarray(x, jnp.int32) for x in p),
                                method="matmul")
    srt, tcnt = tbw._tile_compact(torch.from_numpy(mask),
                                  tuple(torch.from_numpy(x) for x in p))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(cnt))
    front = _front(tcnt, W).numpy()
    np.testing.assert_array_equal(srt.numpy()[:, front],
                                  np.asarray(mm)[:, front])
    assert int(srt.max()) == top
    np.testing.assert_array_equal(
        tbw._tile_assemble(tcnt, srt, W)[0].numpy(),
        np.asarray(jbw._tile_assemble(cnt, mm, W)[0]))


@pytest.mark.parametrize("wl_caps", [(700, 1500, 31), (32, 64, 4096, 1)])
def test_emit_offsets_match_jax(wl_caps):
    """The level offsets into ``CompactEmits.ent``: caps rounded up to
    whole compaction tiles, as in JAX."""
    assert tbw._emit_offsets(wl_caps) == tuple(
        int(x) for x in jbw._emit_offsets(wl_caps))
    assert tbw._COMPACT_TILE == jbw._COMPACT_TILE


def _captured_emits(module, mp, call):
    """Run ``call()`` with ``module._finish_pool_compact`` recording its
    arguments and result (patched through the MonkeyPatch ``mp``)."""
    seen = {}
    orig = module._finish_pool_compact

    def spy(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        seen["out"] = orig(*args, **kw)
        return seen["out"]
    mp.setattr(module, "_finish_pool_compact", spy)
    call()
    return seen


@pytest.fixture(scope="module")
def jax_compact():
    """One jitted JAX compact build of the 12K cluster that also returns
    the CompactEmits its finish was given: (inputs, the finish's static
    keywords, emits, lists).  JAX's "compact-mm" emissions equal these
    (tests/test_bh_window.py), so both modes' cases share them."""
    arrays = _cluster(5, acc=True)
    with pytest.MonkeyPatch.context() as mp:
        holder = {}

        def build(*a):
            seen = _captured_emits(
                jbw, mp, lambda: jbw.build_lists.__wrapped__(
                    *a, emit_mode="compact", **KW_FOLDS))
            holder["kw"] = seen["kw"]
            return seen["args"][0], seen["out"]
        emits, lists = jax.jit(build)(*(jnp.asarray(x) for x in arrays))
    return arrays, holder["kw"], emits, lists


@pytest.mark.parametrize("mode", ["compact", "compact-mm"])
def test_traversal_emits_match_jax(monkeypatch, jax_compact, mode):
    """The traversal's CompactEmits (ent, cnt) equal JAX's; then JAX's own
    emissions, carried over, finish into JAX's pool."""
    arrays, jkw, je, want = jax_compact
    tseen = _captured_emits(tbw, monkeypatch, lambda: tbw.build_lists(
        *(torch.from_numpy(a) for a in arrays), emit_mode=mode,
        **KW_FOLDS))
    te = tseen["args"][0]
    assert isinstance(te, tbw.CompactEmits)
    np.testing.assert_array_equal(te.cnt.numpy(), np.asarray(je.cnt))
    np.testing.assert_array_equal(te.ent.numpy(), np.asarray(je.ent))
    assert jkw["emit_offsets"] == tseen["kw"]["emit_offsets"]
    assert int(te.cnt.sum()) > 0

    # JAX's emissions through the port's finish, every other argument the
    # port's own (equal to JAX's up to the residual's float64 sums).
    emits = compact_emits_from_numpy(np.asarray(je.ent), np.asarray(je.cnt))
    targs = list(tseen["args"])
    targs[0] = emits
    got = tbw._finish_pool_compact(*targs, **tseen["kw"])
    _assert_jax_close(want, got)


@pytest.mark.parametrize("mode", ["compact", "compact-mm"])
def test_build_lists_compact_equals_ranges_and_jax(mode):
    arrays = _cluster(5, acc=True)
    tt = [torch.from_numpy(a) for a in arrays]
    ref = tbw.build_lists(*tt, emit_mode="ranges", **KW_FOLDS)
    got = tbw.build_lists(*tt, emit_mode=mode, **KW_FOLDS)
    assert int(ref.far_n.max()) >= KW_FOLDS["list_cap"] - 1, \
        "config should force at least one overflow fold"
    _assert_pools_equal(ref, got)
    jl = jbw.build_lists(*(jnp.asarray(a) for a in arrays), emit_mode=mode,
                         **KW_FOLDS)
    _assert_jax_close(jl, got)


@pytest.mark.parametrize("mode", ["compact", "compact-mm"])
def test_compact_unfit_group_folds(mode):
    """The capacity guard's whole-group folds: the port's compact and
    ranges pools equal bit for bit, JAX's within rtol 2e-5 / atol 2e-3."""
    arrays = _cluster(7)
    tt = [torch.from_numpy(a) for a in arrays]
    ref = tbw.build_lists(*tt, emit_mode="ranges", pool_cap=UNFIT_CAP,
                          **KW_UNFIT)
    got = tbw.build_lists(*tt, emit_mode=mode, pool_cap=UNFIT_CAP,
                          **KW_UNFIT)
    assert (ref.far_n.numpy() == 1).any(), "cap should force group folds"
    _assert_pools_equal(ref, got)
    jl = jbw.build_lists(*(jnp.asarray(a) for a in arrays), emit_mode=mode,
                         pool_cap=UNFIT_CAP, **KW_UNFIT)
    _assert_jax_close(jl, got)


def test_compact_without_pool_emits_values():
    """With the pool off "compact" falls to values emission (dense lists),
    as in the JAX package; ``window_bh_accel`` and ``build_diagnostics``
    take compact mode through the config."""
    from spatialsim_tpu_torch.config.nbody import NBodyConfig
    arrays = [torch.from_numpy(a) for a in _cluster(5)]
    kw = dict(KW_FOLDS, pool_tile=0)
    dense = tbw.build_lists(*arrays, emit_mode="compact", **kw)
    values = tbw.build_lists(*arrays, emit_mode="values", **kw)
    assert dense.pool is None and dense.far is not None
    assert torch.equal(dense.far, values.far)
    cfg = NBodyConfig(num_bodies=N, theta=0.6, group_size=128, max_depth=7,
                      list_capacity=256, pool_tile=128, window_groups=2,
                      traversal_emit="compact")
    a_c = tbw.window_bh_accel(*arrays, cfg)
    a_r = tbw.window_bh_accel(*arrays, cfg.replace(traversal_emit="ranges"))
    assert torch.equal(a_c, a_r)
    assert tbw.build_diagnostics(*arrays, cfg)["ng"] == -(-N // 128)
