"""The rebuild's float segment sums add in one fixed order.

The octree's moment sums (``ops/octree._segment``) and the traversal's
residual fold (``ops/bh_window._fold_residual``) are segment sums over
sorted ids (``torch.segment_reduce``), where they were ``index_add_``
calls, whose float atomics add on a card in the order they happen to run.
On the CPU ``index_add_`` adds in index order, and so does each segment
here: the results must be equal bit for bit, so every JAX parity test
keeps its bar.  Here each is held to an ``index_add_`` version of itself,
alone and inside whole builds (the build patched back to ``index_add_``).
"""

import numpy as np
import pytest
import torch

from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.ops import octree
from spatialsim_tpu_torch.parallel import dryrun


def _segment_index_add(data, seg, num):
    out = torch.zeros(data.shape[:-1] + (num + 1,), dtype=data.dtype)
    out.index_add_(data.dim() - 1, seg, data)
    return out[..., :num]


def _fold_index_add(res, groups, rows):
    """The fold as it was: each of the k residual rows (one spare slot)
    an ``index_add_`` of its row of ``rows``."""
    out = []
    for rc, c in zip(res, rows):
        rc = torch.cat([rc, rc.new_zeros(1)])
        rc.index_add_(0, groups, c)
        out.append(rc[:-1])
    return torch.stack(out)


def _ids(rng, n, num, drops, empty):
    """Non-decreasing ids in [0, num): ``empty`` ids never used, ``drops``
    ids of ``num`` at the tail."""
    keep = np.setdiff1d(np.arange(num), empty)
    seg = np.sort(rng.choice(keep, n - drops))
    return torch.tensor(np.concatenate([seg, np.full(drops, num)]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64])
@pytest.mark.parametrize("shape", [(), (3,), (6,)])
@pytest.mark.parametrize("drops", [0, 37])
def test_segment_equals_index_add(dtype, shape, drops):
    rng = np.random.default_rng(len(shape) + drops)
    n, num = 5000, 700
    seg = _ids(rng, n, num, drops, empty=[0, 5, 6, 699])
    x = rng.normal(size=shape + (n,)) * 10.0 ** rng.integers(-3, 4, n)
    data = torch.tensor(x).to(dtype)
    got = octree._segment(data, seg, num)
    want = _segment_index_add(data, seg, num)
    assert got.shape == shape + (num,) and got.dtype == dtype
    assert torch.equal(got, want)
    assert not bool(got[..., [0, 5, 6, 699]].any())


def test_segment_merged_tail_equals_index_add():
    """The capped level: ids clamped to ``cap - 1`` merge the tail cells
    into the last slot (still non-decreasing)."""
    rng = np.random.default_rng(1)
    codes = torch.tensor(np.sort(rng.integers(0, 3000, 4000)))
    seg, _ = octree._ranks(codes)
    cap = 500
    seg = seg.clamp(max=cap - 1)
    data = torch.tensor(rng.normal(size=(3, 4000)).astype(np.float32))
    got = octree._segment(data, seg, cap)
    assert torch.equal(got, _segment_index_add(data, seg, cap))
    assert float(got[:, cap - 1].abs().sum()) > 0


def test_fold_equals_index_add():
    rng = np.random.default_rng(2)
    ng, K = 64, 3000
    res = torch.tensor(rng.normal(size=(10, ng)) * 1e3)
    groups = _ids(rng, K, ng, 0, empty=[3, 40])
    rows = torch.tensor(rng.normal(size=(10, K)).astype(np.float32)).double()
    got = bw._fold_residual(res, groups, rows)
    assert torch.equal(got, _fold_index_add(res, groups, rows))


def _build(**kw):
    pos, vel, mass = dryrun.galaxy(6000, 1)
    acc = torch.tensor(np.random.default_rng(0).normal(size=(3, 6000)),
                       dtype=torch.float32)
    return bw.build_lists(pos, vel, mass, acc, theta=0.8, softening=2.0,
                          skin=2.0, max_depth=7, group_size=64,
                          window_groups=2, **kw)


@pytest.mark.parametrize("kw", [dict(pool_tile=32, list_cap=64),
                                dict(pool_tile=0, list_cap=48,
                                     quadrupole=True)],
                         ids=["pooled", "dense-quadrupole"])
def test_builds_equal_index_add_builds(monkeypatch, kw):
    """Whole builds with small list caps that fold, against the same
    builds with both sums patched back to ``index_add_``: every field
    equal bit for bit."""
    folds = []
    fold = bw._fold_residual

    def counted(res, groups, rows):
        folds.append(groups.numel())
        return fold(res, groups, rows)
    monkeypatch.setattr(bw, "_fold_residual", counted)
    got = _build(**kw)
    assert sum(folds) > 1000
    monkeypatch.setattr(bw, "_fold_residual", _fold_index_add)
    monkeypatch.setattr(octree, "_segment", _segment_index_add)
    want = _build(**kw)
    for f, t in got._asdict().items():
        if isinstance(t, torch.Tensor):
            assert torch.equal(t, getattr(want, f)), f
