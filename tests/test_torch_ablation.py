"""The row form's stage ablation (``dbg``) in the PyTorch port vs the JAX
package, on the CPU.

``window_eval_reference(..., dbg=...)`` against ``pallas_window_eval(...,
dbg=...)`` (Pallas in interpret mode) on JAX-built dense lists, for every
combination ``scripts/decide7.py`` runs (its rows ``base`` .. ``base_uttr``:
the far list zeroed or kept, the window, the staging, the targets and the
output's layout switched off), at R = 10 (monopole with the mean
accelerations) with K = 0 and K = 4 near groups (so ``nowin`` is seen to
keep the near groups) and R = 16 (quadrupole) with K = 4, and at group
size 1,024 where ``nouttr`` sums blocks of 256 targets.

Tolerance: max|da| / max|a| <= 1e-4, the bar at which
``tests/test_torch_eval_forms.py`` holds the row form to Pallas; for
``nouttr`` the output is each block's sum, so this is 1e-4 of the largest
block sum.  ``nostage`` without ``nowin`` raises: JAX sums an unwritten
scratch there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu import distributions
from spatialsim_tpu.ops import bh_window as jbw
from spatialsim_tpu.ops.bh_eval_kernel import pallas_window_eval
from spatialsim_tpu_torch.convert import dense_lists_from_numpy
from spatialsim_tpu_torch.ops import bh_eval_kernel as tek
from spatialsim_tpu_torch.tools import decide7

N = 2048
TOL = 1e-4
STEPS_SINCE = 5
# decide7's rows: (tag, far_n kept, dbg).
ROWS = [(tag, keep, dbg) for tag, keep, dbg in decide7.ROWS]


def _rel(got, want):
    """max|da| / max|a|; 0 where both are all zero (``now`` with no near
    groups sums nothing), inf where only the reference is."""
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    return err / scale if scale else (0.0 if err == 0 else np.inf)


@functools.lru_cache(maxsize=None)
def jax_case(R, K, gsz=64):
    """A 2,048-body galaxy, its JAX dense lists (R = 10: mean accelerations;
    R = 16: quadrupole too) with K near groups, and the sorted padded eval
    inputs."""
    p, v, m = distributions.generate_distribution("galaxy", N, 200.0, 0.1,
                                                  seed=4)
    pos, vel, mass = (np.ascontiguousarray(a, np.float32)
                      for a in (p.T, v.T, m))
    acc = (np.random.default_rng(8).standard_normal((3, N)) * 0.1
           ).astype(np.float32)
    jl = jbw.build_lists(*(jnp.asarray(a) for a in (pos, vel, mass, acc)),
                         theta=0.8, softening=2.0, skin=2.0, max_depth=7,
                         group_size=gsz, window_groups=2, list_cap=512,
                         pool_tile=0, near_groups=K,
                         quadrupole=R == 16)
    order = np.asarray(jl.order)
    s_pos = np.ascontiguousarray(pos[:, order])
    s_mass = np.where(np.arange(order.size) < N, mass[order], 0.0
                      ).astype(np.float32)
    tl = dense_lists_from_numpy(jl.order, jl.inv_order, jl.far, jl.far_n,
                                jl.far_range, jl.near, jl.ref_pos,
                                STEPS_SINCE)
    assert tl.far.shape[1] == R and (K == 0) == (tl.near is None)
    return jl, tl, s_pos, s_mass


def both(R, K, keep, dbg, gsz=64):
    """(port, JAX) accelerations of one ablation row."""
    jl, tl, s_pos, s_mass = jax_case(R, K, gsz)
    kw = dict(G=0.1, softening=2.0, group_size=gsz, window_groups=2)
    jfar_n = jl.far_n if keep else jnp.zeros_like(jl.far_n)
    want = np.asarray(pallas_window_eval(
        jnp.asarray(s_pos), jnp.asarray(s_mass), jl.far, jfar_n,
        jl.near if K else None, STEPS_SINCE, 0.02, dbg=dbg, **kw))
    far_n = tl.far_n if keep else torch.zeros_like(tl.far_n)
    got = tek.window_eval_reference(
        torch.from_numpy(s_pos), torch.from_numpy(s_mass), tl.far, far_n,
        tl.near, STEPS_SINCE, 0.02, dbg=dbg, **kw).numpy()
    assert got.shape == want.shape == (3, s_pos.shape[1])
    return got, want


@pytest.mark.parametrize("R,K", [(10, 0), (10, 4), (16, 4)],
                         ids=["R10-K0", "R10-K4", "R16-K4"])
@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_ablation_matches_pallas(row, R, K):
    tag, keep, dbg = row
    got, want = both(R, K, keep, dbg)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= TOL, (tag, _rel(got, want))
    if "nouttr" in dbg:
        # One value a group (the block is the group at 64), in all rows.
        blocks = got.reshape(3, -1, 64)
        assert (blocks == blocks[:1, :, :1]).all()


def test_nowin_keeps_the_near_groups():
    """With K = 4, ``nowin`` on a zeroed far list still sums the near
    groups; without them it sums nothing."""
    with_near, _ = both(10, 4, False, "nowin")
    without, _ = both(10, 0, False, "nowin")
    assert np.abs(with_near).max() > 0
    assert np.abs(without).max() == 0


@pytest.mark.parametrize("dbg", ["nouttr", "notgt,nouttr"])
def test_nouttr_blocks_of_256_at_group_1024(dbg):
    """At group size 1,024 the TPU kernel's default block is 256 targets:
    four sums a group, each held to JAX."""
    got, want = both(10, 0, True, dbg, gsz=1024)
    assert _rel(got, want) <= TOL
    blocks = got.reshape(3, -1, 256)
    assert (blocks == blocks[:1, :, :1]).all()
    if "notgt" not in dbg:
        assert len(np.unique(blocks[0, :, 0])) > 1


def test_notgt_gives_one_target_a_group():
    got, _ = both(10, 0, True, "notgt")
    g = got.reshape(3, -1, 64)
    assert (g == g[:, :, :1]).all()


@pytest.mark.parametrize("dbg", ["nostage", "nostage,notgt", "nouttr,bogus"])
def test_bad_flags_raise(dbg):
    _, tl, s_pos, s_mass = jax_case(10, 0)
    with pytest.raises(ValueError, match="nowin" if "nostage" in dbg
                       else "unknown"):
        tek.window_eval_reference(
            torch.from_numpy(s_pos), torch.from_numpy(s_mass), tl.far,
            tl.far_n, None, 0, 0.02, G=0.1, softening=2.0, group_size=64,
            window_groups=2, dbg=dbg)


def test_forms_ignore_dbg_and_the_cpu_takes_the_plain_version():
    """``window_eval`` passes ``dbg`` to the row form's plain version on
    the CPU; the column and matrix forms ignore it, as in JAX."""
    _, tl, s_pos, s_mass = jax_case(10, 0)
    args = (torch.from_numpy(s_pos), torch.from_numpy(s_mass), tl.far,
            tl.far_n, None, STEPS_SINCE, 0.02)
    kw = dict(G=0.1, softening=2.0, group_size=64, window_groups=2)
    before = tek.window_eval.dbg_launches
    got = tek.window_eval(*args, dbg="nowin,notgt", **kw)
    assert torch.equal(got, tek.window_eval_reference(
        *args, dbg="nowin,notgt", **kw))
    assert tek.window_eval.dbg_launches == before
    for form in ("use_cols", "use_mxu"):
        assert torch.equal(tek.window_eval(*args, dbg="nouttr",
                                           **{form: True}, **kw),
                           tek.window_eval(*args, **{form: True}, **kw))


def test_sass_label_of_the_ablation_instance():
    from spatialsim_tpu_torch.tools import eval_tiles
    name = "_ZN12_GLOBAL__N_118window_eval_kernelILi10ELi2ELb1EEEvPKf"
    assert eval_tiles.instance(name) == "dense R=10 T=2 dbg"
    assert eval_tiles.instance(name.replace("Lb1E", "Lb0E")) == \
        "dense R=10 T=2"


@pytest.mark.parametrize("flag", ["nowin", "notgt", "nouttr"])
def test_flag_bits_match_the_kernel(flag):
    """``DBG_BITS`` (the wrapper's flags word) equals the kernel's
    constants in ``csrc/window_eval.cu`` (a text parse, no build);
    ``nostage`` adds no bit: the kernel has no stage of its own for it."""
    import re
    from pathlib import Path
    src = (Path(tek.__file__).parents[1] / "csrc" / "window_eval.cu")
    consts = dict(re.findall(r"constexpr int (kNo\w+) = (\d+);",
                             src.read_text()))
    name = {"nowin": "kNoWin", "notgt": "kNoTgt", "nouttr": "kNoUttr"}
    assert tek.DBG_BITS[flag] == int(consts[name[flag]])
    assert tek.DBG_BITS["nostage"] == 0


def test_decide7_lines_name_the_nostage_rows():
    assert decide7.note("nost", "nowin,nostage") == \
        "  (the same program as now on the card)"
    assert "no effect" in decide7.note("notg", "nowin,nostage,notgt")
    assert decide7.note("now", "nowin") == ""
