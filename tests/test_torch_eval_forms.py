"""The dense eval's column and matrix forms in the PyTorch port vs the JAX
package, on the CPU.

* ``window_eval_cols_reference`` against ``pallas_window_eval(...,
  use_cols=True)`` and ``window_eval_mxu_reference`` against
  ``use_mxu=True`` (Pallas in interpret mode), on JAX-built dense lists at
  K = 0 and K = 4 near groups: max|da| / max|a| <= 1e-4, the JAX suite's
  Pallas-vs-XLA bar.  Each port is held to its own JAX form: the matrix
  form's ``|t|^2 + |s|^2 - 2 t.s`` cancels in float32 and is not the row
  form's function to 1e-4.  On these lists the centre's rounding (a
  float32 mean in JAX, the correctly rounded mean in the port) keeps the
  port's matrix form 5.8e-5 (K = 0) and 6.0e-5 (K = 4) of max|a| from
  JAX's, as far as the row form is (5.3e-5, 6.2e-5), so they do not tell
  the two apart;
* the matrix form's rounding on groups with exact centres, where it is
  2-3e-2 of max|a| from the row form and the port's plain version lands
  within 5e-4 of JAX's;
* ``window_eval``'s selection of the form (the JAX package's, by R) and
  ``eval_accel(use_cols=True)``, without a kernel launch on the CPU;
* ``tools/eval_ab.py`` end to end at a tiny size.
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
from spatialsim_tpu_torch.ops import bh_window as tbw

N = 2048
EKW = dict(G=0.1, softening=2.0, group_size=64, window_groups=2)
BUILD_KW = dict(theta=0.8, softening=2.0, skin=2.0, max_depth=7,
                group_size=64, window_groups=2, list_cap=512, pool_tile=0)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@functools.lru_cache(maxsize=None)
def jax_case(K):
    """A 2,048-body galaxy, its JAX dense lists with order-2 acc rows (R =
    10) and K near groups, and the sorted padded eval inputs."""
    p, v, m = distributions.generate_distribution("galaxy", N, 200.0, 0.1,
                                                  seed=4)
    pos, vel, mass = (np.ascontiguousarray(a, np.float32)
                      for a in (p.T, v.T, m))
    acc = (np.random.default_rng(8).standard_normal((3, N)) * 0.1
           ).astype(np.float32)
    jl = jbw.build_lists(*(jnp.asarray(a) for a in (pos, vel, mass, acc)),
                         near_groups=K, **BUILD_KW)
    order = np.asarray(jl.order)
    s_pos = np.ascontiguousarray(pos[:, order])
    s_mass = np.where(np.arange(order.size) < N, mass[order], 0.0
                      ).astype(np.float32)
    tl = dense_lists_from_numpy(jl.order, jl.inv_order, jl.far, jl.far_n,
                                jl.far_range, jl.near, jl.ref_pos, 5)
    assert tl.far.shape[1] == 10 and (K == 0) == (tl.near is None)
    return jl, tl, s_pos, s_mass


@pytest.mark.parametrize("K", [0, 4])
@pytest.mark.parametrize("form", ["cols", "mxu"])
def test_plain_form_matches_pallas(form, K):
    jl, tl, s_pos, s_mass = jax_case(K)
    want = np.asarray(pallas_window_eval(
        jnp.asarray(s_pos), jnp.asarray(s_mass), jl.far, jl.far_n,
        jl.near if K else None, 5, 0.02, use_cols=form == "cols",
        use_mxu=form == "mxu", **EKW))
    ref = (tek.window_eval_cols_reference if form == "cols"
           else tek.window_eval_mxu_reference)
    got = ref(torch.from_numpy(s_pos), torch.from_numpy(s_mass), tl.far,
              tl.far_n, tl.near, 5, 0.02, **EKW).numpy()
    assert got.shape == want.shape == (3, s_pos.shape[1])
    assert _rel(got, want) <= 1e-4
    if K:
        assert (tl.near >= 0).any()


def cluster_case(K):
    """Eight groups of 64 unit masses in 8 tight clusters ~1,000 apart, on
    a 1/64 grid (every partial sum of a group's coordinates is exact, so
    both packages centre it alike), K near groups (every other group's
    last one none) and up to 16 far entries of mass 3 (R = 8)."""
    ng, gsz, L = 8, 64, 16
    rng = np.random.default_rng(K)
    centres = rng.integers(-1000, 1000, size=(3, ng, 8, 1))
    offsets = rng.integers(-128, 128, size=(3, ng, 8, 8)) / 64.0
    s_pos = (centres + offsets).reshape(3, -1).astype(np.float32)
    s_mass = np.ones(ng * gsz, np.float32)
    far = np.zeros((ng, 8, L), np.float32)
    far[:, 0:3] = rng.integers(-4000, 4000, size=(ng, 3, L))
    far[:, 6] = 3.0
    far_n = rng.integers(1, L + 1, ng).astype(np.int32)
    near = None
    if K:
        near = np.stack([(np.arange(ng) + 3 + k) % ng for k in range(K)],
                        1).astype(np.int32)
        near[::2, -1] = -1
    return s_pos, s_mass, far, far_n, near


@pytest.mark.parametrize("K", [0, 2])
def test_mxu_form_rounds_as_jax(K):
    """d^2 = |t_c|^2 + |s_c|^2 - 2 t_c.s_c with |t_c| ~ 1,000 loses ~1% on
    the close pairs, so JAX's matrix form is 2.9e-2 (K = 0) and 2.4e-2 (K =
    2) of max|a| from its row form; the port's plain version, rounding the
    squares and the cross term as XLA's FMA chains do, measured 4.9e-4 and
    2.9e-4 from JAX's matrix form.  A port of the row form fails."""
    s_pos, s_mass, far, far_n, near = cluster_case(K)
    kw = dict(G=0.1, softening=2.0, group_size=64, window_groups=1,
              far_tile=16)

    def jax_form(**form):
        return np.asarray(pallas_window_eval(
            *(None if a is None else jnp.asarray(a)
              for a in (s_pos, s_mass, far, far_n, near)), 0, 0.02,
            **form, **kw))
    jax_mxu, jax_row = jax_form(use_mxu=True), jax_form()
    got = tek.window_eval_mxu_reference(
        *(None if a is None else torch.from_numpy(a)
          for a in (s_pos, s_mass, far, far_n, near)), 0, 0.02, **kw).numpy()
    assert _rel(jax_row, jax_mxu) >= 1e-2
    assert _rel(got, jax_mxu) <= 2e-3
    assert _rel(got, jax_mxu) <= 0.1 * _rel(jax_row, jax_mxu)


def test_fma32_rounds_once():
    """``_fma32`` is ``fmaf``: the exact ``a * b + c`` rounded once to
    float32, ties to even, also where ``c`` cancels most of ``a * b``."""
    from fractions import Fraction
    rng = np.random.default_rng(1)
    n = 2000
    a, b = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)
            for _ in range(2))
    a, b = a.astype(np.float32), b.astype(np.float32)
    c = (rng.standard_normal(n) * 2.0 ** rng.integers(-40, 40, n)
         ).astype(np.float32)
    c[:500] = -(a[:500].astype(np.float64) * b[:500])
    got = tek._fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        near = np.float32(float(exact))
        cands = (np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf)))
        want = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(v.view(np.int32)) & 1))
        assert r == want


def test_forms_differ_from_the_row_form_as_in_jax():
    """The column form is the row form's function; the matrix form is its
    own (d^2 cancels), in the port as in the JAX package."""
    _, tl, s_pos, s_mass = jax_case(4)
    args = (torch.from_numpy(s_pos), torch.from_numpy(s_mass), tl.far,
            tl.far_n, tl.near, 5, 0.02)
    row = tek.window_eval_reference(*args, **EKW).numpy()
    cols = tek.window_eval_cols_reference(*args, **EKW).numpy()
    mxu = tek.window_eval_mxu_reference(*args, **EKW).numpy()
    assert _rel(cols, row) <= 1e-5
    assert 1e-7 < _rel(mxu, row) <= 1e-3


@pytest.mark.parametrize("R", [8, 10, 13, 16])
def test_window_eval_selects_the_form_by_rows(R):
    """mxu only for R 8/10, cols only outside R 13/16, else the row form:
    the JAX package's selection, taken on the CPU by the plain versions."""
    rng = np.random.default_rng(R)
    ng, gsz, L = 8, 16, 64
    s_pos = torch.from_numpy((rng.normal(size=(3, ng * gsz)) * 20
                              ).astype(np.float32))
    s_mass = torch.from_numpy(rng.uniform(0.5, 2, ng * gsz)
                              .astype(np.float32))
    far = torch.from_numpy(rng.normal(size=(ng, R, L)).astype(np.float32))
    far[:, 0:3] *= 100.0
    far[:, 6] = far[:, 6].abs()
    far_n = torch.full((ng,), L, dtype=torch.int32)
    kw = dict(G=0.1, softening=2.0, group_size=gsz, window_groups=1,
              far_tile=32)
    args = (s_pos, s_mass, far, far_n, None, 3, 0.02)
    launches = [f.launches for f in (tek.window_eval, tek.window_eval_cols,
                                     tek.window_eval_mxu)]
    row = tek.window_eval_reference(*args, **{k: v for k, v in kw.items()
                                              if k != "far_tile"})
    for use_cols, use_mxu in ((True, False), (False, True), (True, True),
                              (False, False)):
        want = ("mxu" if use_mxu and R in (8, 10) else
                "cols" if use_cols and R not in (13, 16) else "row")
        got = tek.window_eval(*args, use_cols=use_cols, use_mxu=use_mxu,
                              **kw)
        ref = {"row": row,
               "cols": tek.window_eval_cols_reference(*args, **kw),
               "mxu": tek.window_eval_mxu_reference(*args, **kw)}[want]
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert launches == [f.launches for f in (
        tek.window_eval, tek.window_eval_cols, tek.window_eval_mxu)]


def test_eval_accel_use_cols_takes_the_column_form():
    jl, tl, s_pos, s_mass = jax_case(4)
    p, _, m = distributions.generate_distribution("galaxy", N, 200.0, 0.1,
                                                  seed=4)
    pos = torch.from_numpy(np.ascontiguousarray(p.T, np.float32))
    mass = torch.from_numpy(m.astype(np.float32))
    got = tbw.eval_accel(tl, pos, mass, 0.02, use_cols=True, **EKW)
    want = tek.window_eval_cols_reference(
        torch.from_numpy(s_pos), torch.from_numpy(s_mass), tl.far, tl.far_n,
        tl.near, 5, 0.02, **EKW)[:, :N][:, tl.inv_order.long()]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cols_form_needs_runs_of_8():
    s_pos = torch.zeros((3, 48))
    with pytest.raises(ValueError, match="multiples of 8"):
        tek.window_eval_cols_reference(
            s_pos, torch.ones(48), torch.zeros((4, 8, 20)),
            torch.zeros(4, dtype=torch.int32), G=1.0, softening=1.0,
            group_size=12)


def test_eval_ab_tool_runs_on_the_cpu(capsys):
    from spatialsim_tpu_torch.tools import eval_ab
    rc = eval_ab.main(["--device", "cpu", "--bodies", "3000", "--reps", "1",
                       "--near-groups", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    for K in (0, 3):
        for form in ("row", "cols", "mxu"):
            assert f"K={K} {form}" in out
    assert "far_n mean" in out


def test_eval_ab_counts_the_live_far_entries_for_every_form():
    """The A/B's pairs and bytes are what the function needs: the window
    and near blocks and the live far entries, the same for the three forms
    (the column and matrix kernels read whole tiles, zero past far_n)."""
    from types import SimpleNamespace

    from spatialsim_tpu_torch.tools import eval_ab
    _, tl, _, _ = jax_case(4)
    cfg = SimpleNamespace(group_size=64, window_groups=2, eval_far_tile=512)
    ng, R, L = tl.far.shape
    g = np.arange(ng)
    blocks = (np.minimum(g + 2, ng - 1) - np.maximum(g - 2, 0) + 1).sum()
    near = tl.near.numpy()
    blocks += ((near >= 0) & (near < ng)).sum()
    live = int(np.clip(tl.far_n.numpy(), 0, L).sum())
    pairs = int(blocks) * 64 * 64 + live * 64
    nbytes = 4 * (ng * 64 * 7 + R * live + ng + near.size)
    for form in ("row", "cols", "mxu"):
        assert eval_ab.form_work(form, tl, cfg) == (
            pairs, eval_ab.OPS_PER_PAIR[form] * pairs, nbytes)
