"""The PyTorch port's pooled ranges and values finishes and its one-shot
and diagnostic entry points vs the JAX package, on the CPU.

* ranges emission into ``_finish_pool_ranges``, values emission into the
  dense finish and ``build_pool``, with and without the capacity fold:
  order, far_n and pstart exact, the packed integer range rows bit for
  bit, moment rows to ``test_torch_bh_window``'s bound;
* ``window_bh_accel`` (dense lists with near groups) to 1e-4 of max|a| of
  the JAX package's XLA eval, and ``build_diagnostics`` equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu.config.nbody import NBodyConfig
from spatialsim_tpu.ops import bh_window as jbw
from spatialsim_tpu_torch.ops import bh_window as tbw

from test_torch_bh_window import _assert_lists_match
from test_torch_near_refresh import REFRESH_KW, _acc, _galaxy, _rel


@pytest.mark.parametrize("case", [
    ("ranges", "ranges", False), ("values", "values", False),
    ("ranges-fold", "ranges", True), ("values-fold", "values", True),
], ids=lambda c: c[0])
def test_pooled_finishes_match_jax(case):
    """Ranges emission into ``_finish_pool_ranges``, values emission into
    the dense finish and ``build_pool``; "fold": a pool cap too small for
    the lists folds whole groups into their residuals."""
    _, mode, fold = case
    pos, vel, mass = _galaxy(4000, 5)
    arrays = (pos, vel, mass, _acc(4000))
    kw = dict(REFRESH_KW, pool_tile=64, emit_mode=mode, with_ranges=True)
    if fold:
        kw["pool_cap"] = 60 + 63 + 1
    jl = jbw.build_lists(*(jnp.asarray(a) for a in arrays), **kw)
    tl = tbw.build_lists(*(torch.from_numpy(a) for a in arrays), **kw)
    assert int(tl.far_n.max()) >= kw["list_cap"] - 1
    assert ((tl.far_n.numpy() == 1).any() if fold
            else (tl.far_n.numpy() > 1).all())
    _assert_lists_match(jl, tl)


def test_window_bh_accel_and_build_diagnostics_match_jax():
    pos, vel, mass = _galaxy(2048, 7)
    cfg = NBodyConfig(theta=0.8, G=0.1, softening=2.0, max_depth=7,
                      group_size=64, list_capacity=256, window_groups=2,
                      skin=2.0, near_groups=3, engine="window")
    jarr = tuple(jnp.asarray(a) for a in (pos, vel, mass))
    tarr = tuple(torch.from_numpy(a) for a in (pos, vel, mass))
    # The JAX package's XLA eval (its Pallas kernel's oracle) keeps the
    # interpret-mode Pallas eval out of this test's time.
    want = np.asarray(jbw.window_bh_accel(*jarr, cfg, use_pallas=False))
    got = tbw.window_bh_accel(*tarr, cfg).numpy()
    assert _rel(got, want) <= 1e-4
    dj = jbw.build_diagnostics(*jarr, cfg)
    dt = tbw.build_diagnostics(*tarr, cfg)
    assert dt.keys() == dj.keys()
    for k in dj:
        if k == "residual_mass_frac":
            assert dt[k] == pytest.approx(dj[k], rel=1e-5, abs=1e-7)
        else:
            assert dt[k] == dj[k], k
    assert dt["groups_at_cap"] > 0 and dt["residual_mass_frac"] > 0
