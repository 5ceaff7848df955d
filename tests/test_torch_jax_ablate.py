"""The rebuild's phase ablations on the PyTorch port against the JAX
package, on the CPU.

``_traverse_global(..., ablate=...)`` replaces traversal phases with the
JAX package's stand-ins ("gather_cell", "gather_group", "emit", "sliver",
"expand") and ``build_lists(..., ablate=("finish",))`` the pooled finish;
each ablated call must give the JAX call's outputs on the same inputs:
integers exactly (``wl``, the stacked worklist fills and demands,
included), floats within 1e-5 of their largest magnitude, equal shapes.
The modes are the traversal's four: ranges and cell-id emission, values
emission with the quadrupole (the dense build), and compact emission.
With ``ablate=()`` the outputs must equal, bit for bit, a digest taken
on the tree before the ablations were ported.

The JAX functions run eagerly (the un-jitted ``build_lists``): at 2,048
bodies one traversal's ops compile once and every later call of the same
shapes reuses them, where a jitted call would compile each ablation set
anew.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialsim_tpu.ops import bh_window as jbw
from spatialsim_tpu.ops.bounds import compute_bounds as jax_bounds
from spatialsim_tpu.ops.morton import morton_encode as jax_morton
from spatialsim_tpu.ops.octree import build_octree as jax_octree
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.ops.octree import build_octree
from spatialsim_tpu_torch.tools.oracle import initial_conditions

N = 2048
TOL = 1e-5
# One worklist cap for every level (4 levels at depth 5): JAX's eager ops
# then compile once for all levels; the deep levels overflow and fold.
BASE = dict(theta=0.8, softening=2.0, skin=2.0, max_depth=5, group_size=64,
            window_groups=2, list_cap=256, wl_caps=(4096,) * 4)
MODES = {
    "ranges": dict(pool_tile=128, emit_mode="ranges"),
    "cellid": dict(pool_tile=128, emit_mode="cellid"),
    "values": dict(pool_tile=0, quadrupole=True),
    "compact": dict(pool_tile=128, emit_mode="compact"),
}
# sha256 of every output of the calls in _default_digest, taken on the
# tree before the ablations were ported.
DEFAULT_DIGEST = \
    "fe92a4975d0ac98cb9602f5494e18712c4e0fbc40fc768b5153000ab890ece0d"
EVERY = bw.TRAVERSAL_PHASES
# (mode, ablate): every phase in ranges mode, alone, as the demand probe
# and all at once; then the stand-ins of the other modes' own code: values
# mode's broadcast of the moment table, compact emission without entries.
TRAVERSE_CASES = (
    [("ranges", (p,)) for p in EVERY]
    + [("ranges", ("emit", "sliver")), ("ranges", EVERY),
       ("values", ("gather_cell",)), ("compact", ("emit",))])
# (mode, ablate) of whole builds: the pooled cell-id build (the default
# path) with each phase and the demand probe, and the ranges finish's
# stand-in.
BUILD_CASES = (
    [("cellid", (p,)) for p in bw.BUILD_PHASES]
    + [("cellid", ("emit", "sliver")), ("ranges", ("finish",))])


def _inputs():
    pos, vel, mass = initial_conditions("galaxy", N, 500.0, 0.1,
                                        torch.device("cpu"))
    acc = torch.as_tensor(np.random.default_rng(5).normal(
        size=(3, N)).astype(np.float32)) * 1e-3
    return pos, vel, mass, acc


def _level_offsets(tree, mode):
    if mode != "cellid":
        return None
    offs, tot = [], 0
    for lv in tree.levels:
        offs.append(tot)
        tot += lv.code.shape[0]
    return tuple(offs + [tot])


def _port_args(pos, vel, mass, acc, mode):
    """``_traverse_global``'s arguments as ``build_lists`` makes them."""
    kw = dict(BASE, **MODES[mode])
    quad = kw.get("quadrupole", False)
    gsz, depth = kw["group_size"], kw["max_depth"]
    half, _, _, s_codes, s_pos, s_vel, s_mass, s_acc = bw._sort_state(
        pos, vel, mass, acc, depth, gsz)
    npad = s_pos.shape[1]
    ng = npad // gsz
    tree = build_octree(s_codes, s_pos, s_mass, half, max_depth=depth,
                        start_level=2, n=npad, sorted_vel=s_vel,
                        sorted_acc=s_acc, with_quadrupole=quad,
                        level_caps=())
    gpos = s_pos.reshape(3, ng, gsz)
    tkw = dict(
        theta=kw["theta"], soft_sq=kw["softening"] ** 2, skin=kw["skin"],
        gsz=gsz, intervals=bw._covered_intervals(
            torch.zeros((ng, 0), dtype=torch.int32), kw["window_groups"],
            gsz),
        list_cap=kw["list_cap"], n_levels=len(tree.levels),
        wl_caps=kw["wl_caps"],
        with_acc=True, quadrupole=quad, emit_values=mode == "values",
        emit_compact=mode == "compact",
        level_offsets=_level_offsets(tree, mode))
    return (tree, gpos.amin(dim=2).T, gpos.amax(dim=2).T, ng), tkw


def _jax_args(pos, vel, mass, acc, mode):
    """The same for the JAX ``_traverse_global`` (its ``build_lists``'
    sort, padding and octree)."""
    kw = dict(BASE, **MODES[mode])
    quad = kw.get("quadrupole", False)
    gsz, depth = kw["group_size"], kw["max_depth"]
    pos, vel, mass, acc = (jnp.asarray(x.numpy())
                           for x in (pos, vel, mass, acc))
    half = jax_bounds(pos)
    codes = jax_morton(pos, half, depth)
    order = jnp.argsort(codes).astype(jnp.int32)
    npad = -(-N // gsz) * gsz
    ng = npad // gsz
    order_pad = jnp.concatenate(
        [order, jnp.broadcast_to(order[-1], (npad - N,))])
    s_codes = codes[order_pad]
    s_pos = pos[:, order_pad]
    s_mass = jnp.where(jnp.arange(npad) >= N, 0.0, mass[order_pad])
    tree = jax_octree(s_codes, s_pos, s_mass, half, max_depth=depth,
                      start_level=2, n=npad, sorted_vel=vel[:, order_pad],
                      sorted_acc=acc[:, order_pad], with_quadrupole=quad,
                      level_caps=())
    gpos = s_pos.reshape(3, ng, gsz)
    tkw = dict(
        theta=kw["theta"], soft_sq=kw["softening"] ** 2, skin=kw["skin"],
        gsz=gsz, intervals=jbw._covered_intervals(
            jnp.zeros((ng, 0), jnp.int32), kw["window_groups"], 0, gsz),
        list_cap=kw["list_cap"], n_levels=len(tree.levels),
        wl_caps=kw["wl_caps"],
        with_acc=True, with_ranges=True, quadrupole=quad,
        emit_values=mode == "values", emit_compact=mode == "compact",
        level_offsets=_level_offsets(tree, mode))
    return (tree, jnp.min(gpos, axis=2).T, jnp.max(gpos, axis=2).T, ng), tkw


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _leaves(y)]
    return []


def _default_digest(pos, vel, mass, acc):
    h = hashlib.sha256()
    for mode in MODES:
        args, tkw = _port_args(pos, vel, mass, acc, mode)
        lists = bw.build_lists(pos, vel, mass, acc, **BASE, **MODES[mode])
        for t in (_leaves(bw._traverse_global(*args, **tkw))
                  + _leaves(tuple(lists))):
            h.update(str((mode, tuple(t.shape), str(t.dtype))).encode())
            h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _flat(x):
    """Tensors and arrays of an output tuple in order, None kept."""
    if x is None or hasattr(x, "shape"):
        return [x]
    return [y for z in x for y in _flat(z)]


def _assert_outputs_match(got, want, what):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            assert g is None and w is None, (what, i)
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")
        else:
            scale = float(np.abs(w).max()) if w.size else 0.0
            err = float(np.abs(g - w).max()) if w.size else 0.0
            assert err <= TOL * scale, (what, i, err, scale)


@pytest.fixture(scope="module")
def runs():
    """The inputs and each mode's arguments on both sides, with two torch
    threads (the suite runs several workers at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    x = _inputs()
    yield dict(x=x, port={m: _port_args(*x, m) for m in MODES},
               jax={m: _jax_args(*x, m) for m in MODES})
    torch.set_num_threads(before)


def test_default_outputs_equal_the_digest_before_ablate(runs):
    assert _default_digest(*runs["x"]) == DEFAULT_DIGEST


@pytest.mark.parametrize("mode,ablate", TRAVERSE_CASES,
                         ids=[f"{m}-{'+'.join(a)}" for m, a in
                              TRAVERSE_CASES])
def test_traverse_ablation_matches_jax(runs, mode, ablate):
    args, tkw = runs["port"][mode]
    jargs, jkw = runs["jax"][mode]
    got = bw._traverse_global(*args, **tkw, ablate=ablate)
    want = jbw._traverse_global(*jargs, **jkw, ablate=ablate)
    # far, far_range, far_n, sl_start, sl_end, sl_n, res, wl
    _assert_outputs_match(got, want, (mode, ablate))
    if "expand" in ablate:
        W = tkw["wl_caps"]
        L = len(W)
        assert [int(v) for v in got[7][1:L]] == list(W[1:])


def _jax_lists(runs, mode, ablate):
    pos, vel, mass, acc = (jnp.asarray(t.numpy()) for t in runs["x"])
    return jbw.build_lists.__wrapped__(pos, vel, mass, acc, **BASE,
                                       **MODES[mode], ablate=ablate)


@pytest.mark.parametrize("mode,ablate", BUILD_CASES,
                         ids=[f"{m}-{'+'.join(a)}" for m, a in BUILD_CASES])
def test_build_ablation_matches_jax(runs, mode, ablate):
    got = bw.build_lists(*runs["x"], **BASE, **MODES[mode], ablate=ablate)
    want = _jax_lists(runs, mode, ablate)
    for f in ("order", "inv_order", "far_n", "pstart", "pool", "far",
              "far_range", "ref_pos"):
        _assert_outputs_match(getattr(got, f), getattr(want, f), (f, ablate))
    if "finish" in ablate:
        assert float(got.pool.min()) == float(got.pool.max()) == \
            pytest.approx(float(got.far_n.sum()))
        assert not got.inv_order.any()


@pytest.mark.parametrize("mode", ["compact", "values"])
def test_finish_ablation_only_for_the_pooled_ranges_finishes(runs, mode):
    with pytest.raises(ValueError, match="finish"):
        bw.build_lists(*runs["x"], **BASE, **MODES[mode],
                       ablate=("finish",))


def test_unknown_phase_raises(runs):
    args, tkw = runs["port"]["ranges"]
    with pytest.raises(ValueError, match="unknown phases"):
        bw._traverse_global(*args, **tkw, ablate=("finish",))
    with pytest.raises(ValueError, match="unknown phases"):
        bw.build_lists(*runs["x"], **BASE, **MODES["ranges"],
                       ablate=("emits",))
