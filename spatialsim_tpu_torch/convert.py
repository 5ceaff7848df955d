"""Carry the JAX package's window-engine and boids states into the port.

Arrays come in as numpy (or anything ``np.asarray`` takes, such as a JAX
array, without importing jax here) and go out as tensors of the port's
dtypes on ``device``.  With these the tests feed JAX-built lists straight
into the port's eval, which holds eval parity apart from build parity.

    lists = lists_from_numpy(jl.order, jl.inv_order, jl.far_n, jl.ref_pos,
                             jl.pool, jl.pstart, int(jl.steps_since),
                             int(jl.steps_build))
    dense = dense_lists_from_numpy(jl.order, jl.inv_order, jl.far,
                                   jl.far_n, jl.far_range, jl.near,
                                   jl.ref_pos, int(jl.steps_since))
    emits = compact_emits_from_numpy(je.ent, je.cnt)
    state = boids_window_state_from_numpy(*jax_boids_window_state)
    rank_state = sharded_window_state_from_numpy(
        st.pos, st.vel, st.mass, jl.order, jl.inv_order, jl.far, jl.far_n,
        jl.far_range, jl.ref_pos, acc=st.acc, rank=r, world_size=D)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spatialsim_tpu_torch.models.boids import BoidsWindowState
from spatialsim_tpu_torch.ops.bh_window import (BHLists, CompactEmits,
                                                WindowBHState)


def _t(arr, dtype, device):
    return torch.tensor(np.asarray(arr), device=device).to(dtype)


def lists_from_numpy(order, inv_order, far_n, ref_pos, pool, pstart,
                     steps_since: int = 0, steps_build: Optional[int] = None,
                     *, device="cpu") -> BHLists:
    """A pooled :class:`BHLists` from the JAX package's arrays."""
    return BHLists(
        order=_t(order, torch.int32, device),
        inv_order=_t(inv_order, torch.int32, device),
        far_n=_t(far_n, torch.int32, device),
        ref_pos=_t(ref_pos, torch.float32, device),
        pool=_t(pool, torch.float32, device),
        pstart=_t(pstart, torch.int32, device),
        steps_since=int(steps_since),
        steps_build=int(steps_since if steps_build is None else steps_build))


def dense_lists_from_numpy(order, inv_order, far, far_n, far_range, near,
                           ref_pos, steps_since: int = 0,
                           steps_build: Optional[int] = None, *,
                           device="cpu") -> BHLists:
    """A dense :class:`BHLists` (``far`` ``(ng, R, L)``) from the JAX
    package's arrays; ``far_range`` may be None, and a ``near`` table with
    no columns (the JAX default) becomes None."""
    near_t = None
    if near is not None and np.asarray(near).shape[1] > 0:
        near_t = _t(near, torch.int32, device)
    return BHLists(
        order=_t(order, torch.int32, device),
        inv_order=_t(inv_order, torch.int32, device),
        far_n=_t(far_n, torch.int32, device),
        ref_pos=_t(ref_pos, torch.float32, device),
        far=_t(far, torch.float32, device),
        far_range=(None if far_range is None
                   else _t(far_range, torch.int32, device)),
        near=near_t,
        steps_since=int(steps_since),
        steps_build=int(steps_since if steps_build is None else steps_build))


def compact_emits_from_numpy(ent, cnt, *, device="cpu") -> CompactEmits:
    """:class:`CompactEmits` (int64) from the JAX package's compact
    traversal emissions: ``ent`` (2, sum E_l), ``cnt`` (n_levels, ng)."""
    return CompactEmits(ent=_t(ent, torch.int64, device),
                        cnt=_t(cnt, torch.int64, device))


def window_state_from_numpy(pos, vel, mass, lists: BHLists, acc=None, *,
                            device="cpu") -> WindowBHState:
    """A :class:`WindowBHState` from sorted-order numpy state + lists."""
    return WindowBHState(
        pos=_t(pos, torch.float32, device),
        vel=_t(vel, torch.float32, device),
        mass=_t(mass, torch.float32, device),
        lists=lists,
        acc=None if acc is None else _t(acc, torch.float32, device))


def boids_window_state_from_numpy(pos, vel, col, order1, inv1, p21, s21,
                                  steps_since: int = 0, *,
                                  device="cpu") -> BoidsWindowState:
    """A boids :class:`BoidsWindowState` from the JAX package's fields
    (pass-1-sorted ``(3, n)`` state, int orders, ``steps_since``)."""
    f32 = (_t(a, torch.float32, device) for a in (pos, vel, col))
    i64 = (_t(a, torch.int64, device) for a in (order1, inv1, p21, s21))
    return BoidsWindowState(*f32, *i64, int(steps_since))


def sharded_window_state_from_numpy(pos, vel, mass, order, inv_order, far,
                                    far_n, far_range, ref_pos, acc=None,
                                    steps_since: int = 0,
                                    steps_build: Optional[int] = None, *,
                                    rank: int, world_size: int,
                                    device="cpu") -> WindowBHState:
    """One rank's state of the sharded window step
    (``spatialsim_tpu_torch.parallel.sharded.make_sharded_window_step``)
    from the JAX package's sharded window state, its arrays whole: the
    sorted-layout ``pos``/``vel``/``mass``/``ref_pos``/``acc`` and the dense
    ``far``/``far_n``/``far_range`` lose all but the rank's contiguous block
    (bodies, groups); ``order`` and ``inv_order`` stay whole, as JAX
    replicates them."""
    def bodies(a):
        a = np.asarray(a)
        k = a.shape[-1] // world_size
        return a[..., rank * k:(rank + 1) * k]

    def groups(a):
        a = np.asarray(a)
        k = a.shape[0] // world_size
        return a[rank * k:(rank + 1) * k]

    lists = dense_lists_from_numpy(
        order, inv_order, groups(far), groups(far_n), groups(far_range),
        None, bodies(ref_pos), steps_since, steps_build, device=device)
    return window_state_from_numpy(
        bodies(pos), bodies(vel), bodies(mass), lists,
        None if acc is None else bodies(acc), device=device)
