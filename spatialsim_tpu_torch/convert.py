"""Carry the JAX package's window-engine state into the port.

Arrays come in as numpy (or anything ``np.asarray`` takes, such as a JAX
array, without importing jax here) and go out as tensors of the port's
dtypes on ``device``.  With these the tests feed JAX-built lists straight
into the port's eval, which holds eval parity apart from build parity.

    lists = lists_from_numpy(jl.order, jl.inv_order, jl.far_n, jl.ref_pos,
                             jl.pool, jl.pstart, int(jl.steps_since),
                             int(jl.steps_build))
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spatialsim_tpu_torch.ops.bh_window import BHLists, WindowBHState


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


def window_state_from_numpy(pos, vel, mass, lists: BHLists, acc=None, *,
                            device="cpu") -> WindowBHState:
    """A :class:`WindowBHState` from sorted-order numpy state + lists."""
    return WindowBHState(
        pos=_t(pos, torch.float32, device),
        vel=_t(vel, torch.float32, device),
        mass=_t(mass, torch.float32, device),
        lists=lists,
        acc=None if acc is None else _t(acc, torch.float32, device))
