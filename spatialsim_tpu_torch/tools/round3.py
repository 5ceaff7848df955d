"""The pieces the round-3 eval and rebuild sweeps share (the ports of
``scripts/decide2.py``-``decide6.py`` and ``decide8.py``-``decide11.py``).

The scripts time one dispatch (``timeit``: the fastest of 3 after a
warm-up) or a chain of calls; the ports time the same calls through
:mod:`~spatialsim_tpu_torch.tools.chain` -- the host clock ended by a
synchronise, what the script's field reports, beside CUDA events.  Their
configuration is ``tools/eval_ab.py``'s :func:`ab_config` (theta 0.8, G
0.1, softening 2, spawn radius 500, skin 2, rebuild interval 48, drift
off, resolved for the body count), their sorted state and dense layout
``tools/decide_1m.py``'s.  Knobs of the TPU kernel that the card has no
counterpart for (``gpp`` / ``groups_per_program``, ``iblk``,
``vmem_mb``, ``no_cost``, ``tgt_mode``) keep their rows and labels; the
card runs its one instance, and the line says which knob it ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from spatialsim_tpu_torch.config.nbody import NBodyConfig
from spatialsim_tpu_torch.ops import bh_window as bw
from spatialsim_tpu_torch.tools.chain import chain_ms
from spatialsim_tpu_torch.tools.decide_1m import (  # noqa: F401 (shared)
    dense_kw, eval_kw, sorted_state)
from spatialsim_tpu_torch.tools.eval_ab import (  # noqa: F401 (shared)
    ab_config, initial_state)
from spatialsim_tpu_torch.tools.oracle import exact_accel_at, sample_ids

DT = 0.02
REPS = 3


def oracle(pos, mass, cfg, k, device):
    """The direct sum at ``k`` sampled bodies (``default_rng(1)``):
    ``(idx, exact (3, k) float64, |F|, rms |F|)`` on the host."""
    n = pos.shape[1]
    idx = sample_ids(n, k)
    exact = exact_accel_at(pos[:, torch.as_tensor(idx, device=device)],
                           pos, mass, cfg.G, cfg.softening)
    exact = exact.double().cpu().numpy()
    mag = np.linalg.norm(exact, axis=0)
    return idx, exact, mag, float(np.sqrt((mag ** 2).mean()))


def timed(fn, device, reps=REPS):
    """The scripts' ``timeit``: the fastest of ``reps`` calls after a
    warm-up, (host ms, device ms or None)."""
    return chain_ms(fn, 1, device, reps)


def dev_text(t) -> str:
    """``device X ms`` of a :func:`timed` pair, or ``device not
    measured``."""
    return "device not measured" if t[1] is None else f"device {t[1]:.3f} ms"


def dense_lists(cfg: NBodyConfig, pos, vel, mass):
    """The scripts' dense build (``pool_tile=0``) with zero accelerations
    (R = 10 rows)."""
    return bw.build_lists(pos, vel, mass, torch.zeros_like(pos),
                          **dense_kw(cfg))


def eval_kernel(lists) -> str:
    """Which kernel ``eval_accel_sorted`` runs on these lists on a card."""
    if lists.pool is not None:
        return ("kernel 2 (pooled lists: use_cols, far_tile and gpp have "
                "no effect, as in the JAX package)")
    return "kernel 3 (dense lists)"


def no_counterpart(*knobs) -> str:
    """The label's note for knobs the card has no counterpart for."""
    return ("" if not knobs else
            f" (no counterpart on the card: {', '.join(knobs)})")


def errors(acc, lists, idx, exact, mag, rms_mag):
    """|da|/|a| and |da|/rms|F| at the sampled bodies of a sorted-order
    ``acc``."""
    a = acc[:, lists.inv_order.long()[torch.as_tensor(idx,
                                                      device=acc.device)]]
    aerr = np.linalg.norm(a.double().cpu().numpy() - exact, axis=0)
    return aerr / np.maximum(mag, 1e-12), aerr / rms_mag
