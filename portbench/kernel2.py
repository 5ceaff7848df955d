"""The work of kernel 2 (``csrc/window_eval_pool.cu``, the pooled window
evaluation) for one step on one list set: a frozen copy of the count in
``chip_smoke.py``'s phase 3.

Pairs the function needs: each group's Morton window groups that exist
(``2 wg + 1`` less those past either end), ``gsz x gsz`` pairs each, plus
``gsz`` pairs for every live far entry (``far_n``; the slots past it hold
zero mass).  18 FP32 operations a pair.  Bytes: the padded sorted
positions and masses, the 10 pool rows read of each live entry, the two
per-group tables, read once, and the accelerations written once.
"""

from __future__ import annotations

from portbench.peaks import bound_s

OPS_PER_PAIR = 18.0


def window_pairs(ng: int, gsz: int, wg: int) -> int:
    """Pairs of the window part of one step."""
    total = 0
    for g in range(ng):
        total += min(g + wg, ng - 1) - max(g - wg, 0) + 1
    return total * gsz * gsz


def step_work(ng: int, gsz: int, wg: int, live: int):
    """(pairs, bytes) of one step with ``live`` far entries in all."""
    npad = ng * gsz
    pairs = window_pairs(ng, gsz, wg) + live * gsz
    nbytes = 4 * (3 * npad + npad + 10 * live + 2 * ng + 3 * npad)
    return pairs, nbytes


def step_bound_s(ng: int, gsz: int, wg: int, live: int) -> float:
    """The least seconds one step of kernel 2 could take."""
    pairs, nbytes = step_work(ng, gsz, wg, live)
    return bound_s(OPS_PER_PAIR * pairs, nbytes)
