"""The boids kernel's box cull, on the CPU: its plain model
(``chunk_cull_reference``) never skips a 32-source chunk that holds a pair
passing the predicate, with d^2 rounded as ``window_accumulate_reference``
rounds it.

The model makes the kernel's decisions with the kernel's float32
operations (boxes by min/max, per-axis gaps by one rounded subtraction,
gap^2 as ((x^2 + y^2) + z^2)), so this holds the kernel too; on the card
``tests/test_torch_cuda.py`` holds the kernel with the cull on to the
kernel with it off, bit for bit.  Cases: seeded uniform states sorted as
the window step sorts them, a 20K flock stepped by the port's plain path,
and points placed at the perception radius times (1 +- 1e-6) from a box's
face, edge or corner.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spatialsim_tpu_torch.config.boids import BOIDS, BoidsConfig
from spatialsim_tpu_torch.models.boids import Flock
from spatialsim_tpu_torch.ops.boids_ops import (
    build_boids_orders, pass1_inputs, pass2_inputs)
from spatialsim_tpu_torch.ops.boids_window_kernel import (
    BOIDS_TARGETS, CHUNK, boids_threads, boids_window_launch,
    chunk_cull_reference)


def _check_cull(s_pos, s_grpf=None, *, gsz, wg, perception_sq, targets,
                prev_wg=None):
    """For each T in ``targets``: every pair of every skipped chunk fails
    the predicate (in a second pass, ``s_grpf`` given, with its dedup
    against ``prev_wg``).  Returns the model's results by T."""
    culls = {T: chunk_cull_reference(s_pos, gsz=gsz, wg=wg,
                                     perception_sq=perception_sq, targets=T)
             for T in targets}
    ng = s_pos.shape[1] // gsz
    pw = float(prev_wg if prev_wg is not None else wg)
    tp = s_pos.reshape(3, ng, gsz)
    for k in range(2 * wg + 1):
        h = torch.arange(ng) - wg + k
        ok = (h >= 0) & (h < ng)
        sp = tp[:, h.clamp(0, ng - 1)]
        d = tp[:, :, :, None] - sp[:, :, None, :]       # (3, ng, gsz, gsz)
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        passing = (d2 < perception_sq) & (d2 > 1e-4)
        if s_grpf is not None:
            tg = s_grpf.reshape(ng, gsz)
            seen = (tg[:, :, None] - tg[h.clamp(0, ng - 1)][:, None, :]
                    ).abs() <= pw
            passing = passing & ~seen
        passing = passing & ok[:, None, None]
        for T, cull in culls.items():
            slots = boids_threads(gsz, T) * T
            W, C = slots // (CHUNK * T), slots // CHUNK

            def by_chunk(m):
                full = torch.zeros((ng, slots, slots), dtype=torch.bool)
                full[:, :gsz, :gsz] = m
                return full.reshape(ng, W, CHUNK * T, C, CHUNK).any(
                    4).any(2)
            holds = by_chunk(passing)
            skipped = cull["skip"][:, :, k, :]
            assert not bool((holds & skipped).any()), (T, k, int(
                (holds & skipped).sum()))
    return culls


def _sorted_passes(n, gsz, seed, bounds):
    """Pass-1 and pass-2 kernel inputs of a uniform flock, sorted by its
    own orders as the window step sorts them."""
    rng = np.random.default_rng(seed)
    cfg = BoidsConfig(num_boids=n, bounds=bounds)
    pos, vel, col = (torch.as_tensor(a.astype(np.float32)) for a in (
        (rng.random((3, n)) - 0.5) * 2 * bounds,
        (rng.random((3, n)) - 0.5) * 25, rng.random((3, n))))
    o1, p21, _ = build_boids_orders(
        pos, cell_size=cfg.cell_size, grid_dim=cfg.grid_dim,
        offset=cfg.bounds + cfg.cell_size, group_size=gsz)
    s1 = pass1_inputs(pos[:, o1], vel[:, o1], col[:, o1], p21.numel())
    return s1, pass2_inputs(*s1, p21, n, gsz)


@pytest.mark.parametrize("gsz", [256, 128, 96])
@pytest.mark.parametrize("seed", [0, 1])
def test_cull_never_skips_a_passing_pair_uniform(gsz, seed):
    n = 3000 + 17 * seed
    s1, s2 = _sorted_passes(n, gsz, seed, bounds=40.0)
    c1 = _check_cull(s1[0], gsz=gsz, wg=2, perception_sq=25.0,
                     targets=BOIDS_TARGETS)
    c2 = _check_cull(s2[0], s2[3], gsz=gsz, wg=1, perception_sq=25.0,
                     targets=BOIDS_TARGETS, prev_wg=2)
    # A Morton-sorted flock has chunks to skip, and chunks to test.
    for T in BOIDS_TARGETS:
        assert 0 < c1[T]["tested"] < c1[T]["pairs"]
        assert c2[T]["tested"] < c2[T]["pairs"]


def test_cull_never_skips_a_passing_pair_20k_flock():
    """A 20K flock at the default density (500K boids in a box of 500
    scaled to 20K), stepped by the port's plain window path; the skipped
    share is printed (``-s``), not asserted."""
    bounds = BOIDS.bounds * (20_000 / BOIDS.num_boids) ** (1 / 3)
    cfg = BOIDS.replace(num_boids=20_000, bounds=bounds,
                        neighbor_mode="window")
    flock = Flock(config=cfg, device="cpu", seed=3)
    for _ in range(6):
        flock.update(1.0 / 30.0)
    st = flock.state
    gsz = cfg.group_size
    s1 = pass1_inputs(st.pos, st.vel, st.col, st.p21.numel())
    s2 = pass2_inputs(*s1, st.p21, st.pos.shape[1], gsz)
    psq = cfg.perception_radius ** 2
    c1 = _check_cull(s1[0], gsz=gsz, wg=cfg.window_groups,
                     perception_sq=psq, targets=BOIDS_TARGETS)
    c2 = _check_cull(s2[0], s2[3], gsz=gsz, wg=cfg.pass2_window_groups,
                     perception_sq=psq, targets=BOIDS_TARGETS,
                     prev_wg=cfg.window_groups)
    for T in BOIDS_TARGETS:
        print(f"20K flock after 6 steps, T={T}: pass 1 skips "
              f"{1 - c1[T]['tested'] / c1[T]['pairs']:.4f} of its window "
              f"pairs, pass 2 {1 - c2[T]['tested'] / c2[T]['pairs']:.4f}")


_EDGES = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1),
          (1, 1, 1)]


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1),
       centre=st.floats(-500.0, 500.0),
       half=st.floats(0.5, 20.0),
       radius=st.sampled_from([5.0, 3.0, 1.7]),
       rel=st.sampled_from([-1e-6, -3e-7, -6e-8, 0.0, 6e-8, 3e-7, 1e-6]),
       edge=st.sampled_from(_EDGES),
       targets=st.sampled_from([1, 2]))
def test_cull_exact_at_the_perception_radius(seed, centre, half, radius,
                                             rel, edge, targets):
    """Sources at the perception radius times (1 + rel) from a corner of
    the warp's target box, straight out of a face, an edge or the corner:
    one target sits at that corner, so the chunk's gap^2 equals that
    pair's d^2 and the decision is the predicate's own at the boundary."""
    rng = np.random.default_rng(seed)
    gsz = 64
    c = np.float32(centre)
    tgt = (c + rng.uniform(-half, half, (3, gsz))).astype(np.float32)
    tgt[:, 31] = np.delete(tgt, 31, 1).max(1)   # the box corner: a target
    u = np.asarray(edge, np.float64) * rng.uniform(0.2, 1.0, 3)
    u /= np.linalg.norm(u)
    src = np.empty((3, gsz), np.float32)
    # Chunk 0: one point, so its box is that point; chunk 1: jittered.
    src[:, :32] = (tgt[:, 31].astype(np.float64)
                   + u * radius * (1 + rel))[:, None]
    src[:, 32:] = (tgt[:, 31:32].astype(np.float64) + u[:, None] * radius
                   * (1 + rng.uniform(-1e-5, 1e-5, 32)))
    s_pos = torch.from_numpy(np.concatenate([tgt, src], 1))
    psq = float(np.float32(radius * radius))
    cull = _check_cull(s_pos, gsz=gsz, wg=1, perception_sq=psq,
                       targets=(targets,))[targets]
    # The decision is exact: chunk 0 is skipped iff the corner pair fails.
    d = (tgt[:, 31] - src[:, 0]).astype(np.float32)
    d2 = np.float32(np.float32(d[0] * d[0]) + np.float32(d[1] * d[1]))
    d2 = np.float32(d2 + np.float32(d[2] * d[2]))
    passes = bool(d2 < np.float32(psq)) and bool(d2 > np.float32(1e-4))
    assert bool(cull["skip"][0, 0, 2, 0]) == (not passes)


def test_boids_threads_cover_the_group():
    for gsz in (1, 31, 32, 96, 128, 200, 256, 1024):
        for T in BOIDS_TARGETS:
            nthr = boids_threads(gsz, T)
            assert nthr % CHUNK == 0 and nthr * T >= gsz
            assert (nthr - CHUNK) * T < gsz


def test_launcher_refuses_cpu_tensors():
    s_pos = torch.zeros((3, 256))
    with pytest.raises(ValueError):
        boids_window_launch(s_pos, s_pos, s_pos, gsz=256, wg=2,
                            perception_sq=25.0, separation_sq=9.0,
                            targets=2, cull=True)
