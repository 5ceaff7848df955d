"""CUDA kernels of the PyTorch port against their plain versions, on the
card.  Marked ``cuda``: they skip without a GPU.  This file imports no
jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from spatialsim_tpu_torch import distributions

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _galaxy(n, seed, device):
    p, v, m = distributions.generate_distribution("galaxy", n, 200.0, 0.1,
                                                  seed=seed)
    return (torch.as_tensor(np.ascontiguousarray(p.T, np.float32),
                            device=device),
            torch.as_tensor(np.ascontiguousarray(v.T, np.float32),
                            device=device),
            torch.as_tensor(m.astype(np.float32), device=device))


@pytest.mark.parametrize("n", [1000, 4096])
def test_allpairs_kernel_matches_plain(cuda, n):
    from spatialsim_tpu_torch.ops.allpairs import (
        allpairs_accel, allpairs_accel_reference)
    pos, _, mass = _galaxy(n, 3, cuda)
    before = allpairs_accel.launches
    got = allpairs_accel(pos, mass, 0.1, 2.0)
    torch.cuda.synchronize()
    assert allpairs_accel.launches == before + 1
    want = allpairs_accel_reference(pos, mass, 0.1, 2.0)
    # rsqrtf (~2 ulp) and FMA contraction vs the plain rsqrt/div form.
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("steps_since", [0, 7])
def test_window_eval_kernel_matches_plain(cuda, steps_since):
    from spatialsim_tpu_torch.ops.bh_eval_kernel import (
        window_eval_pool, window_eval_pool_reference)
    from spatialsim_tpu_torch.ops.bh_window import build_lists
    n = 6000
    pos, vel, mass = _galaxy(n, 5, cuda)
    acc = torch.as_tensor((np.random.default_rng(0).standard_normal(
        (3, n)) * 0.1).astype(np.float32), device=cuda)
    lists = build_lists(pos, vel, mass, acc, theta=0.8, softening=2.0,
                        skin=2.0, max_depth=7, group_size=128,
                        window_groups=2, list_cap=512, pool_tile=128)
    o = lists.order.long()
    s_pos = pos[:, o[:n]]
    s_pos = torch.cat([s_pos, s_pos[:, -1:].expand(3, o.numel() - n)], 1)
    s_mass = torch.cat([mass[o[:n]], mass.new_zeros(o.numel() - n)])
    kw = dict(G=0.1, softening=2.0, group_size=128, window_groups=2)
    args = (s_pos, s_mass, lists.pool, lists.pstart, lists.far_n,
            steps_since, 0.02)
    before = window_eval_pool.launches
    got = window_eval_pool(*args, **kw)
    torch.cuda.synchronize()
    assert window_eval_pool.launches == before + 1
    want = window_eval_pool_reference(*args, **kw)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4


def _boids_pass_inputs(n, gsz, seed, device, bounds=60.0):
    """Pass-1 and pass-2 kernel inputs as the frozen window step builds
    them, from a uniform flock sorted by its own orders."""
    from spatialsim_tpu_torch.config.boids import BoidsConfig
    from spatialsim_tpu_torch.ops.boids_ops import (
        build_boids_orders, pass1_inputs, pass2_inputs)
    rng = np.random.default_rng(seed)
    cfg = BoidsConfig(num_boids=n, bounds=bounds)
    pos, vel, col = (torch.as_tensor(a.astype(np.float32), device=device)
                     for a in ((rng.random((3, n)) - 0.5) * 2 * bounds,
                               (rng.random((3, n)) - 0.5) * 25,
                               rng.random((3, n))))
    o1, p21, _ = build_boids_orders(
        pos, cell_size=cfg.cell_size, grid_dim=cfg.grid_dim,
        offset=cfg.bounds + cfg.cell_size, group_size=gsz)
    s1 = pass1_inputs(pos[:, o1], vel[:, o1], col[:, o1], p21.numel())
    return (*s1, None), pass2_inputs(*s1, p21, n, gsz)


@pytest.mark.parametrize("n", [4096, 5000])          # 5000: ragged, padded
@pytest.mark.parametrize("dedup", [False, True])
def test_boids_window_kernel_matches_plain(cuda, n, dedup):
    from spatialsim_tpu_torch.ops.boids_ops import (
        window_accumulate_reference)
    from spatialsim_tpu_torch.ops.boids_window_kernel import (
        boids_window_accumulate)
    gsz = 256
    args = _boids_pass_inputs(n, gsz, 7, cuda)[1 if dedup else 0]
    kw = dict(gsz=gsz, wg=1 if dedup else 2, perception_sq=25.0,
              separation_sq=9.0, prev_wg=2 if dedup else None)
    before = boids_window_accumulate.launches
    got = boids_window_accumulate(*args, **kw)
    torch.cuda.synchronize()
    assert boids_window_accumulate.launches == before + 1
    want = window_accumulate_reference(*args, **kw)
    assert float(want[13, :n].sum()) > 100         # real neighbour work
    # Counts: the kernel rounds d2 as the plain version does, so the same
    # pairs pass; sums: another order (and 1/d2 vs rsqrt^2), <= 2e-4.
    assert torch.equal(got[12:], want[12:])
    for r in range(0, 12, 3):
        err = float((got[r:r + 3] - want[r:r + 3]).abs().max())
        assert err <= 2e-4 * float(want[r:r + 3].abs().max()), (r, err)


@pytest.mark.parametrize("n", [1, 255, 1000, 4096, 30_001])
def test_allpairs_every_instance_matches_plain(cuda, n):
    """Every (threads, T, S) instance, the plan's too, against the plain
    version (1e-5 of max|a|; a lone body feels nothing), and the same
    instance twice: the fixed-order cluster sum gives equal bits."""
    from spatialsim_tpu_torch.ops.allpairs import (
        ALLPAIRS_TARGETS, ALLPAIRS_THREADS, ALLPAIRS_TILE, MAX_SLICES,
        allpairs_accel, allpairs_accel_reference, allpairs_launch)
    pos, _, mass = _galaxy(n, 4, cuda)
    want = allpairs_accel_reference(pos, mass, 0.1, 2.0)
    scale = max(float(want.abs().max()), 1e-30)
    tiles = -(-n // ALLPAIRS_TILE)
    got = allpairs_accel(pos, mass, 0.1, 2.0)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * scale
    for threads in ALLPAIRS_THREADS:
        for T in ALLPAIRS_TARGETS:
            for S in (1, 2, 3, 8):
                if S > max(tiles, 2):
                    continue
                kw = dict(threads=threads, targets=T, slices=S)
                got = allpairs_launch(pos, mass, 0.1, 2.0, **kw)
                again = allpairs_launch(pos, mass, 0.1, 2.0, **kw)
                torch.cuda.synchronize()
                assert bool(torch.isfinite(got).all()), kw
                assert float((got - want).abs().max()) <= 1e-5 * scale, kw
                assert torch.equal(got, again), kw
    with pytest.raises(ValueError):
        allpairs_launch(pos, mass, 0.1, 2.0, threads=96, targets=4,
                        slices=MAX_SLICES + 1)


@pytest.mark.parametrize("k,n", [(1, 1), (100, 257), (4096, 3000),
                                 (1000, 65_536), (33, 200_001)])
def test_allpairs_at_every_instance_matches_plain(cuda, k, n):
    """Kernel 1's targets-and-sources mode: the plan's instance and every
    (threads, T, tiles a slice) against the plain version (1e-5 of
    max|a|), a quarter of the targets on sources (dropped pairs), ragged
    k and n; two calls equal bit for bit (the fixed-order second pass)."""
    from spatialsim_tpu_torch.ops.allpairs import (
        ALLPAIRS_TARGETS, ALLPAIRS_THREADS, allpairs_accel_at,
        allpairs_at_launch, allpairs_at_reference)
    pos, _, mass = _galaxy(n, 7, cuda)
    tgt = _galaxy(k, 8, cuda)[0]
    on = min(k // 4, n)
    tgt[:, :on] = pos[:, :on]
    tgt = tgt.contiguous()
    want = allpairs_at_reference(tgt, pos, mass, 0.1, 2.0)
    scale = max(float(want.abs().max()), 1e-30)
    before = allpairs_accel_at.launches
    got = allpairs_accel_at(tgt, pos, mass, 0.1, 2.0)
    torch.cuda.synchronize()
    assert allpairs_accel_at.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-5 * scale
    for threads in ALLPAIRS_THREADS:
        for T in ALLPAIRS_TARGETS:
            for per in (1, 3, 1 << 20):
                kw = dict(threads=threads, targets_per_thread=T,
                          tiles_per_slice=per)
                got = allpairs_at_launch(tgt, pos, mass, 0.1, 2.0, **kw)
                again = allpairs_at_launch(tgt, pos, mass, 0.1, 2.0, **kw)
                torch.cuda.synchronize()
                assert bool(torch.isfinite(got).all()), kw
                assert float((got - want).abs().max()) <= 1e-5 * scale, kw
                assert torch.equal(got, again), kw


def test_allpairs_at_softening_zero_and_float64_oracle(cuda):
    """Softening 0: the gate alone drops coincident pairs; the float32
    mode within 1e-6 of max|a| of a float64 plain sum."""
    from spatialsim_tpu_torch.ops.allpairs import (
        allpairs_accel_at, allpairs_at_reference)
    pos, _, mass = _galaxy(50_000, 9, cuda)
    tgt = pos[:, ::97].contiguous()
    got = allpairs_accel_at(tgt, pos, mass, 0.1, 0.0)
    want = allpairs_at_reference(tgt.double(), pos.double(), mass.double(),
                                 0.1, 0.0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got.double() - want).abs().max()
                 / want.abs().max()) <= 1e-6


def test_ring_hops_run_the_mode(cuda):
    """The ring at world size 1: one hop, one launch of the mode, equal
    to the all-pairs kernel within 1e-5 of max|a|."""
    from spatialsim_tpu_torch.ops.allpairs import (
        allpairs_accel, allpairs_accel_at)
    from spatialsim_tpu_torch.parallel import make_mesh, ring_allpairs_accel
    pos, _, mass = _galaxy(8192, 10, cuda)
    mesh = make_mesh(device="cuda")
    try:
        before = allpairs_accel_at.launches
        ring = ring_allpairs_accel(pos, mass, mesh, 0.1, 2.0)
        assert allpairs_accel_at.launches == before + mesh.size
        ap = allpairs_accel(pos, mass, 0.1, 2.0)
        torch.cuda.synchronize()
        assert float((ring - ap).abs().max() / ap.abs().max()) <= 1e-5
    finally:
        torch.distributed.destroy_process_group()


def test_allpairs_softening_zero_coincident_bodies(cuda):
    """With softening 0 the gate alone drops self and coincident pairs;
    zero-mass padding at 1e18 adds nothing."""
    from spatialsim_tpu_torch.ops.allpairs import (
        allpairs_accel_reference, allpairs_launch)
    pos, _, mass = _galaxy(700, 6, cuda)
    pos[:, 1] = pos[:, 0]
    want = allpairs_accel_reference(pos, mass, 0.1, 0.0)
    for S in (1, 3):
        got = allpairs_launch(pos, mass, 0.1, 0.0, threads=64, targets=4,
                              slices=S)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def test_allpairs_occupancy(cuda):
    from spatialsim_tpu_torch.ops.allpairs import allpairs_occupancy
    for T in (2, 4, 8):
        blocks, regs, threads = allpairs_occupancy(128, T, 8)
        assert blocks >= 1 and 0 < regs <= 255 and threads == 128


@pytest.mark.parametrize("gsz", [96, 128, 256])
@pytest.mark.parametrize("dedup", [False, True])
def test_boids_every_instance_equals_bit_for_bit(cuda, gsz, dedup):
    """Every T and the cull on and off give the same 14 rows, bit for bit
    (each target meets its passing sources in one order), counts equal to
    the plain version's and sums within 2e-4 of its max; gsz 96 leaves
    slots past the group at T 2 and 4."""
    from spatialsim_tpu_torch.ops.boids_ops import (
        window_accumulate_reference)
    from spatialsim_tpu_torch.ops.boids_window_kernel import (
        BOIDS_TARGETS, boids_window_accumulate, boids_window_launch)
    n = 5000 - 5000 % gsz + gsz // 3
    args = _boids_pass_inputs(n, gsz, 11, cuda)[1 if dedup else 0]
    kw = dict(gsz=gsz, wg=1 if dedup else 2, perception_sq=25.0,
              separation_sq=9.0, prev_wg=2 if dedup else None)
    want = window_accumulate_reference(*args, **kw)
    first = boids_window_accumulate(*args, **kw)
    torch.cuda.synchronize()
    assert float(want[13, :n].sum()) > 100
    assert torch.equal(first[12:], want[12:])
    for r in range(0, 12, 3):
        err = float((first[r:r + 3] - want[r:r + 3]).abs().max())
        assert err <= 2e-4 * float(want[r:r + 3].abs().max()), (r, err)
    for T in BOIDS_TARGETS:
        for cull in (False, True):
            got = boids_window_launch(*args, targets=T, cull=cull, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, first), (T, cull)


@pytest.mark.parametrize("halo", ["far", "real"])
@pytest.mark.parametrize("dedup", [False, True])
def test_boids_haloed_mode(cuda, dedup, halo):
    """Kernel 4's haloed mode (``g0 = wg``, pass 1 wg 2, pass 2 wg 1):
    against its plain version (counts equal, sums within 2e-4 of max),
    every instance equal bit for bit, and equal bit for bit to the
    unsharded kernel's rows: with the far-away fill around the whole
    state, and with real halos cut from a larger state (a shard of groups
    [8, 24) of 32)."""
    from spatialsim_tpu_torch.ops.boids_window_kernel import (
        BOIDS_TARGETS, boids_window_accumulate, boids_window_launch,
        boids_window_reference)
    gsz, n = 256, 8192
    args = _boids_pass_inputs(n, gsz, 5, cuda)[1 if dedup else 0]
    wg = 1 if dedup else 2
    kw = dict(gsz=gsz, wg=wg, perception_sq=25.0, separation_sq=9.0,
              prev_wg=2 if dedup else None)
    full = boids_window_accumulate(*args, **kw)
    pw = wg * gsz
    if halo == "far":
        fill = (2e9, 0.0, 0.0, 1e9)
        src = [None if a is None else torch.cat(
            [torch.full(a.shape[:-1] + (pw,), f, device=cuda), a,
             torch.full(a.shape[:-1] + (pw,), f, device=cuda)], -1)
            for a, f in zip(args, fill)]
        want_rows = full
    else:
        lo, hi = 8 * gsz - pw, 24 * gsz + pw
        src = [None if a is None else a[..., lo:hi].contiguous()
               for a in args]
        want_rows = full[:, 8 * gsz:24 * gsz]
    before = boids_window_accumulate.launches
    got = boids_window_accumulate(*src, haloed=True, **kw)
    torch.cuda.synchronize()
    assert boids_window_accumulate.launches == before + 1
    assert got.shape == want_rows.shape
    assert torch.equal(got, want_rows)
    want = boids_window_reference(*src, haloed=True, **kw)
    assert float(want[13].sum()) > 100
    assert torch.equal(got[12:], want[12:])
    for r in range(0, 12, 3):
        err = float((got[r:r + 3] - want[r:r + 3]).abs().max())
        assert err <= 2e-4 * float(want[r:r + 3].abs().max()), (r, err)
    for T in BOIDS_TARGETS:
        for cull in (False, True):
            out = boids_window_launch(*src, targets=T, cull=cull,
                                      haloed=True, **kw)
            torch.cuda.synchronize()
            assert torch.equal(out, got), (T, cull)


def test_boids_haloed_mode_refuses_too_few_groups(cuda):
    from spatialsim_tpu_torch.ops.boids_window_kernel import (
        boids_window_accumulate)
    x = torch.zeros((3, 4 * 64), device=cuda)
    with pytest.raises(ValueError, match="no target group"):
        boids_window_accumulate(x, x, x, gsz=64, wg=2, perception_sq=1.0,
                                separation_sq=1.0, haloed=True)


def test_segment_sums_equal_the_cpus(cuda):
    """The octree's segment sums and the residual fold add in one fixed
    order on the card too: equal to the CPU's results bit for bit, and
    run to run."""
    from spatialsim_tpu_torch.ops import bh_window as bw
    from spatialsim_tpu_torch.ops import octree
    rng = np.random.default_rng(0)
    seg = torch.tensor(np.concatenate([np.sort(rng.integers(0, 50_000,
                                                            400_000)),
                                       np.full(1000, 50_000)]))
    data = torch.tensor(rng.normal(size=(3, seg.numel())).astype(np.float32))
    cpu = octree._segment(data, seg, 50_000)
    a, b = (octree._segment(data.to(cuda), seg.to(cuda), 50_000)
            for _ in range(2))
    assert torch.equal(a, b) and torch.equal(a.cpu(), cpu)
    res = torch.tensor(rng.normal(size=(10, 4000)))
    groups = torch.tensor(np.sort(rng.integers(0, 4000, 300_000)))
    rows = torch.tensor(rng.normal(size=(10, 300_000)))
    cpu = bw._fold_residual(res, groups, rows)
    a, b = (bw._fold_residual(res.to(cuda), groups.to(cuda), rows.to(cuda))
            for _ in range(2))
    assert torch.equal(a, b) and torch.equal(a.cpu(), cpu)


def test_two_1m_builds_bit_equal(cuda):
    """Two builds of one 1M galaxy state (the default config, calibrated)
    give equal lists and accelerations bit for bit, without deterministic
    algorithms; so does the exact engine."""
    from spatialsim_tpu_torch.config.nbody import NBODY, resolve_config
    from spatialsim_tpu_torch.ops import bh_window as bw
    from spatialsim_tpu_torch.ops.barnes_hut import barnes_hut_accel
    assert not torch.are_deterministic_algorithms_enabled()
    n = 1_000_000
    pos, vel, mass = _galaxy(n, 0, cuda)
    cfg = bw.calibrate_config(resolve_config(NBODY.replace(num_bodies=n), n),
                              pos, vel, mass)
    acc = torch.as_tensor((np.random.default_rng(1).standard_normal(
        (3, n)) * 0.1).astype(np.float32), device=cuda)
    builds = [bw.build_lists(pos, vel, mass, acc, **bw._build_kw(cfg))
              for _ in range(2)]
    for f, t in builds[0]._asdict().items():
        if isinstance(t, torch.Tensor):
            assert torch.equal(t, getattr(builds[1], f)), f
    ekw = bw._eval_kw(cfg)
    a, b = (bw.eval_accel(lst, pos, mass, 0.02, **ekw) for lst in builds)
    assert torch.equal(a, b)
    del builds, a, b
    p2, m2 = pos[:, :200_000].contiguous(), mass[:200_000].contiguous()
    e1, e2 = (barnes_hut_accel(p2, m2, NBODY.replace(num_bodies=200_000))
              for _ in range(2))
    assert torch.equal(e1, e2)


def test_boids_occupancy(cuda):
    from spatialsim_tpu_torch.ops.boids_window_kernel import (
        boids_occupancy, boids_threads)
    for T in (1, 2, 4):
        for dedup in (False, True):
            blocks, regs, threads = boids_occupancy(256, T, True, dedup)
            assert blocks >= 1 and 0 < regs <= 255
            assert threads == boids_threads(256, T)


def _dense_inputs(ng, gsz, R, K, L, seed, device, far_n=None):
    """Synthetic dense-layout kernel inputs: bodies in Morton-like groups
    along a random walk, far entries 50-300 units from their group (the
    slots past ``far_n`` zero, as the build leaves them), and a near table
    of ids outside each window with ~10% empty (-1) and some >= ng.
    ``far_n`` (ng,) replaces the drawn counts (above L: the first L)."""
    rng = np.random.default_rng(seed)
    npad = ng * gsz
    centre = np.cumsum(rng.normal(size=(3, ng)) * 5.0, axis=1)
    pos = np.repeat(centre, gsz, axis=1) + rng.normal(size=(3, npad)) * 3.0
    mass = rng.uniform(0.5, 2.0, npad)
    mass[-gsz // 3:] = 0.0                       # padding bodies
    far = np.zeros((ng, R, L))
    if far_n is None:
        far_n = rng.integers(0, L + 1, ng)
        far_n[:2] = (0, L)
    slot = np.arange(L)[None, :] < far_n[:, None]
    u = rng.normal(size=(3, ng, L))
    u *= rng.uniform(50.0, 300.0, (1, ng, L)) / np.linalg.norm(u, axis=0)
    rows = [centre[:, :, None] + u, rng.normal(size=(3, ng, L)),
            rng.uniform(0.5, 50.0, (1, ng, L))]
    if R in (13, 16):
        rows.append(rng.normal(size=(6, ng, L)) * 25.0 * rows[2])
    if R in (10, 16):
        rows.append(rng.normal(size=(3, ng, L)) * 0.1)
    vals = np.concatenate(rows, axis=0).transpose(1, 0, 2)
    far[:, :vals.shape[1]] = vals * slot[:, None, :]
    near = None
    if K:
        g = np.arange(ng)[:, None]
        near = (g + rng.integers(3, ng - 3, (ng, K))) % ng
        near[rng.random((ng, K)) < 0.1] = -1
        near[rng.random((ng, K)) < 0.02] = ng + 5
    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    return (t(pos, torch.float32), t(mass, torch.float32),
            t(far, torch.float32), t(far_n, torch.int32),
            None if near is None else t(near, torch.int32))


@pytest.mark.parametrize("gsz", [256, 1024])
@pytest.mark.parametrize("K", [0, 4])
@pytest.mark.parametrize("R", [8, 10, 13, 16])
def test_dense_window_eval_kernel_matches_plain(cuda, R, K, gsz):
    from spatialsim_tpu_torch.ops.bh_eval_kernel import (
        window_eval, window_eval_reference)
    ng = 2048
    s_pos, s_mass, far, far_n, near = _dense_inputs(ng, gsz, R, K, 512,
                                                    R * 10 + K, cuda)
    args = (s_pos, s_mass, far, far_n, near, 7, 0.02)
    kw = dict(G=0.1, softening=2.0, group_size=gsz, window_groups=2)
    before = window_eval.launches
    got = window_eval(*args, **kw)
    torch.cuda.synchronize()
    assert window_eval.launches == before + 1
    want = window_eval_reference(*args, **kw)
    # rsqrtf and FMA contraction vs the plain form, over ~10K sources a
    # body summed in another order: the JAX suite's Pallas-vs-XLA bar.
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("gsz", [256, 1024])
@pytest.mark.parametrize("K", [0, 4, 8])
@pytest.mark.parametrize("R", [8, 10])
@pytest.mark.parametrize("form", ["cols", "mxu"])
def test_dense_form_kernels_match_plain(cuda, form, R, K, gsz):
    """The column and matrix forms against their own plain versions."""
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    kernel = getattr(ek, f"window_eval_{form}")
    plain = getattr(ek, f"window_eval_{form}_reference")
    ng = 1024
    s_pos, s_mass, far, far_n, near = _dense_inputs(ng, gsz, R, K, 512,
                                                    R * 10 + K + 1, cuda)
    args = (s_pos, s_mass, far, far_n, near, 7, 0.02)
    kw = dict(G=0.1, softening=2.0, group_size=gsz, window_groups=2,
              far_tile=128)
    before = kernel.launches
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(*args, **kw)
    # cols: rsqrtf and FMA contraction, sums in another order; mxu: d^2
    # (its FMA chains) rounds as in the plain version, sums in another
    # order.
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4
    assert bool(torch.isfinite(got).all())


def test_mxu_kernel_rounds_as_its_plain_version(cuda):
    """Groups of tight clusters ~1,000 apart on a 1/64 grid (exact
    centres): d^2's cancellation puts the matrix form ~3e-2 of max|a| from
    the row form, and the kernel's FMA chains must land on the plain
    version's rounding, not on the row form's."""
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    ng, gsz, L = 8, 64, 16
    rng = np.random.default_rng(0)
    pos = (rng.integers(-1000, 1000, size=(3, ng, 8, 1))
           + rng.integers(-128, 128, size=(3, ng, 8, 8)) / 64.0)
    far = np.zeros((ng, 8, L))
    far[:, 0:3] = rng.integers(-4000, 4000, size=(ng, 3, L))
    far[:, 6] = 3.0
    args = tuple(torch.as_tensor(a, dtype=d, device=cuda) for a, d in (
        (pos.reshape(3, -1), torch.float32), (np.ones(ng * gsz),
                                              torch.float32),
        (far, torch.float32), (rng.integers(1, L + 1, ng), torch.int32)))
    kw = dict(G=0.1, softening=2.0, group_size=gsz, window_groups=1)
    got = ek.window_eval_mxu(*args, None, 0, 0.02, far_tile=16, **kw)
    want = ek.window_eval_mxu_reference(*args, None, 0, 0.02, far_tile=16,
                                        **kw)
    row = ek.window_eval_reference(*args, None, 0, 0.02, **kw)
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    assert rel(row, want) >= 1e-2
    assert rel(got, want) <= 2e-3
    assert rel(got, want) <= 0.1 * rel(row, want)


@pytest.mark.parametrize("gsz", [256, 1024])
def test_dense_window_eval_kernel_near8_matches_plain(cuda, gsz):
    from spatialsim_tpu_torch.ops.bh_eval_kernel import (
        window_eval, window_eval_reference)
    s_pos, s_mass, far, far_n, near = _dense_inputs(1024, gsz, 10, 8, 512,
                                                    108, cuda)
    args = (s_pos, s_mass, far, far_n, near, 7, 0.02)
    kw = dict(G=0.1, softening=2.0, group_size=gsz, window_groups=2)
    got = window_eval(*args, **kw)
    want = window_eval_reference(*args, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4


def _edge_far_n(ng, nthr, cap, seed):
    """far_n of ng groups: 0, 1, one below and one above a batch of nthr
    entries, the cap and above it on the first groups, above the cap on
    the last group, random in [0, cap] between."""
    far_n = np.random.default_rng(seed).integers(0, cap + 1, ng)
    edges = [0, 1, max(nthr - 1, 0), nthr + 1, cap, cap + 7]
    far_n[:len(edges)] = edges
    far_n[-1] = cap + 7
    return far_n


def _pool_inputs(ng, gsz, tile, far_n, seed, device):
    """Synthetic pooled kernel inputs: bodies as in ``_dense_inputs``, each
    group's first far_n entries (com3, vel3, mass, acc3) packed into its
    ceil(far_n / tile) tiles from pstart, every other slot zero, as the
    pool finish leaves them."""
    rng = np.random.default_rng(seed)
    npad = ng * gsz
    centre = np.cumsum(rng.normal(size=(3, ng)) * 5.0, axis=1)
    pos = np.repeat(centre, gsz, axis=1) + rng.normal(size=(3, npad)) * 3.0
    mass = rng.uniform(0.5, 2.0, npad)
    mass[-gsz // 3:] = 0.0
    n_t = np.maximum(1, -(-far_n // tile))
    pstart = np.concatenate([[0], np.cumsum(n_t)[:-1]])
    pool = np.zeros((int(n_t.sum()), 16, tile))
    for g in range(ng):
        e = np.arange(far_n[g])
        u = rng.normal(size=(3, e.size))
        u *= rng.uniform(50.0, 300.0, e.size) / np.linalg.norm(u, axis=0)
        rows = np.concatenate([centre[:, g:g + 1] + u,
                               rng.normal(size=(3, e.size)),
                               rng.uniform(0.5, 50.0, (1, e.size)),
                               rng.normal(size=(3, e.size)) * 0.1])
        pool[pstart[g] + e // tile, :10, e % tile] = rows.T

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    return (t(pos, torch.float32), t(mass, torch.float32),
            t(pool, torch.float32), t(pstart, torch.int32),
            t(far_n, torch.int32))


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("gsz", [64, 256, 1024])
def test_pool_kernel_every_tile_matches_plain(cuda, gsz):
    """Every T, far_n at the batch and tile edges, the first and last
    groups, and the heavy-first launch order (each group's sum unchanged,
    bit for bit)."""
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    ng, tile = 40, 128
    kw = dict(G=0.1, softening=2.0, group_size=gsz, window_groups=2,
              tau_clamp=24.0)
    for T in (1, 2, 4):
        args = _pool_inputs(ng, gsz, tile,
                            _edge_far_n(ng, gsz // T, tile, T), T, cuda)
        args = args + (7, 0.02)
        before = ek.window_eval_pool.launches
        got = ek.pool_launch(*args, targets=T, **kw)
        ordered = ek.pool_launch(*args, targets=T,
                                 order=ek.heavy_first(args[4]), **kw)
        torch.cuda.synchronize()
        assert ek.window_eval_pool.launches == before + 2
        want = ek.window_eval_pool_reference(*args, **kw)
        assert _rel(got, want) < 1e-4, T
        assert torch.equal(ordered, got), T
        assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("gsz", [64, 256, 1024])
@pytest.mark.parametrize("K", [0, 4])
@pytest.mark.parametrize("R", [8, 10, 13, 16])
def test_dense_kernel_every_tile_matches_plain(cuda, R, K, gsz):
    """Every T the kernel takes at R, far_n at the batch and cap edges,
    near ids -1 and >= ng, the first and last groups, and the heavy-first
    launch order (each group's sum unchanged, bit for bit)."""
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    ng, L = 48, 256
    kw = dict(G=0.1, softening=2.0, group_size=gsz, window_groups=2,
              tau_clamp=24.0)
    for T in (1, 2, 4):
        args = _dense_inputs(ng, gsz, R, K, L, R * 10 + K + T, cuda,
                             _edge_far_n(ng, gsz // T, L, T))
        args = args + (7, 0.02)
        got = ek.dense_launch(*args, targets=T, **kw)
        ordered = ek.dense_launch(*args, targets=T, order=ek.heavy_first(
            args[3], args[4], gsz), **kw)
        torch.cuda.synchronize()
        want = ek.window_eval_reference(*args, **kw)
        assert _rel(got, want) < 1e-4, T
        assert torch.equal(ordered, got), T
        assert bool(torch.isfinite(got).all())


# The stage-ablation rows of tools/decide7.py: (far lists kept, dbg).
ABLATION_ROWS = ((True, ""), (False, ""), (False, "nowin"),
                 (False, "nowin,nostage"), (False, "nowin,nostage,notgt"),
                 (False, "nowin,nostage,notgt,nouttr"), (False, "nouttr"),
                 (True, "nouttr"), (True, "notgt"), (True, "nowin"))


@pytest.mark.parametrize("gsz", [64, 256, 512, 1024])
@pytest.mark.parametrize("K", [0, 4])
@pytest.mark.parametrize("R", [10, 16])
def test_dense_kernel_ablation_matches_plain(cuda, R, K, gsz):
    """The ablation instances (``dbg``) at every T and every ablation row,
    against the plain version within 1e-4 of max|a| (of the largest block
    sum for ``nouttr``: blocks of 256 at group 1,024); heavy-first order
    equal bit for bit; launches counted apart from the default
    instance's."""
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    ng, L = 24, 256
    kw = dict(G=0.1, softening=2.0, group_size=gsz, window_groups=2,
              tau_clamp=24.0)
    for T in (1, 2, 4):
        args = _dense_inputs(ng, gsz, R, K, L, R * 10 + K + T, cuda,
                             _edge_far_n(ng, gsz // T, L, T))
        zero = torch.zeros_like(args[3])
        order = ek.heavy_first(args[3], args[4], gsz)
        for keep, dbg in ABLATION_ROWS:
            a = args[:3] + ((args[3] if keep else zero),) + args[4:] + (
                7, 0.02)
            before = (ek.window_eval.launches, ek.window_eval.dbg_launches)
            got = ek.dense_launch(*a, targets=T, dbg=dbg, **kw)
            ordered = ek.dense_launch(*a, targets=T, order=order, dbg=dbg,
                                      **kw)
            torch.cuda.synchronize()
            want = ek.window_eval_reference(*a, dbg=dbg, **kw)
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            assert (err <= 1e-4 * scale if scale else err == 0), \
                (T, dbg, keep, err, scale)
            assert torch.equal(ordered, got), (T, dbg)
            assert bool(torch.isfinite(got).all())
            assert (ek.window_eval.launches, ek.window_eval.dbg_launches) \
                == ((before[0], before[1] + 2) if dbg else
                    (before[0] + 2, before[1]))


def test_dense_kernel_ablation_refusals(cuda):
    """``nostage`` without ``nowin`` and unknown flags raise before a
    launch; the C entry point refuses flags it does not know."""
    from spatialsim_tpu_torch import _kernels
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    args = _dense_inputs(8, 64, 10, 0, 64, 1, cuda) + (0, 0.02)
    kw = dict(G=0.1, softening=2.0, group_size=64, window_groups=2,
              tau_clamp=24.0)
    before = ek.window_eval.dbg_launches
    for dbg in ("nostage", "notgt,nostage", "nowin,bogus"):
        with pytest.raises(ValueError):
            ek.window_eval(*args, dbg=dbg, **kw)
    assert ek.window_eval.dbg_launches == before
    s_pos, s_mass, far, far_n = args[:4]
    out = torch.empty_like(s_pos)
    err = _kernels.entry.spatialsim_window_eval(
        s_pos.data_ptr(), s_mass.data_ptr(), far.data_ptr(),
        far_n.data_ptr(), None, None, out.data_ptr(), 8, 0, 8, 64, 1, 2, 0,
        10, 64, 4.0, 0.1, 0.0, 0.0, 8, _kernels.stream(s_pos))
    assert err != 0


def test_eval_bench_plain_step_launches_no_kernel(cuda):
    """``tools/eval_bench.py``'s ``xla_fallback`` chain on the card: no
    kernel launched, the accelerations within 1e-4 of max|a| of the
    production step's (the dense kernel) on the same state."""
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    from spatialsim_tpu_torch.ops import bh_window as bw
    from spatialsim_tpu_torch.tools import eval_bench
    n = 32768
    cfg = eval_bench.base_config(n).replace(use_pallas_eval=False)
    st = bw.init_window_state(*_galaxy(n, 3, cuda), cfg)
    assert st.lists.pool is None
    before = ek.window_eval.launches
    got = eval_bench.plain_step(cfg, n, 2)(st, 0.02)
    torch.cuda.synchronize()
    assert ek.window_eval.launches == before
    want = bw.make_window_step(cfg, n, substeps=2)(st, 0.02)
    torch.cuda.synchronize()
    assert ek.window_eval.launches == before + 2
    assert _rel(got.acc, want.acc) < 1e-4
    assert bool(torch.isfinite(got.pos).all())


@pytest.mark.parametrize("gsz", [64, 256])
@pytest.mark.parametrize("K", [0, 4])
@pytest.mark.parametrize("R", [8, 10])
def test_cols_kernel_every_instance_matches_plain(cuda, R, K, gsz):
    """Every T of the column kernel, in group order and heavy-first (equal
    bit for bit), against its plain version: far_n at the batch and cap
    edges, a live slot past far_n inside a group's last tile (the form
    reads whole tiles), near ids -1 and >= ng; and the wrapper's plan."""
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    ng, L, tile = 48, 256, 64
    kw = dict(G=0.1, softening=2.0, group_size=gsz, window_groups=2,
              tau_clamp=24.0, far_tile=tile)
    for T in (1, 2, 4):
        args = _dense_inputs(ng, gsz, R, K, L, R * 10 + K + T, cuda,
                             _edge_far_n(ng, gsz // T, L, T))
        far, far_n = args[2], args[3]
        far[1, :7, 1] = far[1, :7, 0] * 1.5 + 1.0      # past far_n = 1
        args = args + (7, 0.02)
        order = ek.heavy_first(far_n, args[4], gsz, (L, tile))
        before = ek.window_eval_cols.launches
        got = ek.cols_launch(*args, targets=T, **kw)
        ordered = ek.cols_launch(*args, targets=T, order=order, **kw)
        torch.cuda.synchronize()
        assert ek.window_eval_cols.launches == before + 2
        want = ek.window_eval_cols_reference(*args, **kw)
        assert _rel(got, want) < 1e-4, T
        assert torch.equal(ordered, got), T
        assert bool(torch.isfinite(got).all())
    planned = ek.window_eval_cols(*args, **kw)
    torch.cuda.synchronize()
    assert _rel(planned, want) < 1e-4


def test_cols_kernel_occupancy_and_refusals(cuda):
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    for T in (1, 2, 4):
        for R in (8, 10):
            blocks, regs, threads = ek.occupancy(256, T, R, 2, 8, cols=True)
            assert blocks >= 1 and 0 < regs <= 255 and threads == 256 // T
    args = _dense_inputs(8, 64, 8, 0, 64, 0, cuda) + (0, 0.02)
    kw = dict(G=0.1, softening=2.0, group_size=64, window_groups=2,
              tau_clamp=24.0, far_tile=64)
    before = ek.window_eval_cols.launches
    with pytest.raises(RuntimeError, match="window_eval_cols"):
        ek.cols_launch(*args, targets=3, **kw)         # no such instance
    assert ek.window_eval_cols.launches == before


MXU_INSTANCES = (("fma", 1), ("fma", 2), ("fma", 4), ("mma", 2), ("mma", 4))


@pytest.mark.parametrize("gsz", [64, 256])
@pytest.mark.parametrize("R", [8, 10])
@pytest.mark.parametrize("form", ["row", "cols", "mxu"])
def test_dense_kernels_modes_match_plain(cuda, form, R, gsz):
    """The haloed and local_slice modes of the row, column and matrix
    kernels (the wrapper's instance, and for the matrix form every
    instance) on 4 shards: each within 1e-4 of max|a| of its plain version
    in the same mode, and equal bit for bit to the unsharded kernel's
    slice (a zero-mass halo body adds exactly 0)."""
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    ng, L, wg, D = 48, 256, 2, 4
    ngl, halo = ng // D, wg * gsz
    seed = R + gsz + len(form)
    s_pos, s_mass, far, far_n, _ = _dense_inputs(
        ng, gsz, R, 0, L, seed, cuda, _edge_far_n(ng, gsz // 2, L, seed))
    kw = dict(G=0.1, softening=2.0, group_size=gsz, window_groups=wg,
              tau_clamp=24.0)
    if form != "row":
        kw.update(far_tile=64, use_cols=form == "cols",
                  use_mxu=form == "mxu")
    counter = getattr(ek, "window_eval" if form == "row"
                      else f"window_eval_{form}")
    plain = getattr(ek, "window_eval_reference" if form == "row"
                    else f"window_eval_{form}_reference")
    pkw = {k: v for k, v in kw.items() if not k.startswith("use_")}
    full = ek.window_eval(s_pos, s_mass, far, far_n, None, 23, 0.02, **kw)
    pm = torch.nn.functional.pad(torch.cat([s_pos, s_mass[None]]),
                                 (halo, halo))
    for r in range(D):
        g = slice(r * ngl, (r + 1) * ngl)
        b = slice(r * ngl * gsz, (r + 1) * ngl * gsz)
        src = pm[:, r * ngl * gsz:(r + 1) * ngl * gsz + 2 * halo]
        halo_in = (src[:3].contiguous(), src[3].contiguous(),
                   far[g].contiguous(), far_n[g].contiguous(), None, 23,
                   0.02)
        slice_in = (s_pos, s_mass, far[g].contiguous(),
                    far_n[g].contiguous(), None, 23, 0.02)
        for args, mode in ((halo_in, dict(haloed=True)),
                           (slice_in, dict(local_slice=(r * ngl, ngl)))):
            before = counter.launches
            got = ek.window_eval(*args, **mode, **kw)
            torch.cuda.synchronize()
            assert counter.launches == before + 1
            assert got.shape == (3, ngl * gsz)
            assert _rel(got, plain(*args, **mode, **pkw)) < 1e-4, (r, mode)
            assert torch.equal(got, full[:, b]), (r, mode)
            if form == "mxu":
                mkw = {k: v for k, v in pkw.items()}
                for contraction, n in MXU_INSTANCES:
                    if contraction == "fma" and gsz % (32 * n):
                        continue
                    inst = ek.mxu_launch(*args, targets=n,
                                         contraction=contraction, **mode,
                                         **mkw)
                    whole = ek.mxu_launch(s_pos, s_mass, far, far_n, None,
                                          23, 0.02, targets=n,
                                          contraction=contraction, **mkw)
                    assert torch.equal(inst, whole[:, b]), (contraction, n)


@pytest.mark.parametrize("gsz", [64, 128, 256, 512])
@pytest.mark.parametrize("K", [0, 8])
@pytest.mark.parametrize("R", [8, 10])
def test_mxu_kernel_every_instance_matches_plain(cuda, R, K, gsz):
    """Every instance of the matrix kernel -- the register tile at T 1, 2
    and 4 (where gsz / T is whole warps) and the tensor-core contraction at
    M 2 and 4 -- in group order and heavy-first (equal bit for bit),
    against its plain version at steps_since 0 and 23 (1e-4 of max|a|):
    far_n ragged and at the batch and cap edges, near ids -1 and >= ng; the
    wrapper's plan; and, with the previous kernel's sources in
    ``_build/parent/``, each instance's distance from it (printed: the sums
    run in another order, so they are not bit-equal)."""
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    from spatialsim_tpu_torch.tools import eval_tiles
    ng, L, tile = 48, 256, 64
    kw = dict(G=0.1, softening=2.0, group_size=gsz, window_groups=2,
              tau_clamp=24.0, far_tile=tile)
    plib = eval_tiles.parent_library()
    for steps in (0, 23):
        seed = R * 10 + K + gsz + steps
        args = _dense_inputs(ng, gsz, R, K, L, seed, cuda,
                             _edge_far_n(ng, 64, L, seed))
        far, far_n = args[2], args[3]
        far[1, :7, 1] = far[1, :7, 0] * 1.5 + 1.0      # past far_n = 1
        args = args + (steps, 0.02)
        want = ek.window_eval_mxu_reference(*args, **kw)
        prev = (eval_tiles.parent_mxu(plib, *args, **kw)
                if eval_tiles.has_parent(plib, "window_eval_mxu") else None)
        order = ek.heavy_first(far_n, args[4], gsz, (L, tile))
        for contraction, n in MXU_INSTANCES:
            if contraction == "fma" and gsz % (32 * n):
                continue
            before = ek.window_eval_mxu.launches
            got = ek.mxu_launch(*args, targets=n, contraction=contraction,
                                **kw)
            ordered = ek.mxu_launch(*args, targets=n, order=order,
                                    contraction=contraction, **kw)
            torch.cuda.synchronize()
            assert ek.window_eval_mxu.launches == before + 2
            assert _rel(got, want) < 1e-4, (contraction, n, steps)
            assert torch.equal(ordered, got), (contraction, n, steps)
            assert bool(torch.isfinite(got).all())
            if prev is not None:
                print(f"mxu R={R} K={K} gsz={gsz} steps_since={steps} "
                      f"{contraction} {n}: {_rel(got, prev):.3e} of max|a| "
                      f"from the previous kernel")
        planned = ek.window_eval_mxu(*args, **kw)
        torch.cuda.synchronize()
        assert _rel(planned, want) < 1e-4


@pytest.mark.parametrize("K", [0, 2])
def test_mxu_every_instance_rounds_as_its_plain_version(cuda, K):
    """Every instance on tight clusters ~1,000 apart on a 1/64 grid (exact
    centres), where d^2's cancellation puts the matrix form 2-3e-2 of
    max|a| from the row form: each lands on the plain version's rounding
    within the JAX package's 2e-3 bar (the plain version itself is 4.9e-4
    from JAX's there)."""
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    ng, gsz, L = 8, 64, 16
    rng = np.random.default_rng(K)
    pos = (rng.integers(-1000, 1000, size=(3, ng, 8, 1))
           + rng.integers(-128, 128, size=(3, ng, 8, 8)) / 64.0)
    far = np.zeros((ng, 8, L))
    far[:, 0:3] = rng.integers(-4000, 4000, size=(ng, 3, L))
    far[:, 6] = 3.0
    near = None
    if K:
        near = np.stack([(np.arange(ng) + 3 + k) % ng for k in range(K)], 1)
        near[::2, -1] = -1
        near = torch.as_tensor(near, dtype=torch.int32, device=cuda)
    args = tuple(torch.as_tensor(a, dtype=d, device=cuda) for a, d in (
        (pos.reshape(3, -1), torch.float32), (np.ones(ng * gsz),
                                              torch.float32),
        (far, torch.float32), (rng.integers(1, L + 1, ng), torch.int32)))
    args = args + (near, 0, 0.02)
    kw = dict(G=0.1, softening=2.0, group_size=gsz, window_groups=1,
              tau_clamp=24.0, far_tile=16)
    want = ek.window_eval_mxu_reference(*args, **kw)
    row = ek.window_eval_reference(*args[:5], 0, 0.02, G=0.1, softening=2.0,
                                   group_size=gsz, window_groups=1)
    assert _rel(row, want) >= 1e-2
    for contraction, n in MXU_INSTANCES:
        if gsz % (32 * n) and contraction == "fma":
            continue
        got = ek.mxu_launch(*args, targets=n, contraction=contraction, **kw)
        torch.cuda.synchronize()
        assert _rel(got, want) <= 2e-3, (contraction, n)
        assert _rel(got, want) <= 0.1 * _rel(row, want)


def test_mxu_kernel_occupancy_and_refusals(cuda):
    """Every instance reports its occupancy; an instance the group size
    does not allow is refused by the C entry point too, and counts no
    launch."""
    from spatialsim_tpu_torch import _kernels
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    for gsz in (256, 1024):
        for contraction, n in MXU_INSTANCES:
            for R in (8, 10):
                blocks, regs, threads = ek.mxu_occupancy(gsz, contraction, n,
                                                         R, 2, 8)
                assert blocks >= 1 and 0 < regs <= 255
                assert threads == (gsz // n if contraction == "fma"
                                   else 32 * -(-gsz // (16 * n)))
    args = _dense_inputs(8, 64, 8, 0, 64, 0, cuda) + (0, 0.02)
    kw = dict(G=0.1, softening=2.0, group_size=64, window_groups=2,
              tau_clamp=24.0, far_tile=64)
    before = ek.window_eval_mxu.launches
    with pytest.raises(ValueError, match="multiple of 128"):
        ek.mxu_launch(*args, targets=4, contraction="fma", **kw)
    out = torch.empty_like(args[0])
    for mma, n, gsz in ((1, 2, 40), (1, 3, 64), (0, 4, 64), (0, 8, 64)):
        err = _kernels.entry.spatialsim_window_eval_mxu(
            args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(),
            args[3].data_ptr(), None, None, out.data_ptr(), 8, 0, 8, gsz,
            mma, n, 2, 0, 8, 64, 64, 4.0, 0.1, 0.0, 0.0,
            _kernels.stream(out))
        assert err != 0, (mma, n, gsz)
    assert ek.window_eval_mxu.launches == before


def test_launch_path_uses_the_current_stream(cuda):
    """Under torch.cuda.stream(s) the launch path's stream is s's, every
    wrapper launches there without synchronising, and its output is right
    once s is synchronised."""
    from spatialsim_tpu_torch import _kernels
    from spatialsim_tpu_torch.ops import allpairs
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    x = tp.lane_row(cuda)
    pos, _, mass = _galaxy(512, 3, cuda)
    want = allpairs.allpairs_accel_reference(pos, mass, 0.1, 2.0)
    assert _kernels.stream(x) == torch.cuda.current_stream().cuda_stream
    s = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s):
        assert _kernels.stream(x) == s.cuda_stream != 0
        # A long kernel first on s, so the launches below queue behind it.
        big = torch.randn(2048, 2048, device=cuda)
        for _ in range(20):
            big = big @ big / 2048.0
        outs = [tp.roll(x, k) for k in (0, 5, -3, 127)]
        acc = allpairs.allpairs_accel(pos, mass, 0.1, 2.0)
    s.synchronize()
    for k, out in zip((0, 5, -3, 127), outs):
        assert torch.equal(out, torch.roll(x, k, 1)), k
    assert _rel(acc, want) < 1e-5
    assert _kernels.stream(x) == torch.cuda.current_stream().cuda_stream


def test_window_kernels_softening_zero_coincident_bodies(cuda):
    """Softening 0: coincident bodies (and far entries on a body) add
    nothing through the gate, near-coincident ones (|d| = 2^-10) stay
    finite; both kernels at every T against their plain versions."""
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    ng, gsz, tile = 24, 256, 128
    far_n = _edge_far_n(ng, 64, tile, 0)
    pos, mass, pool, pstart, far_n_t = _pool_inputs(ng, gsz, tile, far_n, 3,
                                                    cuda)
    pos[:, 1::7] = pos[:, 0::7][:, :pos[:, 1::7].shape[1]]
    pos[:, 2::9] = pos[:, 3::9][:, :pos[:, 2::9].shape[1]]
    pos[0, 5::11] = pos[0, 4::11][:pos[0, 5::11].shape[0]] + 2.0 ** -10
    pos[:, 300] = pos[:, 20]                       # across groups
    pool[int(pstart[1]), 0:3, 0] = pos[:, gsz + 3]   # an entry on a body
    kw = dict(G=0.1, softening=0.0, group_size=gsz, window_groups=2,
              tau_clamp=24.0)
    args = (pos, mass, pool, pstart, far_n_t, 0, 0.02)
    want = ek.window_eval_pool_reference(*args, **kw)
    assert bool(torch.isfinite(want).all())
    for T in (1, 2, 4):
        got = ek.pool_launch(*args, targets=T, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), T
        assert _rel(got, want) < 1e-4, T
    # The dense kernel on the same bodies (R = 8 entries of the pool).
    L = tile
    far = torch.zeros((ng, 8, L), device=cuda)
    n_dense = far_n_t.clamp(max=L)
    for g in range(ng):
        far[g, :7, :int(n_dense[g])] = pool[int(pstart[g]), :7,
                                            :int(n_dense[g])]
    far[1, 0:3, 0] = pos[:, gsz + 3]
    args = (pos, mass, far, n_dense.contiguous(), None, 0, 0.02)
    want = ek.window_eval_reference(*args, **kw)
    assert bool(torch.isfinite(want).all())
    for T in (1, 2, 4):
        got = ek.dense_launch(*args, targets=T, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), T
        assert _rel(got, want) < 1e-4, T


def test_window_kernels_report_occupancy(cuda):
    from spatialsim_tpu_torch.ops import bh_eval_kernel as ek
    for T in (1, 2, 4):
        blocks, regs, threads = ek.occupancy(256, T)
        assert blocks >= 1 and 0 < regs <= 255 and threads == 256 // T
        for R in (8, 16):
            blocks, regs, threads = ek.occupancy(1024, T, R, 2, 8)
            assert blocks >= 1 and 0 < regs <= 255 and threads == 1024 // T


def _probe_cases(dev):
    """Each traversal probe at a small size, as (wrapper, call, plain):
    sums of arange rows stay integers below 2^24, so kernel and plain
    version agree bit for bit."""
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    tree, idx = tp.table(64, dev), tp.indices(64, 256, dev)
    idx2 = tp.indices(62, 256, dev)
    idx16 = tp.indices(64 * 16, 256, dev)
    x, idx4 = tp.lane_row(dev), torch.arange(4, dtype=torch.int32,
                                             device=dev)
    cases = {}
    for w in (1, 2, 4, 8):
        for c in (False, True):
            for where in tp.WHERE:
                cases[f"row_reads w{w} {c} {where}"] = (
                    tp.row_reads,
                    lambda w=w, c=c, where=where: tp.row_reads(
                        tree, idx, 2, w, chained=c, where=where),
                    lambda w=w: tp.row_reads_reference(tree, idx, 2, w))
    for c in (False, True):
        cases[f"block_read {c}"] = (
            tp.block_read, lambda c=c: tp.block_read(tree, idx2, 2,
                                                     chained=c),
            lambda: tp.block_read_reference(tree, idx2, 2))
        for fn, ref in ((tp.scalar_load_dynsub,
                         tp.scalar_load_dynsub_reference),
                        (tp.scalar_load_dyn_dyn,
                         tp.scalar_load_dyn_dyn_reference)):
            cases[f"{fn.__name__} {c}"] = (
                fn, lambda fn=fn, c=c: fn(tree, idx, 2, chained=c),
                lambda ref=ref: ref(tree, idx, 2))
        for roll in (False, True):
            cases[f"extract8 {roll} {c}"] = (
                tp.extract8, lambda roll=roll, c=c: tp.extract8(
                    tree, idx16, 2, use_roll=roll, chained=c),
                lambda: tp.extract8_reference(tree, idx16, 2))
    for n_ops, reps, b in ((4096, 40, 1), (256, 2, 4), (256, 2, 8)):
        cases[f"reduce_roundtrip {reps} {b}"] = (
            tp.reduce_roundtrip,
            lambda n_ops=n_ops, reps=reps, b=b: tp.reduce_roundtrip(
                x, n_ops, reps, b),
            lambda n_ops=n_ops, reps=reps, b=b: tp.reduce_roundtrip_reference(
                x.cpu(), n_ops, reps, b))
    cases["row_write"] = (tp.row_write, lambda: tp.row_write(tree, idx, 2),
                          lambda: tp.row_write_reference(tree, idx, 2))
    for s in (0, 5, 126, -3):
        cases[f"roll {s}"] = (tp.roll, lambda s=s: tp.roll(x, s),
                              lambda s=s: torch.roll(x, s, 1))
    for n in (256, 8192):
        for where in tp.WHERE:
            cases[f"smem_table {n} {where}"] = (
                tp.smem_table, lambda n=n, where=where: tp.smem_table(
                    idx4, n, 512, 2, where=where),
                lambda n=n: tp.smem_table_reference(idx4.cpu(), n, 512, 2))
    # arange x 2^24: each word's sum passes 2^31 and saturates.
    for scale in (1, 2 ** 24):
        for pct in (0, 15, 100):
            cases[f"gated_reduce {pct} x{scale}"] = (
                tp.gated_reduce,
                lambda pct=pct, scale=scale: tp.gated_reduce(x * scale, pct,
                                                             512, 2),
                lambda pct=pct, scale=scale: tp.gated_reduce_reference(
                    x.cpu() * scale, pct, 512, 2))
    cases["row_store"] = (tp.row_store, lambda: tp.row_store(idx, 64, 2),
                          lambda: tp.row_store_reference(idx, 64, 2))
    for k in tp.K_RUNS:
        for scale in (1e-6, 1e-6 * 2 ** 18):
            t6, i6 = tp.iteration_inputs(k, scale=scale, n_iters=1024,
                                         device=dev)
            cases[f"iteration_core {k} {scale}"] = (
                tp.iteration_core,
                lambda t6=t6, i6=i6, k=k: tp.iteration_core(t6, i6, k, 1024,
                                                            2),
                lambda t6=t6, i6=i6, k=k: tp.iteration_core_reference(
                    t6.cpu(), i6.cpu(), k, 1024, 2))
    return cases


def test_probe_kernels_match_plain(cuda):
    failed = []
    for name, (wrapper, call, plain) in _probe_cases(cuda).items():
        before = wrapper.launches
        got = call()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, name
        want = plain()
        # The row write and row store return (scr[0], scr): both compared.
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want, strict=True):
            if not torch.equal(g.cpu(), w.cpu()):
                failed.append((name, g.cpu().ravel()[:4].tolist(),
                               w.cpu().ravel()[:4].tolist()))
    assert not failed, failed


def test_probe_shared_placements_refuse_past_the_optin_limit(cuda):
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    limit = tp.smem_optin_bytes(cuda)
    idx4 = torch.arange(4, dtype=torch.int32, device=cuda)
    before = (tp.smem_table.launches, tp.row_reads.launches)
    with pytest.raises(ValueError):
        tp.smem_table(idx4, limit // 4 + 1, where="shared")
    rows = limit // 512 + 1
    with pytest.raises(ValueError):
        tp.row_reads(tp.table(rows, cuda), tp.indices(rows, 64, cuda), 1,
                     where="shared")
    assert (tp.smem_table.launches, tp.row_reads.launches) == before
    # The largest tables that fit run.
    got = tp.row_reads(tp.table(tp.SHARED_ROWS, cuda),
                       tp.indices(tp.SHARED_ROWS, 64, cuda), 1,
                       where="shared")
    torch.cuda.synchronize()
    assert tp.row_reads.launches == before[1] + 1
    assert bool(torch.isfinite(got).all())


# The card-wide instances' slice counts and warps a block: one slice (the
# serial order), uneven slices (7 of 12,288 reads), a block of 32 warps,
# the tool's default, and more slices than reads (one slice empty).
CARD_SPREADS = ((1, 1), (7, 7), (96, 32), (132 * 32, 8), (12_289, 1))


def _card_twice(call):
    """Two calls of a card-wide instance, synchronised, on the host."""
    got = [call() for _ in range(2)]
    torch.cuda.synchronize()
    return [g.cpu() for g in got]


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_probe_row_reads_card_matches_plain(cuda, width):
    """5a's card-wide instance, where the float32 sums round (8,192 cells,
    4,096 reads, 3 passes; the shared table 448 rows): every spread,
    plain and chained, global and shared, equal bit for bit to its plain
    version and to a second call; one slice is the one-warp order."""
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    tables = {"global": tp.row_inputs(8192, 4096, cuda),
              "shared": tp.row_inputs(tp.SHARED_ROWS, 4096, cuda)}
    failed = []
    for slices, warps in CARD_SPREADS:
        for where, (tree, idx) in tables.items():
            want = tp.row_reads_card_reference(tree, idx, 3, width, slices)
            if slices == 1:
                assert torch.equal(want, tp.row_reads(tree, idx, 3, width,
                                                      where=where))
            for chained in (False, True):
                before = (tp.row_reads.launches, tp.row_reads.card_launches)
                a, b = _card_twice(lambda: tp.row_reads(
                    tree, idx, 3, width, chained=chained, where=where,
                    spread="card", slices=slices, warps=warps))
                assert (tp.row_reads.launches, tp.row_reads.card_launches
                        ) == (before[0] + 2, before[1] + 2)
                if not (torch.equal(a, want.cpu()) and torch.equal(a, b)):
                    failed.append((slices, warps, where, chained,
                                   float((a - want.cpu()).abs().max()),
                                   float((a - b).abs().max())))
    assert not failed, failed


def test_probe_block_read_card_matches_plain(cuda):
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    tree, idx = tp.block_read_inputs(8192, 4096, cuda)
    failed = []
    for slices, warps in CARD_SPREADS:
        want = tp.block_read_card_reference(tree, idx, 3, slices).cpu()
        for chained in (False, True):
            a, b = _card_twice(lambda: tp.block_read(
                tree, idx, 3, chained=chained, spread="card", slices=slices,
                warps=warps))
            if not (torch.equal(a, want) and torch.equal(a, b)):
                failed.append((slices, warps, chained))
    assert not failed, failed
    assert torch.equal(tp.block_read_card_reference(tree, idx, 3, 1),
                       tp.block_read(tree, idx, 3))


@pytest.mark.parametrize("use_roll", [True, False])
def test_probe_extract8_card_matches_plain(cuda, use_roll):
    """5h's card-wide instance (a warp a slice with ``use_roll``, else a
    thread a slice), where the float32 chain rounds (8,192 cells, 4,096
    visits, 3 passes): every spread, plain and chained, equal bit for bit
    to its plain version and to a second call, each call counted once in
    ``launches`` and ``card_launches``; one slice is the serial order, and
    the one-warp (one-thread) instance still gives the serial plain
    version's bits."""
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    tree, idx = tp.extract8_inputs(8192, 4096, cuda)
    serial = tp.extract8_reference(tree, idx, 3).cpu()
    failed = []
    for chained in (False, True):
        got = tp.extract8(tree, idx, 3, use_roll=use_roll, chained=chained)
        if not torch.equal(got.cpu(), serial):
            failed.append(("one-warp", chained))
    for slices, warps in CARD_SPREADS:
        want = tp.extract8_card_reference(tree, idx, 3, slices).cpu()
        if slices == 1:
            assert torch.equal(want, serial)
        for chained in (False, True):
            before = (tp.extract8.launches, tp.extract8.card_launches)
            a, b = _card_twice(lambda: tp.extract8(
                tree, idx, 3, use_roll=use_roll, chained=chained,
                spread="card", slices=slices, warps=warps))
            assert (tp.extract8.launches, tp.extract8.card_launches) == (
                before[0] + 2, before[1] + 2)
            if not (torch.equal(a, want) and torch.equal(a, b)):
                failed.append((slices, warps, chained, float(a - want),
                               float(a - b)))
    assert not failed, failed


@pytest.mark.parametrize("dyn_lane", [False, True])
def test_probe_scalar_load_card_matches_plain(cuda, dyn_lane):
    """5f's (5g's with ``dyn_lane``) card-wide instance, a thread a slice,
    where the float32 chain rounds (8,192 cells, 4,096 reads, 3 passes):
    every spread, plain and chained, equal bit for bit to its plain
    version and to a second call, each call counted once in ``launches``
    and ``card_launches``; one slice is the serial order, and the
    one-thread instance still gives the serial plain version's bits."""
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    fn = tp.scalar_load_dyn_dyn if dyn_lane else tp.scalar_load_dynsub
    ref = (tp.scalar_load_dyn_dyn_reference if dyn_lane
           else tp.scalar_load_dynsub_reference)
    tree, idx = tp.row_inputs(8192, 4096, cuda)
    serial = ref(tree, idx, 3).cpu()
    failed = []
    for chained in (False, True):
        if not torch.equal(fn(tree, idx, 3, chained=chained).cpu(), serial):
            failed.append(("one-thread", chained))
    for slices, warps in CARD_SPREADS:
        want = tp.scalar_load_card_reference(tree, idx, 3, slices,
                                             dyn_lane).cpu()
        if slices == 1:
            assert torch.equal(want, serial)
        for chained in (False, True):
            before = (fn.launches, fn.card_launches)
            a, b = _card_twice(lambda: fn(tree, idx, 3, chained=chained,
                                          spread="card", slices=slices,
                                          warps=warps))
            assert (fn.launches, fn.card_launches) == (before[0] + 2,
                                                       before[1] + 2)
            if not (torch.equal(a, want) and torch.equal(a, b)):
                failed.append((slices, warps, chained, float(a - want),
                               float(a - b)))
    assert not failed, failed


@pytest.mark.parametrize("n_cells", [64, 8192])
def test_probe_row_write_card_matches_plain(cuda, n_cells):
    """5d's card-wide instance: at every spread ``scr[0]`` and the whole
    scratch table equal the plain version and a second call bit for bit
    (at 64 cells some index is 0, so scr[0] is a written row), each call
    counted once; the one-warp instance's output unchanged."""
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    tree, idx = tp.row_write_inputs(n_cells, 4096, cuda)
    tree = tree * torch.arange(1, n_cells + 1, dtype=torch.float32,
                               device=cuda)[:, None]   # rows told apart
    want = [w.cpu() for w in tp.row_write_reference(tree, idx, 3)]
    assert all(torch.equal(g.cpu(), w)
               for g, w in zip(tp.row_write(tree, idx, 3), want))
    failed = []
    for slices, warps in CARD_SPREADS:
        before = (tp.row_write.launches, tp.row_write.card_launches)
        calls = [tp.row_write(tree, idx, 3, spread="card", slices=slices,
                              warps=warps) for _ in range(2)]
        torch.cuda.synchronize()
        assert (tp.row_write.launches, tp.row_write.card_launches) == (
            before[0] + 2, before[1] + 2)
        for out, scr in calls:
            if not (torch.equal(out.cpu(), want[0])
                    and torch.equal(scr.cpu(), want[1])):
                failed.append((slices, warps))
    assert not failed, failed
    if n_cells == 64:
        assert bool(want[0].any())


@pytest.mark.parametrize("n_cells", [64, 8192])
def test_probe_row_store_card_matches_plain(cuda, n_cells):
    """6c's card-wide instance: at every spread ``scr[0]`` and the whole
    scratch table equal the plain version and a second call bit for bit
    (at 64 cells a late index 0 wins row 0), each call counted once; the
    one-warp instance's output unchanged; over no stores (reps 0) the
    table stays zero."""
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    idx = tp.indices(n_cells, 4096, cuda)
    want = [w.cpu() for w in tp.row_store_reference(idx, n_cells, 3)]
    assert all(torch.equal(g.cpu(), w)
               for g, w in zip(tp.row_store(idx, n_cells, 3), want))
    failed = []
    for slices, warps in CARD_SPREADS:
        before = (tp.row_store.launches, tp.row_store.card_launches)
        calls = [tp.row_store(idx, n_cells, 3, spread="card", slices=slices,
                              warps=warps) for _ in range(2)]
        torch.cuda.synchronize()
        assert (tp.row_store.launches, tp.row_store.card_launches) == (
            before[0] + 2, before[1] + 2)
        for out, scr in calls:
            if not (torch.equal(out.cpu(), want[0])
                    and torch.equal(scr.cpu(), want[1])):
                failed.append((slices, warps))
    assert not failed, failed
    if n_cells == 64:
        assert float(want[0][0, 5]) > 5.0
    out, scr = tp.row_store(idx, n_cells, 0, spread="card", slices=96,
                            warps=32)
    assert not bool(scr.any()) and not bool(out.any())


@pytest.mark.parametrize("batch", [1, 4, 8])
def test_probe_reduce_roundtrip_card_matches_plain(cuda, batch):
    """5c's card-wide instance (4,096 steps x 3 passes) on a row summing to
    8,129, where the float32 chains round: at every spread equal to its
    plain version and to a second call, each call counted once; one slice
    gives the one-warp kernel's float32."""
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    x = tp.lane_row(cuda).clone()
    x[0, 0] = 1.0
    one_warp = tp.reduce_roundtrip(x, 4096, 3, batch).cpu()
    assert torch.equal(one_warp, tp.reduce_roundtrip_reference(
        x.cpu(), 4096, 3, batch))
    failed = []
    for slices, warps in CARD_SPREADS:
        want = tp.reduce_roundtrip_card_reference(x.cpu(), 4096, 3, batch,
                                                  slices)
        before = (tp.reduce_roundtrip.launches,
                  tp.reduce_roundtrip.card_launches)
        a, b = _card_twice(lambda: tp.reduce_roundtrip(
            x, 4096, 3, batch, spread="card", slices=slices, warps=warps))
        assert (tp.reduce_roundtrip.launches,
                tp.reduce_roundtrip.card_launches) == (before[0] + 2,
                                                       before[1] + 2)
        if not (torch.equal(a, want) and torch.equal(a, b)
                and (slices > 1 or torch.equal(a, one_warp))):
            failed.append((slices, warps, float(a), float(b), float(want),
                           float(one_warp)))
    assert not failed, failed


@pytest.mark.parametrize("pct", [0, 15, 100])
def test_probe_gated_reduce_card_matches_plain(cuda, pct):
    """6b's card-wide instance (4,096 steps x 3 passes) on the probe's row,
    on it x 2^24 (the words saturate) and x -3 (negative words): at every
    spread equal to its plain version and to a second call, each call
    counted once; one slice, the redesigned chain, gives the one-warp
    kernel's int32."""
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    failed = []
    for scale in (1, 2 ** 24, -3):
        x = tp.lane_row(cuda) * scale
        one_warp = tp.gated_reduce(x, pct, 4096, 3).cpu()
        assert torch.equal(one_warp, tp.gated_reduce_reference(
            x.cpu(), pct, 4096, 3)), scale
        for slices, warps in CARD_SPREADS:
            want = tp.gated_reduce_card_reference(x.cpu(), pct, 4096, 3,
                                                  slices)
            before = (tp.gated_reduce.launches,
                      tp.gated_reduce.card_launches)
            a, b = _card_twice(lambda: tp.gated_reduce(
                x, pct, 4096, 3, spread="card", slices=slices, warps=warps))
            assert (tp.gated_reduce.launches,
                    tp.gated_reduce.card_launches) == (before[0] + 2,
                                                       before[1] + 2)
            if not (torch.equal(a, want) and torch.equal(a, b)
                    and (slices > 1 or torch.equal(a, one_warp))):
                failed.append((scale, slices, warps, int(a), int(b),
                               int(want), int(one_warp)))
    assert not failed, failed


# 6a's tables: the probe's four sizes, in shared memory where a block can
# hold them, and sizes that do not divide 2^32, where the residue of a
# wrapped s + acc mod 7 is (b2 + r) mod n with b2 != b.
SMEM_CASES = ((8192, "shared"), (32768, "shared"), (65536, "global"),
              (131072, "global"), (8191, "shared"), (8191, "global"),
              (131071, "global"))


@pytest.mark.parametrize("n_i32,where", SMEM_CASES)
def test_probe_smem_table_card_matches_plain(cuda, n_i32, where):
    """6a's card-wide instance (4,096 steps x 3 passes) on the probe's
    offsets and on offsets near +-2^31, where s + acc mod 7 wraps: at every
    spread equal to its plain version and to a second call, each call
    counted once; one slice, the redesigned chain, gives the one-thread
    kernel's int32."""
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    failed = []
    for idx4 in (tp.smem_inputs(cuda), tp.smem_edge_inputs(cuda)):
        one_thread = tp.smem_table(idx4, n_i32, 4096, 3, where=where).cpu()
        assert torch.equal(one_thread, tp.smem_table_reference(
            idx4.cpu(), n_i32, 4096, 3)), idx4
        for slices, warps in CARD_SPREADS:
            want = tp.smem_table_card_reference(idx4.cpu(), n_i32, 4096, 3,
                                                slices)
            before = (tp.smem_table.launches, tp.smem_table.card_launches)
            a, b = _card_twice(lambda: tp.smem_table(
                idx4, n_i32, 4096, 3, where=where, spread="card",
                slices=slices, warps=warps))
            assert (tp.smem_table.launches,
                    tp.smem_table.card_launches) == (before[0] + 2,
                                                     before[1] + 2)
            if not (torch.equal(a, want) and torch.equal(a, b)
                    and (slices > 1 or torch.equal(a, one_thread))):
                failed.append((idx4.tolist(), slices, warps, int(a), int(b),
                               int(want), int(one_thread)))
    assert not failed, failed


def _iteration_tables(k, dev):
    """6d's inputs: the probe's table scale, where no decision fires; the
    scale where decisions fire and ``acc mod 3`` moves the starts; and a
    6-row table (scale 1) with starts in [-64, 192), where rows wrap at
    n_cells - 2 and a step loads 3 or 4 rows."""
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    tables = {scale: tp.iteration_inputs(k, scale=scale, n_iters=1024,
                                         device=dev)
              for scale in (1e-6, 1e-6 * 2 ** 18)}
    tables["wrap"] = (tp.table(6, dev), torch.as_tensor(
        np.random.default_rng(1).integers(-64, 192, 1024 * k).astype(
            np.int32), device=dev))
    return tables


@pytest.mark.parametrize("k", [1, 2, 4])
def test_probe_iteration_core_card_matches_plain(cuda, k):
    """6d's card-wide instance (1,024 steps x 2 passes): at every spread
    (warps a block capped at ``ITER_WARPS``) equal to its plain version
    and to a second call, each call counted once; one slice, the
    redesigned chain, gives the one-warp kernel's int32 at every table."""
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    spreads = [(s, min(w, tp.ITER_WARPS)) for s, w in CARD_SPREADS]
    failed = []
    for name, (tree, idx) in _iteration_tables(k, cuda).items():
        one_warp = tp.iteration_core(tree, idx, k, 1024, 2).cpu()
        assert torch.equal(one_warp, tp.iteration_core_reference(
            tree.cpu(), idx.cpu(), k, 1024, 2)), name
        for slices, warps in spreads:
            want = tp.iteration_core_card_reference(
                tree.cpu(), idx.cpu(), k, 1024, 2, slices)
            before = (tp.iteration_core.launches,
                      tp.iteration_core.card_launches)
            a, b = _card_twice(lambda: tp.iteration_core(
                tree, idx, k, 1024, 2, spread="card", slices=slices,
                warps=warps))
            assert (tp.iteration_core.launches,
                    tp.iteration_core.card_launches) == (before[0] + 2,
                                                         before[1] + 2)
            if not (torch.equal(a, want) and torch.equal(a, b)
                    and (slices > 1 or torch.equal(a, one_warp))):
                failed.append((name, slices, warps, int(a), int(b),
                               int(want), int(one_warp)))
    assert not failed, failed


def test_probe_card_instances_refuse(cuda):
    """A shared table past the opt-in limit (with the card-wide
    instance's mbarrier, or 6a's offsets) raises before any launch; the
    empty launch runs."""
    from spatialsim_tpu_torch.ops import traversal_probes as tp
    rows = (tp.smem_optin_bytes(cuda) - 16) // 512 + 1
    tree, idx = tp.table(rows, cuda), tp.indices(rows, 64, cuda)
    before = (tp.row_reads.launches, tp.row_reads.card_launches)
    with pytest.raises(ValueError):
        tp.row_reads(tree, idx, 1, where="shared", spread="card", slices=132,
                     warps=1)
    with pytest.raises(ValueError):
        tp.row_reads(tree, idx, 1, spread="card", slices=132, warps=5)
    assert (tp.row_reads.launches, tp.row_reads.card_launches) == before
    spread = (tp.extract8, tp.row_write, tp.scalar_load_dynsub,
              tp.scalar_load_dyn_dyn, tp.row_store, tp.iteration_core,
              tp.reduce_roundtrip, tp.gated_reduce, tp.smem_table)
    before = [(f.launches, f.card_launches) for f in spread]
    x, idx4 = tp.lane_row(cuda), tp.smem_inputs(cuda)
    args = {tp.row_store: (idx, rows, 1),
            tp.iteration_core: (tree, idx, 1, 64, 1),
            tp.reduce_roundtrip: (x, 64, 1), tp.gated_reduce: (x, 15, 64, 1),
            tp.smem_table: (idx4, 256, 64, 1)}
    for fn in spread:
        for kw in (dict(spread="card", slices=132, warps=5),
                   dict(spread="card", slices=0), dict(spread="grid")):
            with pytest.raises(ValueError):
                fn(*args.get(fn, (tree, idx, 1)), **kw)
    # 6a's card-wide table: n of at least SMEM_MIN_N, and a shared block
    # (the table and 16 B of offsets) within the opt-in limit.
    with pytest.raises(ValueError):
        tp.smem_table(idx4, tp.SMEM_MIN_N - 1, spread="card", slices=132,
                      warps=1)
    with pytest.raises(ValueError):
        tp.smem_table(idx4, (tp.smem_optin_bytes(cuda) - 12) // 4,
                      where="shared", spread="card", slices=132, warps=1)
    # 6d's blocks hold at most ITER_WARPS warps.
    with pytest.raises(ValueError):
        tp.iteration_core(tree, idx, 1, 64, 1, spread="card", slices=96,
                          warps=tp.ITER_WARPS * 2)
    assert [(f.launches, f.card_launches) for f in spread] == before
    tp.empty_launch(528, 256, tree)
    torch.cuda.synchronize()
