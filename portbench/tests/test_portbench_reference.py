"""The frozen copies against what they copy, and the reference's frame
judgement on frames made exactly."""

import numpy as np
import pytest
import torch

from portbench.galaxy import disk_from_draws, draws, galaxy
from portbench.reference import (Frame, colours, control_frame, direct_sum,
                                 judge, pairwise_sum)


def numpy_direct(pos, mass, G, soft):
    d = pos[None, :, :] - pos[:, None, :]
    r2 = (d * d).sum(-1)
    w = np.where(r2 > 0, mass[None, :] / (r2 + soft * soft) ** 1.5, 0.0)
    return G * (w[:, :, None] * d).sum(1)


def test_direct_sum_matches_numpy_float64():
    rng = np.random.default_rng(3)
    pos = rng.normal(0, 50, (512, 3))
    pos[7] = pos[3]                        # coincident bodies add nothing
    mass = rng.uniform(0.5, 2.0, 512)
    want = numpy_direct(pos, mass, 0.1, 3.0)
    for form in (direct_sum, pairwise_sum):
        got = form(torch.tensor(pos), torch.tensor(pos), torch.tensor(mass),
                   0.1, 3.0, block=100)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-15)


class _Draws:
    """A numpy ``Generator`` stand-in handing out given draws in turn."""

    def __init__(self, d):
        self.normals = [d[k].numpy() for k in ("height", "vx", "vz", "vy")]
        self.d = d

    def exponential(self, scale, n):
        return scale * self.d["exp"].numpy()

    def uniform(self, lo, hi, n):
        return lo + (hi - lo) * self.d["uniform"].numpy()

    def normal(self, mu, sigma, n):
        return mu + sigma * self.normals.pop(0)


def test_galaxy_recipe_matches_the_programs():
    from spatialsim_tpu_torch import distributions as dist
    n, R, G = 3000, 800.0, 0.1
    d = draws(n, 11, "cpu")
    pos, vel, mass = disk_from_draws(d, R, G)
    p, v, r, _ = dist._exponential_disk(_Draws(d), n, R, G)
    v = dist._zero_com_velocity(v, np.ones(n))
    np.testing.assert_allclose(pos.numpy(), p, rtol=1e-12, atol=1e-9)
    # Bodies clamped to the least radius tie, and the recipe leaves their
    # order (so their enclosed mass) to the sort: compare the others.
    free = r > R * 0.001
    assert free.sum() > 0.99 * n
    np.testing.assert_allclose(vel.numpy()[free], v[free], rtol=1e-9,
                               atol=1e-5)
    assert float(vel.sum(0).abs().max()) < 1e-9
    assert torch.equal(mass, torch.ones(n, dtype=torch.float64))
    a = galaxy(n, R, G, 5, "cpu")[0]
    assert torch.equal(a, galaxy(n, R, G, 5, "cpu")[0])
    assert not torch.equal(a, galaxy(n, R, G, 6, "cpu")[0])


def test_colours_match_the_programs():
    from spatialsim_tpu_torch.ops.colors import colors_by_velocity
    speeds = torch.linspace(0, 20, 4001)
    vel = torch.stack([speeds * 0.6, speeds * 0.8, 0 * speeds], 1)
    want = colors_by_velocity(vel.T.contiguous().float(), 15.0).T.double()
    got = colours(vel.double(), 15.0)
    # float32 t times the steepest band's slope (50): a few 1e-6.
    assert float((got - want).abs().max()) < 1e-5


def _exact_frame(n=600, substeps=1, seed=0):
    """A frame stepped in float32 from a direct sum, as the program's
    substeps step it."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 3, generator=g, dtype=torch.float64) * 40
    v = torch.randn(n, 3, generator=g, dtype=torch.float64)
    m = torch.ones(n, dtype=torch.float64)
    dt, damping = 0.075, 1.0
    x32, v32 = x.float(), v.float()
    for _ in range(substeps):
        a32 = direct_sum(x32.double(), x32.double(), m, 0.1, 3.0).float()
        v32 = (v32 + a32 * dt) * damping
        x32 = x32 + v32 * dt
    col = colours(v32.double(), 15.0).float()
    return Frame(x_p=x.float(), v_p=v.float(), x_c=x32, v_c=v32, col_c=col,
                 acc=a32, substeps=substeps, dt=dt, damping=damping), m


@pytest.mark.parametrize("substeps", [1, 2])
def test_judge_reads_rounding_on_an_exact_frame(substeps):
    frame, m = _exact_frame(substeps=substeps)
    sample = torch.arange(0, 600, 3)
    r = judge(frame, m, 0.1, 3.0, 15.0, {"s": sample}, "cpu")
    assert r["colour_gap"] < 1e-6
    assert r["closure_ulp"] < 4
    assert len(r["force"]["s"]["rms"]) == substeps
    # The first of two substeps' accelerations come from its kick:
    # float32 velocities over dt.
    assert max(r["force"]["s"]["rms"]) < 1e-3
    ctl = judge(control_frame(frame, m, 0.1, 3.0, 15.0, sample, "cpu"), m,
                0.1, 3.0, 15.0, {"s": sample}, "cpu")
    assert ctl["colour_gap"] > 1e3 * r["colour_gap"]
    assert ctl["closure_ulp"] > 1e3 * r["closure_ulp"]


def test_judge_sees_an_unmoved_state():
    frame, m = _exact_frame()
    frame.x_c, frame.v_c = frame.x_p.clone(), frame.v_p.clone()
    r = judge(frame, m, 0.1, 3.0, 15.0, {}, "cpu")
    assert r["closure_ulp"] > 1e4
