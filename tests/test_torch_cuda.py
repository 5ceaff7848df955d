"""CUDA kernels of the PyTorch port against their plain versions, on the
card.  Marked ``cuda``: they skip without a GPU.  This file imports no
jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from spatialsim_tpu import distributions

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
