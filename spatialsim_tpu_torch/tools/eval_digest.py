"""Digests of the dense window kernels' outputs, to hold two versions of
the kernels equal bit for bit on one card.

    python -m spatialsim_tpu_torch.tools.eval_digest --out a.json
    python -m spatialsim_tpu_torch.tools.eval_digest --out b.json \\
        --compare a.json

Inputs (seed 0): 1,024 groups of 256 bodies along a random walk, dense far
lists of cap 512 whose counts run from 0 to the cap (the slots past them
zero), and for K = 8 a near table with empty (-1) and out-of-range ids.
Every instance of the row kernel (R 8, 10, 13, 16; T 1, 2, 4), of the
column kernel (R 8, 10; T 1, 2, 4) and of the matrix kernel (R 8, 10; the
register tile at T 1, 2, 4 and the tensor-core contraction at M 2, 4), at
K 0 and 8, in group order and heavy groups first, at steps_since 23, on
the whole state (the launch arguments every version of the wrappers
takes).  Each output's SHA-256 and float64 sum go to ``--out`` as JSON;
``--compare`` prints how many digests equal another file's and fails on
any that differs.  Run both versions in one machine, each from its own
checkout.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

from spatialsim_tpu_torch.ops import bh_eval_kernel as ek

NG, GSZ, L, WG, DT, STEPS = 1024, 256, 512, 2, 0.02, 23


def inputs(R, K, device, seed=0):
    """(s_pos, s_mass, far, far_n, near) of the digest's lists."""
    rng = np.random.default_rng(seed + 10 * R + K)
    npad = NG * GSZ
    centre = np.cumsum(rng.normal(size=(3, NG)) * 5.0, axis=1)
    pos = np.repeat(centre, GSZ, axis=1) + rng.normal(size=(3, npad)) * 3.0
    mass = rng.uniform(0.5, 2.0, npad)
    far_n = rng.integers(0, L + 1, NG)
    slot = np.arange(L)[None, :] < far_n[:, None]
    u = rng.normal(size=(3, NG, L))
    u *= rng.uniform(50.0, 300.0, (1, NG, L)) / np.linalg.norm(u, axis=0)
    rows = [centre[:, :, None] + u, rng.normal(size=(3, NG, L)),
            rng.uniform(0.5, 50.0, (1, NG, L))]
    if R in (13, 16):
        rows.append(rng.normal(size=(6, NG, L)) * 25.0 * rows[2])
    if R in (10, 16):
        rows.append(rng.normal(size=(3, NG, L)) * 0.1)
    far = np.zeros((NG, R, L))
    vals = np.concatenate(rows, axis=0).transpose(1, 0, 2)
    far[:, :vals.shape[1]] = vals * slot[:, None, :]
    near = None
    if K:
        g = np.arange(NG)[:, None]
        near = (g + rng.integers(3, NG - 3, (NG, K))) % NG
        near[rng.random((NG, K)) < 0.1] = -1
        near[rng.random((NG, K)) < 0.02] = NG + 5

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    return (t(pos, torch.float32), t(mass, torch.float32),
            t(far, torch.float32), t(far_n, torch.int32),
            None if near is None else t(near, torch.int32))


def runs(device):
    """name -> output of every instance on the digest's inputs."""
    kw = dict(G=0.1, softening=2.0, group_size=GSZ, window_groups=WG,
              tau_clamp=24.0)
    out = {}
    for R in (8, 10, 13, 16):
        for K in (0, 8):
            args = inputs(R, K, device) + (STEPS, DT)
            heavy = ek.heavy_first(args[3], args[4], GSZ)
            tiles = ek.heavy_first(args[3], args[4], GSZ, (L, 128))
            for order, tag in ((None, "group"), (heavy, "heavy")):
                for T in (1, 2, 4):
                    out[f"row R={R} K={K} T={T} {tag}"] = ek.dense_launch(
                        *args, targets=T, order=order, **kw)
            if R not in (8, 10):
                continue
            for order, tag in ((None, "group"), (tiles, "heavy")):
                for T in (1, 2, 4):
                    out[f"cols R={R} K={K} T={T} {tag}"] = ek.cols_launch(
                        *args, targets=T, order=order, far_tile=128, **kw)
                for contraction, ns in ek.MXU_CONTRACTIONS.items():
                    for n in ns:
                        out[f"mxu R={R} K={K} {contraction} {n} {tag}"] = \
                            ek.mxu_launch(*args, targets=n, order=order,
                                          contraction=contraction,
                                          far_tile=128, **kw)
    return out


def digest(t):
    a = t.detach().cpu().contiguous().numpy()
    return {"sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "sum": float(a.astype(np.float64).sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--compare")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("eval_digest: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    got = {k: digest(v) for k, v in runs(torch.device("cuda")).items()}
    torch.cuda.synchronize()
    with open(args.out, "w") as f:
        json.dump(got, f, indent=1, sort_keys=True)
    print(f"eval_digest: {len(got)} outputs -> {args.out}")
    if not args.compare:
        return 0
    with open(args.compare) as f:
        want = json.load(f)
    same = [k for k in got if want.get(k, {}).get("sha256")
            == got[k]["sha256"]]
    diff = sorted(set(got) - set(same))
    print(f"eval_digest: {len(same)} of {len(got)} outputs equal bit for bit "
          f"to {args.compare}")
    for k in diff:
        print(f"    differs: {k}: sum {got[k]['sum']!r} against "
              f"{want.get(k, {}).get('sum')!r}")
    return 1 if diff else 0


if __name__ == "__main__":
    sys.exit(main())
