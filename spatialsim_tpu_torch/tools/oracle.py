"""The direct-sum force oracle of the accuracy tools, on kernel 1's
targets-and-sources mode (port of ``scripts/nbody_error_scan.py``'s
``exact_accel_at`` and ``report`` and ``scripts/staleness_scan.py``'s
``err_stats``), and the measurement of that mode on the card.

    python -m spatialsim_tpu_torch.tools.oracle               # the card
    python -m spatialsim_tpu_torch.tools.oracle --device cpu --sources 3000

The measurement prints the card's name and power limit, then one JSON
line per source count: the mode at ``--targets`` sampled bodies against
its plain version in float32 (max|da|, max|da|/max|a|; on the first
``--check64`` targets against a float64 plain sum too), whether two calls
agree bit for bit, CUDA-event ms beside the plain chunked oracle's ms and
the bound (19 FP32 operations a pair over k x N pairs, or the bytes);
then the ring's hop sums at ``--ring`` bodies on one card (D = 1, 2, 4, 8
blocks: every rank's D hops, plain chunks against the mode); then kernel
1's single-array launch at the ring's size.  ``--plain-max`` caps the
source count above which the float32 plain version runs on
``--check64`` targets only.  The sources are a seeded Plummer sphere made
on the device.

The helpers the other tools share live here too: :func:`device_of` (the
card unless ``--device cpu``; without a card a tool exits 1),
:func:`initial_conditions`, :func:`sample_ids` and
:func:`add_bodies`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from spatialsim_tpu_torch import distributions
from spatialsim_tpu_torch.ops.allpairs import (
    allpairs_accel, allpairs_accel_at, allpairs_at_plan,
    allpairs_at_reference, allpairs_at_slices)
from spatialsim_tpu_torch.tools.eval_ab import _sync, device_line, time_ms

# H100 SXM peaks (NVIDIA data sheet, 700 W): FP32 outside the tensor
# cores, HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_PAIR = 19.0    # as kernel 1 counts them (FMA as 2, one rsqrt)
G, SOFTENING, RADIUS = 0.1, 2.0, 500.0   # the 1M galaxy's G and softening


def device_of(name: str, tool: str) -> torch.device:
    """``torch.device(name)``; a CUDA device without a card exits 1 (only
    ``--device cpu`` runs on the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"{tool}: device {name!r} requested but "
              f"torch.cuda.is_available() is False; pass --device cpu",
              file=sys.stderr)
        raise SystemExit(1)
    return dev


def add_bodies(ap, default: int) -> None:
    """The body count of a tool: the positional ``n`` (the script's), or
    ``--bodies``, which wins; read it with :func:`bodies_of`."""
    ap.add_argument("n", type=lambda x: int(float(x)), nargs="?",
                    default=default)
    ap.add_argument("--bodies", type=lambda x: int(float(x)), default=None,
                    help=f"body count (default {default:,}; as n)")


def bodies_of(args) -> int:
    return args.n if args.bodies is None else args.bodies


def initial_conditions(distribution, n, radius, G, device, seed=0):
    """(pos, vel, mass) of ``distributions.generate_distribution`` on
    ``device``: ``(3, n)`` float32 and ``(n,)``."""
    p, v, m = distributions.generate_distribution(distribution, n, radius, G,
                                                  seed=seed)
    out = tuple(torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                device=device) for a in (p.T, v.T, m))
    del p, v, m
    return out


def sample_ids(n: int, k: int, seed: int = 1) -> np.ndarray:
    """The scripts' sample: ``k`` sorted distinct body ids of ``n`` from
    ``default_rng(seed)``."""
    return np.sort(np.random.default_rng(seed).choice(n, k, replace=False))


def exact_accel_at(targets, pos, mass, G, softening):
    """Direct-sum accelerations at ``targets`` ``(3, k)`` from all the
    bodies ``pos`` ``(3, N)``, ``mass`` ``(N,)``: float32 ``(3, k)``
    through :func:`allpairs_accel_at` (the kernel on a card, its plain
    version on the CPU).  The scripts take ``soft_sq``; this takes the
    softening, as every caller holds it."""
    return allpairs_accel_at(targets.contiguous(), pos.contiguous(),
                             mass.contiguous(), G, softening)


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float64)


def relative_errors(acc, exact) -> np.ndarray:
    """|da| / |a| per body (float64), |a| floored at 1e-12."""
    a, e = _np64(acc), _np64(exact)
    mag = np.linalg.norm(e, axis=0)
    return np.linalg.norm(a - e, axis=0) / np.maximum(mag, 1e-12)


def err_stats(acc, exact, idx):
    """(median, p99, rms) of |da|/|a| at ``idx`` of ``acc``, rounded to 5
    places (``scripts/staleness_scan.py``)."""
    if isinstance(acc, torch.Tensor):
        idx = torch.as_tensor(idx, device=acc.device)
    err = relative_errors(acc[:, idx], exact)
    return (round(float(np.median(err)), 5),
            round(float(np.percentile(err, 99)), 5),
            round(float(np.sqrt((err ** 2).mean())), 5))


def report(tag, acc_idx, exact, t_build=None, out=print):
    """Print (and return) ``scripts/nbody_error_scan.py``'s JSON line:
    median, p99 and rms of |da|/|a|, and the build's ms when given."""
    err = relative_errors(acc_idx, exact)
    rec = {"cfg": tag,
           "median": round(float(np.median(err)), 5),
           "p99": round(float(np.percentile(err, 99)), 5),
           "rms": round(float(np.sqrt((err ** 2).mean())), 5)}
    if t_build is not None:
        rec["build_ms"] = round(t_build * 1000)
    out(json.dumps(rec), flush=True)
    return rec


def bound_ms(k: int, n: int) -> tuple:
    """(ms, "operations" or "bytes") the card needs at least for the
    mode's k x n pairs: targets, sources and masses read once, the
    accelerations written once."""
    t_ops = OPS_PER_PAIR * k * n / PEAK_FP32 * 1e3
    t_bytes = 4 * (6 * k + 4 * n) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def plummer(n, device, seed=0, radius=RADIUS):
    """A seeded Plummer sphere of ``n`` equal-mass bodies, made on
    ``device``: ``(3, n)`` float32 positions, ``(n,)`` masses of 1/n."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(n, generator=gen, device=device).clamp_(1e-6, 0.999)
    r = radius / 4 / torch.sqrt(u.pow(-2.0 / 3.0) - 1.0)
    d = torch.randn((3, n), generator=gen, device=device)
    pos = (d / d.norm(dim=0).clamp(min=1e-12) * r).contiguous()
    return pos, torch.full((n,), 1.0 / n, device=device)


def _host_ms(fn, device, reps=1):
    """Host milliseconds of ``reps`` calls, synchronised (the plain
    version launches many kernels)."""
    _sync(device)
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t) * 1e3 / reps


def measure_mode(n, k, device, check64=64, plain_max=10_000_000, reps=5,
                 out=print):
    """The targets-and-sources mode at ``k`` sampled bodies of an
    ``n``-body Plummer sphere: error against the plain version (float32
    on every target up to ``plain_max`` sources, else on ``check64``;
    float64 on ``check64``), bit-equality of two calls, ms, the plain
    chunked oracle's ms and the bound.  Returns the JSON record."""
    pos, mass = plummer(n, device)
    idx = torch.as_tensor(sample_ids(n, k), device=device)
    tgt = pos[:, idx].contiguous()
    launched = allpairs_accel_at.launches
    got = exact_accel_at(tgt, pos, mass, G, SOFTENING)
    again = exact_accel_at(tgt, pos, mass, G, SOFTENING)
    _sync(device)
    plain_k = k if n <= plain_max else min(check64, k)
    _sync(device)
    t = time.perf_counter()
    want = allpairs_at_reference(tgt[:, :plain_k], pos, mass, G, SOFTENING)
    _sync(device)
    plain = (time.perf_counter() - t) * 1e3
    d = float((got[:, :plain_k] - want).abs().max())
    rel = d / float(want.abs().max())
    c = min(check64, k)
    w64 = allpairs_at_reference(tgt[:, :c].double(), pos.double(),
                                mass.double(), G, SOFTENING)
    rel64 = float((got[:, :c].double() - w64).abs().max()
                  / w64.abs().max())
    del w64, want
    ms = time_ms(lambda: exact_accel_at(tgt, pos, mass, G, SOFTENING), reps,
                 device)
    b_ms, b_by = bound_ms(k, n)
    threads, T, per = allpairs_at_plan(k, n)
    slices = allpairs_at_slices(n, per)
    rec = {"mode": "allpairs_at", "targets": k, "sources": n,
           "threads": threads, "T": T, "tiles_per_slice": per,
           "slices": slices, "max_abs_err": d, "rel_err": rel,
           "rel_err_targets": plain_k, "rel_err_f64": rel64,
           "f64_targets": c, "bit_equal": bool(torch.equal(got, again)),
           "ms": ms, "plain_ms": plain * k / plain_k,
           "plain_targets_timed": plain_k, "bound_ms": b_ms,
           "bound_by": b_by, "bound_share": b_ms / ms,
           "launches": allpairs_accel_at.launches - launched,
           "device": device.type}
    out(json.dumps(rec), flush=True)
    return rec


def ring_hops(n, device, shards=(1, 2, 4, 8), reps=3, out=print):
    """The ring's hop sums at ``n`` bodies on one device, as
    ``parallel/sharded.py`` runs them on D ranks: rank r's targets (block
    r) against the visiting block of every hop, D x D calls of the mode,
    beside the same hops in plain chunks; the assembled accelerations
    against each other.  Returns the JSON records."""
    pos, mass = plummer(n, device, seed=1)
    recs = []
    for D in shards:
        nl = n // D
        blocks = [(pos[:, r * nl:(r + 1) * nl].contiguous(),
                   mass[r * nl:(r + 1) * nl].contiguous()) for r in range(D)]

        def hops(fn):
            acc = []
            for r in range(D):
                a = torch.zeros_like(blocks[r][0])
                for h in range(D):
                    src = blocks[(r - h) % D]
                    a = a + fn(blocks[r][0], src[0], src[1], G, SOFTENING)
                acc.append(a)
            return torch.cat(acc, 1)
        got = hops(allpairs_accel_at)
        want = hops(allpairs_at_reference)
        d = float((got - want).abs().max())
        ms = time_ms(lambda: hops(allpairs_accel_at), reps, device)
        plain = _host_ms(lambda: hops(allpairs_at_reference), device)
        b_ms, b_by = bound_ms(nl, nl)
        rec = {"mode": "ring_hops", "bodies": n, "D": D, "hops": D * D,
               "ms": ms, "plain_ms": plain, "max_abs_err": d,
               "rel_err": d / float(want.abs().max()),
               "bound_ms": b_ms * D * D, "bound_by": b_by,
               "device": device.type}
        out(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def single_array(n, device, reps=20, out=print):
    """Kernel 1's single-array launch (``allpairs_accel``) at ``n``."""
    pos, mass = plummer(n, device, seed=1)
    ms = time_ms(lambda: allpairs_accel(pos, mass, G, SOFTENING), reps,
                 device)
    rec = {"mode": "allpairs", "bodies": n, "ms": ms,
           "bound_ms": bound_ms(n, n)[0], "device": device.type}
    out(json.dumps(rec), flush=True)
    return rec


def _counts(text: str) -> list:
    return [int(float(x)) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--targets", type=int, default=4096)
    ap.add_argument("--sources", default="1048576,10000000,50000000",
                    help="comma-separated source counts")
    ap.add_argument("--check64", type=int, default=64)
    ap.add_argument("--plain-max", type=float, default=5e7)
    ap.add_argument("--ring", type=int, default=32_768,
                    help="bodies of the ring's hops (0: none)")
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args(argv)
    dev = device_of(a.device, "oracle")
    print(device_line(dev), flush=True)
    for n in _counts(a.sources):
        measure_mode(n, min(a.targets, n), dev, a.check64, a.plain_max,
                     a.reps)
    if a.ring:
        ring_hops(a.ring, dev)
        single_array(a.ring, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
