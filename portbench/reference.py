"""The plain reference that judges a recorded frame.  Plain PyTorch in
float64 (float32 nowhere, so no TF32 either); it imports nothing of the
program and takes nothing that the program made but the outputs it judges.

A recorded frame is ``substeps`` kick-damp-drift substeps,

    v <- (v + a dt) * damping,    x <- x + v dt,

with ``a = G sum_j m_j d_ij (|d_ij|^2 + eps^2)^-3/2`` over every other
body (``d_ij = x_j - x_i``; coincident bodies add nothing), then a copy of
the positions and the velocity colours.  A frame C is judged from the
state before it, P (positions and velocities in original body order),
and what the program reports after it: the captured positions and
colours, the velocities, and the accelerations of its last substep (the
state's ``acc``).  From these the reference works out

* ``colour_gap``: the largest gap, over every body and channel, between a
  captured colour and the velocity colour of the body's velocity;
* ``closure_ulp``: the largest gap, over every body and component, by
  which the frame departs from the substeps above, in float32 units in
  the last place of the largest term (for one substep the velocity and
  the position update; for two, the drift of the first substep, whose
  velocity and position the second one's kick and drift give back);
* ``force``: for a sample of bodies, the rms and the median of ``|a -
  a_ref| / |a_ref|`` against a float64 direct sum over every body at the
  positions the accelerations were taken at, for each substep whose
  accelerations the frame gives (the last one's from the state; for two
  substeps the first one's from its kick), and the share of the squared
  sum that the worst 1% of the sample carry.

The control (:func:`control_frame`) is this reference put in the
program's place in bfloat16, its sums pair by pair
(:func:`pairwise_sum`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

F64 = torch.float64
EPS32 = 2.0 ** -23            # float32 unit in the last place at 1.0
# Sources a block of the direct sum: 4,096 targets x 8,192 sources keep
# each float64 temporary at 256 MiB.
SOURCE_BLOCK = 8192


@dataclass
class Frame:
    """A frame to judge, rows in original body order, ``(rows, 3)``.

    ``rows`` None means every body; otherwise the rows are those bodies
    (the control's sample) and ``sources_p`` / ``sources_y`` give every
    body's positions at the substeps' evaluations."""

    x_p: torch.Tensor
    v_p: torch.Tensor
    x_c: torch.Tensor
    v_c: torch.Tensor
    col_c: torch.Tensor
    acc: torch.Tensor
    substeps: int
    dt: float
    damping: float
    col_p: Optional[torch.Tensor] = None
    tau: int = 0
    rows: Optional[torch.Tensor] = None
    sources_p: Optional[torch.Tensor] = None
    sources_y: Optional[torch.Tensor] = None

    def to(self, device, dtype=F64) -> "Frame":
        moved = {k: (getattr(self, k).to(device, dtype)
                     if getattr(self, k) is not None else None)
                 for k in ("x_p", "v_p", "x_c", "v_c", "col_c", "acc",
                           "col_p", "sources_p", "sources_y")}
        rows = None if self.rows is None else self.rows.to(device)
        return replace(self, rows=rows, **moved)


def colours(vel: torch.Tensor, max_speed: float) -> torch.Tensor:
    """``(n, 3)`` velocities -> ``(n, 3)`` RGB: the recorder's 7-band
    blue -> white -> red gradient on ``t = min(|v| / max_speed, 1)``."""
    t = torch.clamp(torch.sqrt((vel * vel).sum(1)) / max_speed, max=1.0)
    bands = [0.15, 0.30, 0.45, 0.55, 0.90, 0.95, 0.99]
    s0, s1 = t / 0.15, (t - 0.15) / 0.15
    sa = (t - 0.30) / 0.25
    s2, s3 = sa / 0.6, (sa - 0.6) / 0.4
    s4, s5, s6 = (t - 0.90) / 0.05, (t - 0.95) / 0.04, (t - 0.99) / 0.01
    one = torch.ones_like(t)
    zero = torch.zeros_like(t)
    rgb = (
        [0.4 - 0.2 * s0, 0.2 + 0.1 * s1, 0.3 - 0.1 * s2, 0.2 + 0.8 * s3,
         one, one, one, one],
        [0.2 + 0.2 * s0, 0.4 + 0.1 * s1, 0.5 + 0.3 * s2, 0.8 + 0.2 * s3,
         one, 1.0 - 0.05 * s4, 0.95 - 0.45 * s5, 0.5 - 0.5 * s6],
        [0.8 + 0.1 * s0, 0.9 + 0.05 * s1, 0.95 + 0.05 * s2, one, one,
         1.0 - s4, zero, zero],
    )
    band = torch.bucketize(t, torch.tensor(bands, dtype=t.dtype,
                                           device=t.device), right=True)
    out = []
    for values in rgb:
        table = torch.stack([v if torch.is_tensor(v) else one * v
                             for v in values])          # (8, n)
        out.append(table.gather(0, band[None]).squeeze(0))
    return torch.stack(out, dim=1)


def direct_sum(targets, sources, masses, G, softening,
               block=SOURCE_BLOCK):
    """``(k, 3)`` accelerations at ``targets`` from every body of
    ``sources`` ``(n, 3)`` with ``masses`` ``(n,)``, in the dtype given,
    summed source block by source block.  Per block, ``|d|^2 = |t|^2 +
    |s|^2 - 2 t.s`` and ``sum_j w_j d_j = sum_j w_j s_j - t sum_j w_j``:
    two matrix products in place of three difference tensors.  A body's
    own pair (or a coincident one) adds ``w (s - t) = 0`` whatever ``w``
    is, up to the rounding of the two sums."""
    eps_sq = float(softening) ** 2
    tt = (targets * targets).sum(1, keepdim=True)
    acc = torch.zeros_like(targets)
    wsum = torch.zeros_like(tt)
    for j0 in range(0, sources.shape[0], block):
        s = sources[j0:j0 + block]
        w = torch.addmm(tt + (s * s).sum(1)[None, :], targets, s.T,
                        alpha=-2.0)
        w.clamp_(min=0.0).add_(eps_sq).rsqrt_().pow_(3)
        w.mul_(masses[j0:j0 + block])
        acc.addmm_(w, s)
        wsum += w.sum(1, keepdim=True)
    return (acc - targets * wsum) * G


def pairwise_sum(targets, sources, masses, G, softening,
                 block=SOURCE_BLOCK):
    """:func:`direct_sum` pair by pair, from the differences ``d = s - t``
    (a coincident body adds nothing): the control's form, since in a low
    precision the expansion of ``|d|^2`` would cancel."""
    eps_sq = float(softening) ** 2
    tx, ty, tz = (targets[:, i, None] for i in range(3))
    acc = torch.zeros_like(targets)
    for j0 in range(0, sources.shape[0], block):
        s = sources[j0:j0 + block]
        dx, dy, dz = s[:, 0] - tx, s[:, 1] - ty, s[:, 2] - tz
        r2 = dx * dx + dy * dy + dz * dz
        inv = torch.rsqrt(r2 + eps_sq)
        w = torch.where(r2 > 0, masses[j0:j0 + block] * (inv * inv * inv),
                        torch.zeros_like(r2))
        acc[:, 0] += (w * dx).sum(1)
        acc[:, 1] += (w * dy).sum(1)
        acc[:, 2] += (w * dz).sum(1)
    return acc * G


def _ulps(gap, *terms):
    """Elementwise ``gap`` in float32 units in the last place of the
    largest of ``terms``; its largest value."""
    scale = torch.stack([t.abs() for t in terms]).amax(0)
    return float((gap.abs() / (EPS32 * scale.clamp(min=1e-30))).max())


def _rel(acc, ref):
    """(rms, median, share of the squared sum in the worst 1%) of
    ``|acc - ref| / |ref|`` over the rows."""
    rel = (acc - ref).norm(dim=1) / ref.norm(dim=1)
    sq = (rel * rel).sort(descending=True).values
    top = max(1, sq.shape[0] // 100)
    return (float(torch.sqrt(sq.mean())), float(rel.median()),
            float(sq[:top].sum() / sq.sum().clamp(min=1e-300)))


def judge(frame: Frame, masses, G, softening, max_speed, samples: dict,
          device) -> dict:
    """Readings of one frame, in float64 on ``device``: ``colour_gap``,
    ``closure_ulp`` (None past two substeps) and, for each named sample
    of bodies in ``samples``, ``force[name]``: the ``rms``, ``median`` and
    ``tail1`` of the force error, one a substep the frame gives (the
    first substep's first)."""
    f = frame.to(device)
    masses = masses.to(device, F64)
    dt, d = f.dt, f.damping
    col_gap = (f.col_c - colours(f.v_c, max_speed)).abs().max()
    if f.col_p is not None:
        col_gap = torch.maximum(
            col_gap, (f.col_p - colours(f.v_p, max_speed)).abs().max())
    y = f.x_c - f.v_c * dt               # positions at the last kick
    v_last = f.v_c / d - f.acc * dt      # velocities before it
    closure, evals = None, []
    if f.substeps == 1:
        closure = max(_ulps(y - f.x_p, f.x_p, f.x_c, f.v_c * dt),
                      _ulps(v_last - f.v_p, f.v_p, f.v_c, f.acc * dt))
        evals.append((f.acc, f.x_p, f.sources_p))
    else:
        if f.substeps == 2:
            closure = _ulps(y - f.x_p - v_last * dt, f.x_p, f.x_c, y,
                            v_last * dt)
            evals.append(((v_last / d - f.v_p) / dt, f.x_p, f.sources_p))
        evals.append((f.acc, y, f.sources_y))
    rows = (torch.arange(f.x_p.shape[0], device=device)
            if f.rows is None else f.rows)
    force = {}
    for name, sample in samples.items():
        pick = _pick(rows, sample.to(device))
        got = [_rel(acc[pick], direct_sum(at[pick], at if src is None
                                          else src, masses, G, softening))
               for acc, at, src in evals]
        force[name] = {k: [g[i] for g in got]
                       for i, k in enumerate(("rms", "median", "tail1"))}
    return {"colour_gap": float(col_gap), "closure_ulp": closure,
            "force": force, "tau": f.tau}


def _pick(rows, sample):
    """Indices into ``rows`` of the sampled bodies that ``rows`` holds."""
    if rows.shape[0] == sample.shape[0] and torch.equal(rows, sample):
        return torch.arange(rows.shape[0], device=rows.device)
    where = torch.full((int(max(rows.max(), sample.max())) + 1,), -1,
                       dtype=torch.int64, device=rows.device)
    where[rows] = torch.arange(rows.shape[0], device=rows.device)
    got = where[sample]
    return got[got >= 0]


def control_frame(frame: Frame, masses, G, softening, max_speed, sample,
                  device, dtype=torch.bfloat16) -> Frame:
    """The reference in the program's place in ``dtype``: frame C of the
    sampled bodies from the program's state P, each substep's direct sum,
    kick, drift and the colours computed and stored in ``dtype``.  For two
    substeps the second one's sources are the program's positions at its
    kick.  Returns the frame to :func:`judge` (rows: the sample)."""
    f = frame.to(device)
    sample = sample.to(device)
    masses_d = masses.to(device, dtype)
    lo = lambda t: t.to(dtype)                               # noqa: E731
    x, v = lo(f.x_p[sample]), lo(f.v_p[sample])
    sources_p = lo(f.x_p)
    y_prog = f.x_c - f.v_c * f.dt
    acc = None
    for k in range(f.substeps):
        src = sources_p if k == 0 else lo(y_prog)
        acc = pairwise_sum(x, src, masses_d, G, softening)
        v = lo((v + acc * f.dt) * f.damping)
        x = lo(x + v * f.dt)
    col = lo(colours(v, max_speed))
    return Frame(x_p=f.x_p[sample], v_p=f.v_p[sample], x_c=x, v_c=v,
                 col_c=col, acc=acc, substeps=f.substeps, dt=f.dt,
                 damping=f.damping, tau=f.tau, rows=sample,
                 sources_p=f.x_p, sources_y=y_prog)
