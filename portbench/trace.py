"""Reduction of a ``torch.profiler`` trace of the traced frames to what
the per-layer metrics read: device busy time (the union of every kernel,
copy and set on the card), device time by operation, and the idle gaps
named by what the host was doing in them.

A host span is the innermost CPU range at a gap's midpoint: the
benchmark's own ``frame.step`` / ``frame.capture`` / ``frame.wait`` and,
inside them, the PyTorch operation running then.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

SPANS = ("frame.step", "frame.capture", "frame.wait")


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: list            # [[name, seconds], ...] by total time
    idle_gaps: list             # [[host span, seconds], ...] by total time
    op_seconds: dict = field(default_factory=dict)   # name -> seconds
    op_counts: dict = field(default_factory=dict)    # name -> launches


def _union(intervals):
    """(total length, merged intervals) of ``intervals``."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _innermost(ranges, starts, mid, reach=4096):
    """Name of the range of ``ranges`` (sorted by start) that holds
    ``mid`` and starts last, looking back at most ``reach`` ranges."""
    i = bisect.bisect_right(starts, mid)
    for j in range(i - 1, max(i - 1 - reach, -1), -1):
        if ranges[j][1] >= mid:
            return ranges[j][2]
    return None


def _host_name(spans, span_starts, ops, op_starts, mid):
    """What the host was doing at ``mid``: the benchmark span and the
    innermost PyTorch operation running then."""
    names = [n for n in (_innermost(spans, span_starts, mid),
                         _innermost(ops, op_starts, mid)) if n]
    return " > ".join(names) if names else "none"


def summarize(events, window_s: float, top: int = 10) -> TraceSummary:
    """``events``: ``prof.events()`` of the traced frames."""
    from torch.autograd import DeviceType
    dev, spans, ops = [], [], []
    by_name, counts = {}, {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name in SPANS:      # a host range drawn on the device
                continue
            dev.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) * 1e-6
            counts[e.name] = counts.get(e.name, 0) + 1
        elif e.device_type == DeviceType.CPU and b > a:
            (spans if e.name in SPANS else ops).append((a, b, e.name))
    busy_us, merged = _union(dev)
    spans.sort()
    ops.sort()
    span_starts = [c[0] for c in spans]
    op_starts = [c[0] for c in ops]
    gaps = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        name = _host_name(spans, span_starts, ops, op_starts,
                          0.5 * (e0 + s1))
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(
        busy_s=busy_us * 1e-6, window_s=window_s,
        device_ops=[[n[:120], s] for n, s in top_ops],
        idle_gaps=[[n[:120], s] for n, s in idle],
        op_seconds=by_name, op_counts=counts)
