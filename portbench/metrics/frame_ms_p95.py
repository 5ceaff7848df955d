"""95th percentile of the window's frame times (device events: from the
previous frame's end mark to the frame's own, so a host stall that idles
the card lands in the frame that waited), interpolated linearly between
order statistics."""


def percentile(values, q):
    """The ``q``-th percentile of ``values``, linear between the closest
    ranks (numpy's default)."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def read(run):
    if not run.frame_ms:
        return None
    return percentile(run.frame_ms, 95.0)
