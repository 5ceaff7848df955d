"""Calls that make the host wait for the card, a list cycle: the
program's ``bh.sync`` entries over its ``bh.rebuild`` entries in the
traced cycles (plain substeps take none, so a new one on their path
shows).  Nothing to read where the program keeps no spans or recorded no
rebuild."""

from spatialsim_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "span_totals", dict)()
    rebuilds = spans.get("bh.rebuild", (0, 0.0))[0]
    if not rebuilds:
        return None
    return spans.get("bh.sync", (0, 0.0))[0] / rebuilds
