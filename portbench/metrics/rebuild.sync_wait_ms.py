"""Host milliseconds a list cycle waits on the card: the program's
``bh.sync`` spans (every call on the step's path that makes the host wait
for the card) seconds over the ``bh.rebuild`` entries in the traced
cycles.  Nothing to read where the program keeps no spans or recorded no
rebuild."""

from spatialsim_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "span_totals", dict)()
    rebuilds = spans.get("bh.rebuild", (0, 0.0))[0]
    if not rebuilds:
        return None
    return 1e3 * spans.get("bh.sync", (0, 0.0))[1] / rebuilds
