"""Host milliseconds a rebuild spends in the global-worklist traversal:
the program's ``bh.rebuild.traverse`` span seconds over its ``bh.rebuild``
entries in the traced cycles.  Nothing to read where the program keeps no
spans or recorded no rebuild."""

from spatialsim_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "span_totals", dict)()
    rebuilds = spans.get("bh.rebuild", (0, 0.0))[0]
    if not rebuilds:
        return None
    return 1e3 * spans.get("bh.rebuild.traverse", (0, 0.0))[1] / rebuilds
