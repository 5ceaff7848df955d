"""Far-list entries a rebuild folds into their group's residual past the
per-group list cap (the traversal's and the finish's), from the program's
``bh.folded_entries`` counter over its ``bh.rebuild`` entries in the
traced cycles.  Nothing to read where the program keeps no spans or
recorded no rebuild."""

from spatialsim_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "span_totals", dict)()
    rebuilds = spans.get("bh.rebuild", (0, 0.0))[0]
    if not rebuilds:
        return None
    return profiling.counter_totals().get("bh.folded_entries", 0) / rebuilds
