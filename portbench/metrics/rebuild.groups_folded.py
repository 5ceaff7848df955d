"""Groups a rebuild folds whole into one residual entry because the tile
pool's capacity has no room for their lists, from the program's
``bh.groups_folded`` counter over its ``bh.rebuild`` entries in the
traced cycles.  Nothing to read where the program keeps no spans or
recorded no rebuild."""

from spatialsim_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "span_totals", dict)()
    rebuilds = spans.get("bh.rebuild", (0, 0.0))[0]
    if not rebuilds:
        return None
    return profiling.counter_totals().get("bh.groups_folded", 0) / rebuilds
