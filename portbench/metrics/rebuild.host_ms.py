"""Host milliseconds of a list rebuild: the program's ``bh.rebuild`` span
(``spatialsim_tpu_torch/ops/bh_window.py``, the whole re-sort and list
build of a substep), its seconds over its entries in the traced cycles,
the only cycles the profiler records.  Nothing to read where the program
keeps no spans or recorded no rebuild."""

from spatialsim_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "span_totals", dict)()
    rebuilds, seconds = spans.get("bh.rebuild", (0, 0.0))
    if not rebuilds:
        return None
    return 1e3 * seconds / rebuilds
