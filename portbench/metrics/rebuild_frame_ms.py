"""Mean frame time of the window's frames in which the simulation's
``rebuilds`` counter rose."""


def read(run):
    ms = [t for t, r in zip(run.frame_ms, run.rebuilt) if r]
    if not ms:
        return None
    return sum(ms) / len(ms)
