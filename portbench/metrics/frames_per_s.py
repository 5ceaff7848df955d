"""Frames completed over the whole window's seconds (host clock), the
rebuild frames included."""


def read(run):
    if not run.frame_ms or run.window_s <= 0:
        return None
    return len(run.frame_ms) / run.window_s
