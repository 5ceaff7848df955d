"""``torch.cuda.max_memory_allocated()`` over set-up and window, GiB."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2.0 ** 30
