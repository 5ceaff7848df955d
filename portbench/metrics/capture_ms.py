"""Mean device milliseconds a frame of the capture: from the event before
the benchmark's capture call to the one after it (the gather to original
order, the colours, the transposes and the copies to the host)."""


def read(run):
    if not run.capture_ms:
        return None
    return sum(run.capture_ms) / len(run.capture_ms)
