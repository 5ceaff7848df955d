"""The median over the sampled bodies of |a - a_ref| / |a_ref|, percent,
at the point ``accel_err_rms_pct`` reads: a statistic that a few bodies
far off move less."""


def read(run):
    r = run.readings.get("stale")
    if not r or "fixed" not in r["force"]:
        return None
    return 100.0 * r["force"]["fixed"]["median"][-1]
