"""Force error at the stalest frame of the warm-up's second list cycle:
the rms over 4,096 bodies (the same in every run) of |a - a_ref| /
|a_ref|, in percent, of the program's accelerations of the frame's last
substep against the reference's float64 direct sum at the same
positions."""


def read(run):
    r = run.readings.get("stale")
    if not r or "fixed" not in r["force"]:
        return None
    return 100.0 * r["force"]["fixed"]["rms"][-1]
