"""The simulation's calibration on the initial conditions
(``NBodySimulation.setup_seconds["calibration"]``, host seconds after a
device synchronisation)."""


def read(run):
    return run.setup_seconds.get("calibration")
