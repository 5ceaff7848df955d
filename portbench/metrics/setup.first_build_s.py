"""The simulation's first list build
(``NBodySimulation.setup_seconds["first_build"]``)."""


def read(run):
    return run.setup_seconds.get("first_build")
