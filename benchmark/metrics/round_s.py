"""The window's wall seconds over the whole rounds completed in it: what a
user pays for each of a run's rounds."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.window_s / run.n_rounds
