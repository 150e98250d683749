"""From the start of the harness process to the window's start: writing the
fixture and the checkpoint, imports, loading the kernels, building the
trainer and the runner, and round 0."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
