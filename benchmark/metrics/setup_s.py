"""From the start of the harness process to the window's start: writing the
fixture and the checkpoint, imports, loading the kernels, building the
trainer and the runner, round 0, and the rounds up to and including the
cell's ``check_round`` (the recorded one copies its captures to the
host)."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
