"""Wall seconds of round 0, from its ``run_round`` to the return of its
flush: every train and test NPZ decoded into the device caches, every
client trained once, the first evaluation (the host data path's outside
view)."""

LAYER = "host data path (data/manager.py, data/datasets/fairfedmed.py, native/, the runner's device caches)"
UNIT = "s"
BETTER = "lower"
MOVES = "setup_s"
SOURCE = "host_clock"


def read(run):
    return run.round0_s
