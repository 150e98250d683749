"""Host seconds inside ``ParallelRoundRunner.run_round`` per round (the
harness's span around the call), over the window's rounds."""

LAYER = "round driver (fed/parallel_driver.py, federated_main.py)"
UNIT = "s/round"
BETTER = "lower"
MOVES = "round_s"
SOURCE = "host_clock"


def read(run):
    return sum(r["dispatch_s"] for r in run.rounds) / len(run.rounds)
