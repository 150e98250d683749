"""Host seconds inside ``resolve_round`` and ``parallel_eval`` per round
(the round's one blocking fetch and the evaluator's numpy metrics; harness
spans), over the window's rounds."""

LAYER = "round driver (fed/parallel_driver.py, federated_main.py)"
UNIT = "s/round"
BETTER = "lower"
MOVES = "round_s"
SOURCE = "host_clock"


def read(run):
    return sum(r["fetch_s"] + r["eval_s"] for r in run.rounds) / len(run.rounds)
