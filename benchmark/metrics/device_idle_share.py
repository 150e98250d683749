"""Share of a round's wall time in which no operation runs on the card:
1 - (device-busy seconds per traced round) / ``round_s``.  The busy seconds
are the union of the device operations' intervals in the traced rounds,
from the trace's timeline (overlapping operations count once); the round's
wall time is the untraced window's, since the profiler about doubles a
round's host time and leaves its device time as it is."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "round_s"
SOURCE = "device_trace"


def read(run):
    busy_per_round = run.trace.busy_s / len(run.traced_rounds)
    return 100.0 * (1.0 - busy_per_round * run.n_rounds / run.window_s)
