"""The rotary head-split kernels' share of their roofline over the traced
rounds, forward and backward together (``_rope.py``)."""

from ._rope import roofline_share

LAYER = "rotary head split (ops/rope.py, csrc/rope_qkv.cu)"
UNIT = "%"
BETTER = "higher"
MOVES = "round_s"
SOURCE = "device_trace"


def read(run):
    return roofline_share(run)
