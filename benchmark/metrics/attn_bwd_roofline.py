"""The attention backward kernels' share of their roofline over the traced
rounds (``_attention.py``)."""

from ._attention import roofline_share

LAYER = "kernels (ops/attention.py, csrc/attention_fwd.cu, csrc/attention_bwd.cu)"
UNIT = "%"
BETTER = "higher"
MOVES = "round_s"
SOURCE = "device_trace"


def read(run):
    return roofline_share(run, "bwd")
