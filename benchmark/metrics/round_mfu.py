"""Model FLOPs of the window's rounds (``_flops.py``: training images forward
and backward, valid evaluation images forward, the text tower per step and
per evaluation batch) over the window's wall seconds times the bf16 dense
peak.  The window runs without the profiler, so its rounds take the time a
user's do."""

from ..peaks import FLOPS_PER_S
from ._flops import round_flops

LAYER = "model (models/clip_model.py, models/resnet_clip.py, adapters/lora.py, models/prompt_learner.py)"
UNIT = "%"
BETTER = "higher"
MOVES = "round_s"
SOURCE = "host_clock"


def read(run):
    flops = round_flops(run.config, run.traffic, run.rounds, run.batch_size)
    return 100.0 * flops / (run.window_s * FLOPS_PER_S["bf16"])
