"""Method trainers; importing this package registers them."""

from .glp_ot import GLP_OT_SVLoRA  # noqa: F401
from .promptfl import CLIP, Baseline, PromptFL  # noqa: F401
