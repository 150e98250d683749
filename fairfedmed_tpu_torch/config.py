"""Hierarchical configuration system (yacs-compatible subset).

The port's own copy of ``fairfedmed_tpu/config.py``.  YAML is read and
written by the port's own small reader (``utils/yaml_lite.py``), so no YAML
package is needed.

The reference threads a frozen ``yacs.config.CfgNode`` through every layer
(``Dassl/dassl/config/defaults.py:7-309``, ``federated_main.py:60-153``).  yacs is
not a dependency, so this is a small, behaviour-compatible implementation:
attribute access, ``merge_from_file`` (YAML), ``merge_from_list``,
``freeze``/``defrost``/``clone``, plus type coercion on merge.

``get_cfg_default()`` reproduces the subset of the reference default tree that is
actually consumed at runtime.
"""

from __future__ import annotations

import copy
import io
from typing import Any

from .utils import yaml_lite

_FROZEN = "__cfgnode_frozen__"


class CfgNode(dict):
    """A dict with attribute access, freezing, and yacs-style merging."""

    def __init__(self, init_dict: dict | None = None):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if getattr(self, _FROZEN):
            raise AttributeError(f"Attempted to set {name} on a frozen CfgNode")
        self[name] = value

    def __setitem__(self, key, value):
        if getattr(self, _FROZEN):
            raise AttributeError(f"Attempted to set {key} on a frozen CfgNode")
        super().__setitem__(key, value)

    # -- freeze / clone ----------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, _FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, _FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return getattr(self, _FROZEN)

    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    # -- merging -----------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge(other, self)

    def merge_from_file(self, filename: str) -> None:
        with open(filename, "r") as f:
            loaded = yaml_lite.loads(f.read(), filename)
        if loaded is None:
            return
        _merge(CfgNode(loaded), self)

    def merge_from_list(self, opts: list) -> None:
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            dict.__setitem__(node, leaf, _coerce(value, node[leaf], key))

    # -- io ------------------------------------------------------------------
    def dump(self) -> str:
        return yaml_lite.dump(_to_plain(self))

    def __str__(self) -> str:  # yacs-like indented repr
        s = io.StringIO()
        _pretty(self, s, 0)
        return s.getvalue()


def _to_plain(node):
    if isinstance(node, CfgNode):
        return {k: _to_plain(v) for k, v in node.items()}
    if isinstance(node, tuple):
        return list(node)
    return node


def _pretty(node, s, indent):
    for k in sorted(node.keys()):
        v = node[k]
        pad = " " * indent
        if isinstance(v, CfgNode):
            s.write(f"{pad}{k}:\n")
            _pretty(v, s, indent + 2)
        else:
            s.write(f"{pad}{k}: {v}\n")


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Coerce ``value`` (possibly a CLI string) to the type of ``old``.

    Strings are interpreted like yacs does: python literals first (so YAML
    values like ``(224, 224)`` become tuples), then YAML scalars.
    """
    if isinstance(value, str):
        import ast

        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            parsed = yaml_lite.parse_value(value, f"value of {key}")
            if not isinstance(parsed, str) or not isinstance(old, str):
                value = parsed
    if old is None or value is None:
        return value
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, list) and isinstance(value, tuple):
        return list(value)
    if type(old) is type(value):
        return value
    if isinstance(old, bool) and isinstance(value, int):
        return bool(value)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, int) and isinstance(value, float) and value.is_integer():
        return int(value)
    raise ValueError(
        f"Type mismatch for key {key}: cannot replace {type(old).__name__} with "
        f"{type(value).__name__} ({value!r})"
    )


def _merge(src: CfgNode, dst: CfgNode) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], CfgNode) and isinstance(v, (dict, CfgNode)):
            _merge(v if isinstance(v, CfgNode) else CfgNode(v), dst[k])
        elif k in dst and not isinstance(dst[k], CfgNode):
            dict.__setitem__(dst, k, _coerce(v, dst[k], k))
        else:
            dict.__setitem__(dst, k, CfgNode(v) if isinstance(v, dict) else v)


CN = CfgNode


def get_cfg_default() -> CfgNode:
    """Default config tree (mirrors Dassl/dassl/config/defaults.py:7-309)."""
    c = CfgNode()
    c.VERSION = 1
    c.OUTPUT_DIR = "./output"
    c.RESUME = ""
    c.SEED = -1
    c.USE_CUDA = True  # retained for CLI compat; the port picks its device per entry point
    c.VERBOSE = True

    c.INPUT = CfgNode()
    c.INPUT.SIZE = (32, 32)
    c.INPUT.INTERPOLATION = "bilinear"
    c.INPUT.TRANSFORMS = ()
    c.INPUT.NO_TRANSFORM = False
    c.INPUT.PIXEL_MEAN = [0.5071, 0.4865, 0.4409]
    c.INPUT.PIXEL_STD = [0.2673, 0.2564, 0.2762]
    c.INPUT.CROP_PADDING = 4
    c.INPUT.RRCROP_SCALE = (0.08, 1.0)
    c.INPUT.CUTOUT_N = 1
    c.INPUT.CUTOUT_LEN = 16
    c.INPUT.GN_MEAN = 0.0
    c.INPUT.GN_STD = 0.15
    c.INPUT.RANDAUGMENT_N = 2
    c.INPUT.RANDAUGMENT_M = 10
    c.INPUT.COLORJITTER_B = 0.4
    c.INPUT.COLORJITTER_C = 0.4
    c.INPUT.COLORJITTER_S = 0.4
    c.INPUT.COLORJITTER_H = 0.1
    c.INPUT.RGS_P = 0.2
    c.INPUT.GB_P = 0.5
    c.INPUT.GB_K = 21

    c.DATASET = CfgNode()
    c.DATASET.ROOT = ""
    c.DATASET.NAME = ""
    c.DATASET.SOURCE_DOMAINS = ()
    c.DATASET.TARGET_DOMAINS = ()
    c.DATASET.NUM_LABELED = -1
    c.DATASET.NUM_SHOTS = 2
    c.DATASET.VAL_PERCENT = 0.1
    c.DATASET.STL10_FOLD = -1
    c.DATASET.CIFAR_C_TYPE = ""
    c.DATASET.CIFAR_C_LEVEL = 1
    c.DATASET.ALL_AS_UNLABELED = False
    # federated keys — the CLI's extend_cfg overrides these from argparse
    # (federated_main.py:100-123); defaults here keep library use standalone
    c.DATASET.SUBSAMPLE_CLASSES = "all"
    c.DATASET.USERS = 0
    c.DATASET.IID = False
    c.DATASET.PARTITION = "homo"
    c.DATASET.USEALL = False
    c.DATASET.BETA = 0.1
    c.DATASET.REPEATRATE = 0.0
    c.DATASET.IMBALANCE_TRAIN = False
    c.DATASET.SPLIT_CLIENT = False
    c.DATASET.ATTRIBUTE_TYPE = "race"
    c.DATASET.ATTRIBUTES = ["gender", "race", "ethnicity", "language", "maritalstatus"]
    c.DATASET.MODALITY_TYPE = "slo_fundus"
    c.DATASET.DIM_PER_3D_SLICE = 16
    c.DATASET.DISEASE_TYPE = ""

    c.DATALOADER = CfgNode()
    c.DATALOADER.NUM_WORKERS = 4
    c.DATALOADER.K_TRANSFORMS = 1
    c.DATALOADER.RETURN_IMG0 = False
    c.DATALOADER.TRAIN_X = CfgNode()
    c.DATALOADER.TRAIN_X.SAMPLER = "RandomSampler"
    c.DATALOADER.TRAIN_X.BATCH_SIZE = 32
    c.DATALOADER.TRAIN_X.N_DOMAIN = 0
    c.DATALOADER.TRAIN_X.N_INS = 16
    c.DATALOADER.TRAIN_U = CfgNode()
    c.DATALOADER.TRAIN_U.SAME_AS_X = True
    c.DATALOADER.TRAIN_U.SAMPLER = "RandomSampler"
    c.DATALOADER.TRAIN_U.BATCH_SIZE = 32
    c.DATALOADER.TRAIN_U.N_DOMAIN = 0
    c.DATALOADER.TRAIN_U.N_INS = 16
    c.DATALOADER.TEST = CfgNode()
    c.DATALOADER.TEST.SAMPLER = "SequentialSampler"
    c.DATALOADER.TEST.BATCH_SIZE = 32

    c.MODEL = CfgNode()
    c.MODEL.INIT_WEIGHTS = ""
    c.MODEL.BACKBONE = CfgNode()
    c.MODEL.BACKBONE.NAME = ""
    c.MODEL.BACKBONE.PRETRAINED = True
    c.MODEL.HEAD = CfgNode()
    c.MODEL.HEAD.NAME = ""
    c.MODEL.HEAD.HIDDEN_LAYERS = ()
    c.MODEL.HEAD.ACTIVATION = "relu"
    c.MODEL.HEAD.BN = True
    c.MODEL.HEAD.DROPOUT = 0.0

    c.OPTIM = CfgNode()
    c.OPTIM.NAME = "adam"
    c.OPTIM.LR = 0.0003
    c.OPTIM.WEIGHT_DECAY = 5e-4
    c.OPTIM.MOMENTUM = 0.9
    c.OPTIM.SGD_DAMPNING = 0
    c.OPTIM.SGD_NESTEROV = False
    c.OPTIM.RMSPROP_ALPHA = 0.99
    c.OPTIM.ADAM_BETA1 = 0.9
    c.OPTIM.ADAM_BETA2 = 0.999
    c.OPTIM.STAGED_LR = False
    c.OPTIM.NEW_LAYERS = ()
    c.OPTIM.BASE_LR_MULT = 0.1
    c.OPTIM.LR_SCHEDULER = "single_step"
    c.OPTIM.STEPSIZE = (-1,)
    c.OPTIM.GAMMA = 0.1
    c.OPTIM.MAX_EPOCH = 1
    c.OPTIM.WARMUP_EPOCH = -1
    c.OPTIM.WARMUP_TYPE = "linear"
    c.OPTIM.WARMUP_CONS_LR = 1e-5
    c.OPTIM.WARMUP_MIN_LR = 1e-5
    c.OPTIM.WARMUP_RECOUNT = True

    c.TRAIN = CfgNode()
    c.TRAIN.CHECKPOINT_FREQ = 0
    c.TRAIN.PRINT_FREQ = 10
    c.TRAIN.COUNT_ITER = "train_x"
    # read by the JAX package's trainer (a profiler trace of the first
    # epoch); the port does not trace yet
    c.TRAIN.PROFILE_DIR = ""

    c.TEST = CfgNode()
    c.TEST.EVALUATOR = "Classification"
    c.TEST.PER_CLASS_RESULT = False
    c.TEST.COMPUTE_CMAT = False
    c.TEST.NO_TEST = False
    c.TEST.SPLIT = "test"
    c.TEST.FINAL_MODEL = "last_step"

    c.TRAINER = CfgNode()
    c.TRAINER.NAME = ""
    # method nodes — the CLI's extend_cfg overrides these from argparse
    # (federated_main.py:27-58); defaults keep library use standalone
    c.TRAINER.PROMPTFL = CfgNode()
    c.TRAINER.PROMPTFL.N_CTX = 16
    c.TRAINER.PROMPTFL.CSC = False
    c.TRAINER.PROMPTFL.CTX_INIT = False
    c.TRAINER.PROMPTFL.PREC = "fp16"
    c.TRAINER.PROMPTFL.CLASS_TOKEN_POSITION = "end"
    # the reference PromptFL/CLIP CustomCLIP.forward feeds the image encoder
    # RAW 0-255 pixels on the medical datasets (promptfl.py:211-224,
    # clip.py:218-231 — no /255, no mean/std; only the GLP models normalize
    # inside forward, GLP_OT_SVLoRA.py:678-694).  Default False mirrors
    # that; True applies CLIP's standard normalization
    c.TRAINER.PROMPTFL.NORMALIZE_MEDICAL_INPUT = False
    c.TRAINER.GLP_OT = CfgNode()
    c.TRAINER.GLP_OT.N_CTX = 16
    c.TRAINER.GLP_OT.CSC = False
    c.TRAINER.GLP_OT.CTX_INIT = False
    c.TRAINER.GLP_OT.PREC = "fp16"
    c.TRAINER.GLP_OT.CLASS_TOKEN_POSITION = "end"
    c.TRAINER.GLP_OT.N = 2
    c.TRAINER.GLP_OT.THRESH = 1e-3
    c.TRAINER.GLP_OT.EPS = 0.1
    c.TRAINER.GLP_OT.OT = "COT"
    c.TRAINER.GLP_OT.TOP_PERCENT = 1.0
    c.TRAINER.GLP_OT.MAX_ITER = 100
    c.TRAINER.GLP_OT_LORA = CfgNode()
    c.TRAINER.GLP_OT_LORA.UNFREEZE_IMAGE_ENCODER = False
    c.TRAINER.GLP_OT_LORA.UNFREEZE_TEXT_ENCODER = False
    c.TRAINER.GLP_OT_LORA.RANK = 4
    c.TRAINER.GLP_OT_LORA.ALPHA = 0.04
    c.TRAINER.GLP_OT_LORA.TYPE = "LoRA"
    c.TRAINER.GLP_OT_LORA.LOCAL_S = False
    c.TRAINER.GLP_OT_LORA.GLOBAL_S = False
    c.TRAINER.GLP_OT_LORA.DISABLE_ATTR = False
    c.TRAINER.LAMBDA_FAIRNESS = 0.0

    # Dassl DA/DG/SSL trainer nodes (defaults.py:224-309) — config-only in the
    # reference too (SURVEY §2.8); kept so configs that set them merge cleanly.
    c.TRAINER.MCD = CfgNode()
    c.TRAINER.MCD.N_STEP_F = 4
    c.TRAINER.MME = CfgNode()
    c.TRAINER.MME.LMDA = 0.1
    c.TRAINER.CDAC = CfgNode()
    c.TRAINER.CDAC.CLASS_LR_MULTI = 10
    c.TRAINER.CDAC.RAMPUP_COEF = 30
    c.TRAINER.CDAC.RAMPUP_ITRS = 1000
    c.TRAINER.CDAC.TOPK_MATCH = 5
    c.TRAINER.CDAC.P_THRESH = 0.95
    c.TRAINER.CDAC.STRONG_TRANSFORMS = ()
    c.TRAINER.SE = CfgNode()
    c.TRAINER.SE.EMA_ALPHA = 0.999
    c.TRAINER.SE.CONF_THRE = 0.95
    c.TRAINER.SE.RAMPUP = 300
    c.TRAINER.M3SDA = CfgNode()
    c.TRAINER.M3SDA.LMDA = 0.5
    c.TRAINER.M3SDA.N_STEP_F = 4
    c.TRAINER.DAEL = CfgNode()
    c.TRAINER.DAEL.WEIGHT_U = 0.5
    c.TRAINER.DAEL.CONF_THRE = 0.95
    c.TRAINER.DAEL.STRONG_TRANSFORMS = ()
    c.TRAINER.CROSSGRAD = CfgNode()
    c.TRAINER.CROSSGRAD.EPS_F = 1.0
    c.TRAINER.CROSSGRAD.EPS_D = 1.0
    c.TRAINER.CROSSGRAD.ALPHA_F = 0.5
    c.TRAINER.CROSSGRAD.ALPHA_D = 0.5
    c.TRAINER.DDAIG = CfgNode()
    c.TRAINER.DDAIG.G_ARCH = ""
    c.TRAINER.DDAIG.LMDA = 0.3
    c.TRAINER.DDAIG.CLAMP = False
    c.TRAINER.DDAIG.CLAMP_MIN = -1.0
    c.TRAINER.DDAIG.CLAMP_MAX = 1.0
    c.TRAINER.DDAIG.WARMUP = 0
    c.TRAINER.DDAIG.ALPHA = 0.5
    c.TRAINER.DAELDG = CfgNode()
    c.TRAINER.DAELDG.WEIGHT_U = 0.5
    c.TRAINER.DAELDG.CONF_THRE = 0.95
    c.TRAINER.DAELDG.STRONG_TRANSFORMS = ()
    c.TRAINER.DOMAINMIX = CfgNode()
    c.TRAINER.DOMAINMIX.TYPE = "crossdomain"
    c.TRAINER.DOMAINMIX.ALPHA = 1.0
    c.TRAINER.DOMAINMIX.BETA = 1.0
    c.TRAINER.ENTMIN = CfgNode()
    c.TRAINER.ENTMIN.LMDA = 1e-3
    c.TRAINER.MEANTEACHER = CfgNode()
    c.TRAINER.MEANTEACHER.WEIGHT_U = 1.0
    c.TRAINER.MEANTEACHER.EMA_ALPHA = 0.999
    c.TRAINER.MEANTEACHER.RAMPUP = 5
    c.TRAINER.MIXMATCH = CfgNode()
    c.TRAINER.MIXMATCH.WEIGHT_U = 100.0
    c.TRAINER.MIXMATCH.TEMP = 2.0
    c.TRAINER.MIXMATCH.MIXUP_BETA = 0.75
    c.TRAINER.MIXMATCH.RAMPUP = 20000
    c.TRAINER.FIXMATCH = CfgNode()
    c.TRAINER.FIXMATCH.WEIGHT_U = 1.0
    c.TRAINER.FIXMATCH.CONF_THRE = 0.95
    c.TRAINER.FIXMATCH.STRONG_TRANSFORMS = ()

    return c
