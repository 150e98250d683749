"""Name → factory registries (mirrors Dassl/dassl/utils/registry.py).

Used for TRAINER / DATASET / EVALUATOR lookup from config strings.
"""

from __future__ import annotations


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: dict[str, type] = {}

    def register(self, obj=None, *, force: bool = False):
        if obj is None:  # used as decorator with parens
            def deco(fn_or_cls):
                return self.register(fn_or_cls, force=force)
            return deco
        name = obj.__name__
        if not force and name in self._obj_map:
            raise KeyError(f"{name} already registered in {self._name}")
        self._obj_map[name] = obj
        return obj

    def get(self, name: str):
        if name not in self._obj_map:
            raise KeyError(
                f"{name} not found in {self._name} registry. "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def registered_names(self):
        return sorted(self._obj_map)


TRAINER_REGISTRY = Registry("TRAINER")
DATASET_REGISTRY = Registry("DATASET")
EVALUATOR_REGISTRY = Registry("EVALUATOR")
BACKBONE_REGISTRY = Registry("BACKBONE")
