"""Named-component registries.

Capability match for the reference's dict-decorator registry
(easyhec/utils/registry.py:6-42) and its global registries
(easyhec/registry.py:1-8: TRAINERS / BATCH_COLLATORS / EVALUATORS /
VISUALIZERS / SAMPLERS). Unlike the reference — whose EVALUATORS and
VISUALIZERS registries are empty in the snapshot (SURVEY.md §2) — every
registry here has at least one concrete registration.
"""
from __future__ import annotations

from typing import Callable, TypeVar

T = TypeVar("T")

__all__ = [
    "Registry",
    "TRAINERS",
    "COLLATORS",
    "SAMPLERS",
    "EVALUATORS",
    "VISUALIZERS",
    "MASK_SOURCES",
]


class Registry(dict):
    """dict with a .register(name) decorator; raises on duplicate names."""

    def register(self, name: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if name in self:
                raise KeyError(f"{name!r} already registered")
            self[name] = obj
            return obj

        return deco

    def build(self, name: str, *args, **kwargs):
        if name not in self:
            raise KeyError(f"{name!r} not registered; have {sorted(self)}")
        return self[name](*args, **kwargs)


TRAINERS = Registry()
COLLATORS = Registry()
SAMPLERS = Registry()
EVALUATORS = Registry()
VISUALIZERS = Registry()
MASK_SOURCES = Registry()
