"""Declarative component registries.

Replaces the reference's name-based reflection factories
(``getattr(sys.modules['dataset'], config['name'])`` at reference
dataset.py:12, model.py:19, trainer.py:18) with explicit registries, so the
wiring is greppable and import-cycle free while keeping the same
config-as-dict API surface (``{'name': 'IGCN', ...}``).
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str | None = None) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            key = name or getattr(obj, "__name__", None)
            if key is None:
                raise ValueError(f"cannot infer registry name for {obj!r}")
            if key in self._entries:
                raise KeyError(f"{self.kind} {key!r} registered twice")
            self._entries[key] = obj
            return obj

        return deco

    def get(self, name: str) -> T:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; known: {sorted(self._entries)}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self):
        return sorted(self._entries)


DATASETS: Registry = Registry("dataset")
MODELS: Registry = Registry("model")
TRAINERS: Registry = Registry("trainer")
