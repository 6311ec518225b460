"""Name -> object registry (the port's copy of the one the configs need).

Counterpart of ``skypilot_tpu/utils/registry.py``; only ``Registry`` and
``MODEL_REGISTRY`` are carried over.
"""
from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, List, Optional, TypeVar

T = TypeVar('T')


class Registry(Generic[T]):
    """A case-insensitive name -> object registry with aliases."""

    def __init__(self, registry_name: str) -> None:
        self._name = registry_name
        self._entries: Dict[str, T] = {}
        self._aliases: Dict[str, str] = {}
        self._default: Optional[str] = None

    def register(self,
                 name: str,
                 *,
                 aliases: Optional[List[str]] = None,
                 default: bool = False) -> Callable[[T], T]:
        """Decorator: register the decorated object under `name`."""

        def decorator(obj: T) -> T:
            key = name.lower()
            if key in self._entries:
                raise ValueError(
                    f'{self._name} registry: duplicate entry {name!r}')
            self._entries[key] = obj
            for alias in aliases or []:
                self._aliases[alias.lower()] = key
            if default:
                self._default = key
            return obj

        return decorator

    def get(self, name: Optional[str]) -> T:
        if name is None:
            if self._default is None:
                raise KeyError(f'{self._name} registry: no default entry')
            name = self._default
        key = name.lower()
        key = self._aliases.get(key, key)
        if key not in self._entries:
            raise KeyError(
                f'{self._name} registry: unknown entry {name!r}. '
                f'Available: {sorted(self._entries)}')
        return self._entries[key]

    def __contains__(self, name: str) -> bool:
        key = name.lower()
        return key in self._entries or key in self._aliases

    def keys(self) -> List[str]:
        return sorted(self._entries)

    def values(self) -> Iterator[T]:
        return iter(self._entries.values())


MODEL_REGISTRY: 'Registry' = Registry('model')
