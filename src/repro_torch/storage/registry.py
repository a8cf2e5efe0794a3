"""String-keyed backend registry for `EmbeddingStorage` implementations.

`EmbeddingStageConfig.storage` resolves here: the in-tree backends
(`device`, `tiered`, `sharded`, `pool`) register at import of
`repro_torch.storage`, and out-of-tree backends can `@register("mine")`
their own class — the whole stack (EmbeddingBagCollection,
ServingSession) picks them up by name with no further wiring.

Misuse is loud by design (tested in tests/test_torch_core.py and
tests/test_torch_serving.py):
  * unknown name        -> UnknownBackendError listing what IS available
  * double registration -> ValueError (shadowing a backend silently would
                           change lookup semantics under existing configs)
"""
from __future__ import annotations

from typing import Callable, Type

from repro_torch.storage.base import EmbeddingStorage

_BACKENDS: dict[str, Type[EmbeddingStorage]] = {}


class UnknownBackendError(ValueError):
    """Requested storage backend name is not registered."""


def register(name: str) -> Callable[[Type[EmbeddingStorage]],
                                    Type[EmbeddingStorage]]:
    """Class decorator: `@register("device")` keys the backend by name."""
    def deco(cls: Type[EmbeddingStorage]) -> Type[EmbeddingStorage]:
        if name in _BACKENDS:
            raise ValueError(
                f"storage backend {name!r} is already registered "
                f"(to {_BACKENDS[name].__name__}); re-registration would "
                f"silently change lookup semantics — unregister first or "
                f"pick another name")
        if not (isinstance(cls, type)
                and issubclass(cls, EmbeddingStorage)):
            raise TypeError(f"{cls!r} is not an EmbeddingStorage subclass")
        cls.name = name
        _BACKENDS[name] = cls
        return cls
    return deco


def unregister(name: str) -> None:
    """Remove a backend (test hygiene for probe registrations)."""
    _BACKENDS.pop(name, None)


def available() -> list[str]:
    return sorted(_BACKENDS)


def resolve(name: str) -> Type[EmbeddingStorage]:
    if name not in _BACKENDS:
        raise UnknownBackendError(
            f"unknown storage backend {name!r}: available backends are "
            f"{available()} (register new ones with "
            f"repro_torch.storage.register)")
    return _BACKENDS[name]


def create(name: str, ebc) -> EmbeddingStorage:
    """Instantiate the backend `name` bound to collection `ebc`."""
    return resolve(name)(ebc)
