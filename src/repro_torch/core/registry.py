"""One string-or-instance resolution helper for every registry in the repo.

The package keeps name -> class registries -- protocols
(:mod:`repro_torch.core.protocols`) and aggregation rules
(:mod:`repro_torch.core.aggregation`).  Each would otherwise hand-roll the
same two snippets: "unknown name" error formatting, and the
``make_x(v) if isinstance(v, str) else v`` dance wherever a caller accepts
either a registered name or an already-built instance.  This module is the
single implementation both snippets share, so every registry reports
unknown names identically (a ``KeyError`` listing the registered names) and
every ``make_*`` factory accepts instances as pass-throughs.

Registries keep owning their own dicts and ``register_*`` decorators (the
registration side is already uniform); only the *resolution* side funnels
through here::

    def make_scenario(scenario, **overrides):
        return resolve("scenario", scenario, _REGISTRY, Scenario,
                       **overrides)
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

__all__ = ["lookup", "resolve"]


def lookup(kind: str, name: str, registry: Mapping[str, type]) -> type:
    """The class registered under ``name``, or a KeyError naming ``kind``
    and listing every registered name (sorted) -- the one error message
    every registry in the repo raises for a typo'd name."""
    if name not in registry:
        raise KeyError(
            f"unknown {kind} {name!r}; registered: "
            f"{', '.join(sorted(registry))}")
    return registry[name]


def resolve(kind: str, value, registry: Mapping[str, type], base: type, *,
            instantiate: Optional[Callable] = None, **overrides):
    """Resolve ``value`` -- a registered name or an already-built instance
    of ``base`` -- into an instance.

    A string is looked up via :func:`lookup` and instantiated as
    ``cls(**overrides)`` (or through ``instantiate(cls, overrides)`` when a
    factory needs custom kwarg handling, e.g. ``make_protocol``'s legacy
    field filtering).  An instance passes through untouched; combining an
    instance with overrides is ambiguous and raises, as does any other
    type.
    """
    if isinstance(value, base):
        if overrides:
            raise TypeError(
                f"cannot apply overrides {sorted(overrides)} to an "
                f"already-constructed {kind} instance; pass a registered "
                f"name, or build the instance with those values directly")
        return value
    if not isinstance(value, str):
        raise TypeError(
            f"{kind} must be a registered name or a {base.__name__} "
            f"instance, got {type(value).__name__}")
    cls = lookup(kind, value, registry)
    if instantiate is not None:
        return instantiate(cls, overrides)
    return cls(**overrides)
