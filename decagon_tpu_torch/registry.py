"""Self-registering factory machinery.

The port's copy of ``decagon_tpu/registry.py``, unchanged.

Capability spec: reference ``main/Utils/BaseFactorizableClass.py:9-45`` +
``ObjectFactory.py:5-9`` — subclasses register themselves under
``(base class, functionality-type enum)`` at class-creation time and are
instantiated by a generic factory (``ObjectFactory.build``), with the
enums in ``main/Dtos/Enums/*``.  Here registration uses
``__init_subclass__`` keyed by ``(base, name)``; names double as the
config-file values (``DataSetType``, ``ActiveLearnerType``, ...), so no
module-walking auto-import (``main/__init__.py:5-29``) is needed — a
documented wart of the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Type

_REGISTRY: Dict[Tuple[type, str], type] = {}


class Factorizable:
    """Inherit with ``, functionality=NAME`` to self-register.

    ``functionality=None`` (or omitting it) skips registration — matching
    the reference's un-instantiable ``GreedyActiveLearner`` registration
    with ``functionalityType=None`` (``GreedyActiveLearner.py``).
    """

    _factory_base: Optional[type] = None

    def __init_subclass__(
        cls, functionality: Optional[str] = None, **kwargs: Any
    ):
        super().__init_subclass__(**kwargs)
        # The first Factorizable subclass in a hierarchy becomes the base
        # all its descendants register under.
        if cls._factory_base is None:
            cls._factory_base = cls
        if functionality is not None:
            register(cls._factory_base, functionality, cls)


def register(base: type, name: str, cls: Optional[type] = None):
    """Register ``cls`` as ``base``'s implementation named ``name``.

    Usable directly or as a decorator: ``@register(Base, "Name")``.
    """
    if cls is None:
        def deco(c: type) -> type:
            register(base, name, c)
            return c
        return deco
    key = (base, name)
    if key in _REGISTRY and _REGISTRY[key] is not cls:
        raise ValueError(
            f"{name!r} already registered for {base.__name__} "
            f"({_REGISTRY[key].__name__})"
        )
    _REGISTRY[key] = cls
    return cls


def build(base: type, name: str, **kwargs: Any):
    """Instantiate the implementation of ``base`` registered as ``name``
    (reference ``ObjectFactory.build``)."""
    try:
        cls = _REGISTRY[(base, name)]
    except KeyError:
        known = sorted(n for b, n in _REGISTRY if b is base)
        raise KeyError(
            f"no {base.__name__} registered as {name!r}; known: {known}"
        ) from None
    return cls(**kwargs)


def known(base: type) -> Dict[str, type]:
    return {n: c for (b, n), c in _REGISTRY.items() if b is base}
