"""Flat package namespaces that import each name on first use."""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple, Union

Export = Union[str, Tuple[str, str]]


def lazy_exports(namespace: dict, exports: Dict[str, List[Export]]):
    """Give a package ``__all__`` and the module-level ``__getattr__``
    and ``__dir__`` that import an exported name from its submodule on
    first use: ``namespace.update(lazy_exports(globals(), {...}))``.

    ``exports`` maps a submodule (relative to the package) to its names;
    a ``(public, attr)`` pair exports ``attr`` under another name."""
    package = namespace["__name__"]
    where = {}
    for mod, names in exports.items():
        for n in names:
            public, attr = (n, n) if isinstance(n, str) else n
            where[public] = (mod, attr)

    def __getattr__(name):
        if name not in where:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        mod, attr = where[name]
        value = getattr(importlib.import_module(f"{package}.{mod}"), attr)
        namespace[name] = value
        return value

    def __dir__():
        return sorted(set(namespace) | set(where))

    return {"__all__": sorted(where), "__getattr__": __getattr__, "__dir__": __dir__}
