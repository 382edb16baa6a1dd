"""Block registry + plugin loading.

Reference: string→factory ``GeneralRegistry`` (core/include/gnuradio-4.0/
BlockRegistry.hpp:44) populated by ``GR_REGISTER_BLOCK`` macros expanded by an offline
codegen tool; ``PluginLoader`` dlopens ``.so`` plugins (PluginLoader.hpp).

Design: registration is a decorator at import time (Python has real
reflection, no codegen needed); "plugins" are importable modules/entry-point paths
loaded by :class:`PluginLoader`. Type-parameterized reference blocks (``Convert<T,U>``)
become a single block whose dtype is a setting/port property.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
from pathlib import Path
from typing import Any, Callable, Iterable

from .block import Block
from .errors import GrError


class BlockRegistry:
    def __init__(self):
        self._factories: dict[str, Callable[..., Block]] = {}

    def register(self, name: str | None = None, *, aliases: Iterable[str] = ()
                 ) -> Callable[[type], type]:
        def deco(cls: type) -> type:
            key = name or cls.__name__
            for k in (key, *aliases):
                if k in self._factories and self._factories[k] is not cls:
                    raise GrError(f"block type {k!r} already registered")
                self._factories[k] = cls
            cls.registry_name = key
            return cls
        return deco

    def add(self, name: str, factory: Callable[..., Block]) -> None:
        self._factories[name] = factory

    def known_blocks(self) -> list[str]:
        return sorted(self._factories)

    def contains(self, name: str) -> bool:
        return name in self._factories

    def create(self, name: str, /, **settings: Any) -> Block:
        try:
            factory = self._factories[name]
        except KeyError as e:
            raise GrError(f"unknown block type {name!r}; known: {self.known_blocks()}") from e
        return factory(**settings)

    def get(self, name: str) -> Callable[..., Block]:
        try:
            return self._factories[name]
        except KeyError as e:
            raise GrError(f"unknown block type {name!r}") from e


# global registry (≈ gr::globalBlockRegistry)
global_registry = BlockRegistry()
register_block = global_registry.register


class SchedulerRegistry:
    """Parallel registry for scheduler types (≈ BlockRegistry.hpp:152)."""

    def __init__(self):
        self._factories: dict[str, Callable[..., Any]] = {}

    def register(self, name: str | None = None):
        def deco(cls):
            self._factories[name or cls.__name__] = cls
            return cls
        return deco

    def known_schedulers(self) -> list[str]:
        return sorted(self._factories)

    def create(self, name: str, /, *args, **kw):
        try:
            return self._factories[name](*args, **kw)
        except KeyError as e:
            raise GrError(f"unknown scheduler type {name!r}") from e


global_scheduler_registry = SchedulerRegistry()
register_scheduler = global_scheduler_registry.register


class PluginLoader:
    """Loads block plugins: importable module names or ``.py`` file paths.

    Importing a plugin module runs its ``@register_block`` decorators against the
    global registry (≈ dlopen + static registration in the reference). A module may
    also expose ``gr_register(registry)`` for explicit registration.
    """

    def __init__(self, registry: BlockRegistry | None = None,
                 search_paths: Iterable[str] = ()):
        self.registry = registry or global_registry
        self.search_paths = [Path(p) for p in search_paths]
        self.loaded: dict[str, Any] = {}
        self.failed: dict[str, str] = {}

    def load(self, name_or_path: str) -> Any:
        if name_or_path in self.loaded:
            return self.loaded[name_or_path]
        try:
            mod = self._import(name_or_path)
        except Exception as e:  # record, don't crash (≈ bad_plugin tolerance)
            self.failed[name_or_path] = f"{type(e).__name__}: {e}"
            raise GrError(f"failed to load plugin {name_or_path!r}: {e}") from e
        hook = getattr(mod, "gr_register", None)
        if callable(hook):
            hook(self.registry)
        self.loaded[name_or_path] = mod
        return mod

    def _import(self, name_or_path: str) -> Any:
        p = Path(name_or_path)
        candidates = [p] if p.suffix == ".py" else []
        candidates += [base / f"{name_or_path}.py" for base in self.search_paths]
        for cand in candidates:
            if cand.is_file():
                spec = importlib.util.spec_from_file_location(cand.stem, cand)
                mod = importlib.util.module_from_spec(spec)
                sys.modules[cand.stem] = mod
                spec.loader.exec_module(mod)
                return mod
        return importlib.import_module(name_or_path)

    def instantiate(self, type_name: str, /, **settings: Any) -> Block:
        return self.registry.create(type_name, **settings)
