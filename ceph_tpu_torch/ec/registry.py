"""Plugin registry — name → erasure-code factory.

The reference lazily dlopens ``libec_<name>.so`` and lets the plugin
self-register (ErasureCodePlugin.cc:86-163); here plugins are python
classes that self-register at import, and ``factory`` instantiates and
``init``s them from a profile.  This registry is the insertion point for
device-backed codes, exactly as it is the reference's insertion point for
isa/jerasure: every code family runs its region math through the
``torch`` backend on the profile's ``device``.
"""

from __future__ import annotations

import threading

from ..version import FRAMEWORK_VERSION
from .interface import ErasureCodeError, ErasureCodeProfile

# The registry refuses plugins built against another framework version,
# mirroring the __erasure_code_version == CEPH_GIT_NICE_VER check at
# dlopen time (ErasureCodePlugin.cc:138).


class ErasureCodePlugin:
    """Factory base: subclass and implement make(profile)."""

    version = FRAMEWORK_VERSION

    def make(self, profile: ErasureCodeProfile):
        raise NotImplementedError


class ErasureCodePluginRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._plugins: dict[str, ErasureCodePlugin] = {}
        self.disable_dlclose = False  # parity knob; unused

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        version = getattr(plugin, "version", None)
        if version != FRAMEWORK_VERSION:
            raise ErasureCodeError(
                f"plugin {name}: version {version!r} does not match "
                f"{FRAMEWORK_VERSION!r}"
            )
        if not callable(getattr(plugin, "make", None)):
            raise ErasureCodeError(
                f"plugin {name}: missing entry point make()"
            )
        with self._lock:
            if name in self._plugins:
                raise ErasureCodeError(f"plugin {name} already registered")
            self._plugins[name] = plugin

    def get(self, name: str) -> ErasureCodePlugin | None:
        return self._plugins.get(name)

    def remove(self, name: str) -> None:
        with self._lock:
            self._plugins.pop(name, None)

    def factory(
        self,
        plugin_name: str,
        profile: ErasureCodeProfile,
        ss=None,
    ):
        """Instantiate + init a code from a profile
        (ErasureCodePlugin.cc:86 factory contract)."""
        plugin = self._plugins.get(plugin_name)
        if plugin is None:
            raise ErasureCodeError(
                f"failed to load plugin {plugin_name!r}: not registered "
                f"(have: {sorted(self._plugins)})"
            )
        ec = plugin.make(profile)
        ec.init(profile)
        return ec

    def preload(self, names: list[str]) -> None:
        """Parity with osd_erasure_code_plugins preload: verify the listed
        plugins resolve (all python plugins register at import here)."""
        for name in names:
            if name not in self._plugins:
                raise ErasureCodeError(f"cannot preload plugin {name!r}")


_instance = ErasureCodePluginRegistry()


def instance() -> ErasureCodePluginRegistry:
    return _instance


def register(name: str):
    """Decorator: register a plugin class (instantiated once) by name."""

    def deco(cls):
        _instance.add(name, cls())
        return cls

    return deco
