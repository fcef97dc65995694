"""Erasure-code plugin registry.

Port of ``ceph_tpu/registry.py``, the rendition of
ErasureCodePluginRegistry (src/erasure-code/ErasureCodePlugin.{h,cc}): a
process singleton that loads plugins on demand under a lock, rejects
duplicate registration (EEXIST), version-gates loaded plugins (EXDEV),
and constructs codecs from profiles (factory, ErasureCodePlugin.cc:92-120)
with a profile echo check (:114-118).

Built-in plugin:
  torch_cuda   the GPU-batched backend (counterpart of ``jax_tpu``):
               reed_sol_van (the default) and reed_sol_r6_op

``factory`` takes the device the codec runs on (default ``cuda``; it
raises when CUDA is absent unless ``device="cpu"`` is passed).
"""

from __future__ import annotations

import errno
import threading

from .models.base import ErasureCode, ErasureCodeError

__erasure_code_version__ = "1.0.0"


class ErasureCodePlugin:
    """A named factory for codec instances."""

    version = __erasure_code_version__

    def factory(self, profile: dict, errors: list | None = None,
                device=None) -> ErasureCode:
        raise NotImplementedError


class _TechniquePlugin(ErasureCodePlugin):
    """Dispatches on profile["technique"] like the jerasure plugin factory
    (ErasureCodePluginJerasure.cc:34-73)."""

    def __init__(self, techniques: dict, backend: str,
                 default_technique: str | None = None):
        self.techniques = techniques
        self.backend = backend
        self.default_technique = default_technique

    def factory(self, profile, errors=None, device=None):
        t = profile.get("technique") or self.default_technique
        cls = self.techniques.get(t)
        if cls is None:
            raise ErasureCodeError(
                errno.ENOENT,
                "technique=%s is not a valid coding technique. Choose one "
                "of the following: %s" % (t, ", ".join(self.techniques)))
        profile.setdefault("technique", t)
        codec = cls(backend=self.backend, device=device)
        codec.init(profile, errors)
        return codec


def _rs_techniques():
    from .models import rs
    return {
        "reed_sol_van": rs.ReedSolomonVandermonde,
        "reed_sol_r6_op": rs.ReedSolomonRAID6,
    }


_BUILTIN_LOADERS = {
    "torch_cuda": lambda: _TechniquePlugin(_rs_techniques(), "torch",
                                           default_technique="reed_sol_van"),
}


class ErasureCodePluginRegistry:
    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self.lock = threading.RLock()
        self.plugins: dict[str, ErasureCodePlugin] = {}
        self.loaders = dict(_BUILTIN_LOADERS)

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        """Register a plugin; EEXIST on duplicates (ErasureCodePlugin.cc)."""
        with self.lock:
            if name in self.plugins:
                raise ErasureCodeError(
                    errno.EEXIST, "plugin %s already registered" % name)
            self.plugins[name] = plugin

    def get(self, name: str) -> ErasureCodePlugin | None:
        with self.lock:
            return self.plugins.get(name)

    def load(self, name: str) -> ErasureCodePlugin:
        """Load a plugin on demand; version-gate it like the dlopen path
        (__erasure_code_version check, ErasureCodePlugin.cc:144-149)."""
        with self.lock:
            if name in self.plugins:
                return self.plugins[name]
            loader = self.loaders.get(name)
            if loader is None:
                raise ErasureCodeError(
                    errno.ENOENT, "load dlopen(libec_%s.so): not found" % name)
            plugin = loader()
            if not isinstance(plugin, ErasureCodePlugin):
                raise ErasureCodeError(
                    errno.ENOENT, "plugin %s did not register itself" % name)
            if plugin.version != __erasure_code_version__:
                raise ErasureCodeError(
                    errno.EXDEV,
                    "plugin %s version %s != expected %s"
                    % (name, plugin.version, __erasure_code_version__))
            self.plugins[name] = plugin
            return plugin

    def factory(self, name: str, profile: dict,
                errors: list | None = None, device=None) -> ErasureCode:
        """Instantiate a codec (ErasureCodePlugin.cc:92-120)."""
        with self.lock:
            plugin = self.load(name)
        codec = plugin.factory(profile, errors, device)
        echo = codec.get_profile()
        if echo is not profile and echo != profile:
            raise ErasureCodeError(
                errno.EINVAL,
                "profile %r was not echoed back by plugin %s: %r"
                % (profile, name, echo))
        return codec


def factory(name: str, profile: dict, errors: list | None = None,
            device=None) -> ErasureCode:
    """Module-level convenience: build a codec from a plugin name + profile
    on `device` (default cuda)."""
    return ErasureCodePluginRegistry.instance().factory(
        name, profile, errors, device)
