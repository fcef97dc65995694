"""Compression plugin registry.

Port of ``ceph_tpu/compressor/registry.py``: the erasure-code registry's
contract (src/compressor/CompressionPlugin.h against
src/erasure-code/ErasureCodePlugin.h): a process-wide instance, plugins
loaded on demand under a lock, EEXIST on a second registration of a
name, EXDEV on a plugin of another version, ENOENT on an unknown name or
an absent host library; ``create`` adds Compressor::create's aliases
("" and "none" mean no compressor).
"""

from __future__ import annotations

import errno
import threading

from . import plugins
from .base import Compressor, CompressorError

__all__ = ["CompressionPlugin", "CompressionPluginRegistry", "available",
           "create"]

__compression_version__ = "1.0.0"


class CompressionPlugin:
    version = __compression_version__

    def __init__(self, factory_fn):
        self._factory_fn = factory_fn

    def factory(self) -> Compressor:
        return self._factory_fn()


def _builtin_loaders():
    def probe(cls):
        # an absent host library surfaces at load(), as a missing .so
        def loader():
            try:
                cls()
            except ImportError as e:
                raise CompressorError(
                    errno.ENOENT,
                    "load dlopen(libceph_%s.so): %s" % (cls.name, e))
            return CompressionPlugin(cls)
        return loader

    return {cls.name: probe(cls) for cls in (
        plugins.ZlibCompressor, plugins.ZstdCompressor,
        plugins.SnappyCompressor, plugins.Lz4Compressor,
        plugins.DeviceBitplaneCompressor)}


class CompressionPluginRegistry:
    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self.lock = threading.RLock()
        self.plugins: dict[str, CompressionPlugin] = {}
        self.loaders = _builtin_loaders()

    @classmethod
    def instance(cls) -> "CompressionPluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def add(self, name: str, plugin: CompressionPlugin) -> None:
        with self.lock:
            if name in self.plugins:
                raise CompressorError(
                    errno.EEXIST, "plugin %s already registered" % name)
            self.plugins[name] = plugin

    def load(self, name: str) -> CompressionPlugin:
        with self.lock:
            if name in self.plugins:
                return self.plugins[name]
            loader = self.loaders.get(name)
            if loader is None:
                raise CompressorError(
                    errno.ENOENT,
                    "load dlopen(libceph_%s.so): not found" % name)
            plugin = loader()
            if plugin.version != __compression_version__:
                raise CompressorError(
                    errno.EXDEV,
                    "plugin %s version %s != expected %s"
                    % (name, plugin.version, __compression_version__))
            self.plugins[name] = plugin
            return plugin

    def preload(self, names) -> None:
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",") if n.strip()]
        for name in names:
            self.load(name)

    def factory(self, name: str) -> Compressor:
        with self.lock:
            plugin = self.load(name)
        return plugin.factory()

    def available(self, name: str) -> bool:
        """Whether the plugin loads (its host library is present); never
        raises."""
        try:
            self.load(name)
            return True
        except CompressorError:
            return False


def available(name: str) -> bool:
    """The process-wide registry's :meth:`~CompressionPluginRegistry.
    available`; no compression ("" or "none") is always available."""
    if not name or name == "none":
        return True
    return CompressionPluginRegistry.instance().available(name)


def create(name: str) -> Compressor | None:
    """A new compressor of algorithm `name` (Compressor::create): None
    for "" and "none"; an unknown name raises ENOENT."""
    if not name or name == "none":
        return None
    return CompressionPluginRegistry.instance().factory(name)
