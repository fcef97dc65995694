"""Compression plugin registry.

Port of ``ceph_tpu/compressor/registry.py`` as far as the port has
plugins: ``create`` with the reference's Compressor::create aliases
("" and "none" mean no compressor; an unknown name raises ENOENT). The
one plugin is ``jax_device``.
"""

from __future__ import annotations

import errno

from .base import Compressor, CompressorError
from .plugins import DeviceBitplaneCompressor

__all__ = ["create", "PLUGINS"]

PLUGINS = {DeviceBitplaneCompressor.name: DeviceBitplaneCompressor}


def create(name: str) -> Compressor | None:
    """A new compressor of algorithm `name`; None for "" and "none"."""
    if not name or name == "none":
        return None
    cls = PLUGINS.get(name)
    if cls is None:
        raise CompressorError(
            errno.ENOENT, "load dlopen(libceph_%s.so): not found" % name)
    return cls()
