"""Compression plugins of the port.

Port of ``ceph_tpu/compressor/``, the reference's second instance of
Ceph's plugin idiom (src/compressor/: the ``Compressor`` interface,
CompressionPlugin.h and the zlib, snappy, zstd and lz4 plugins): a
registry that loads a plugin on demand under a lock, refuses a second
registration of a name (EEXIST) and a plugin of another version (EXDEV),
``create`` with Compressor::create's aliases, and BlueStore's
compression-mode policy (none / passive / aggressive / force) with the
required-ratio gate.

zlib rides the standard library; zstd, snappy and lz4 are probed at
import (``plugins.HAVE_*``), registered all the same, and fail to load
with ENOENT where their Python package is absent, as a missing
libceph_snappy.so does in the reference; ``available(name)`` is the
probe that does not raise. ``jax_device`` (the reference's name) is the
bit-plane container of the fused write transform, framed for
standalone use.
"""

from .base import (MODE_AGGRESSIVE, MODE_FORCE, MODE_NONE,  # noqa: F401
                   MODE_PASSIVE, Compressor, CompressorError,
                   compress_if_worthwhile, should_compress)
from .registry import (CompressionPluginRegistry, available,  # noqa: F401
                       create)
