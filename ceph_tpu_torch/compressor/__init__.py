"""Compression plugins of the port.

Port of ``ceph_tpu/compressor/`` as far as the device write path needs
it: the ``Compressor`` interface and its errno-carrying error
(``base.py``), and a registry (``registry.py``) that creates the
``jax_device`` plugin, the bit-plane container of the fused write
transform framed for standalone use (``plugins.py``). The reference's
other algorithms (zlib, zstd, snappy, lz4), its compression modes and
its plugin version gate are not ported yet.
"""

from .base import Compressor, CompressorError  # noqa: F401
from .registry import create  # noqa: F401
