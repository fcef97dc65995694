"""Built-in compression algorithms.

Port of ``ceph_tpu/compressor/plugins.py``, the parity set of Ceph's
plugin directories (src/compressor/{zlib,snappy,zstd,lz4}/). zlib rides
the standard library; zstd the ``zstandard`` package; snappy and lz4
their Python bindings, which may be absent: each is probed at import
(``HAVE_*``) and its constructor raises ImportError without it, which
the registry turns into ENOENT, as a missing plugin .so in the
reference.

``jax_device`` (:class:`DeviceBitplaneCompressor`, ref :100-134) is the
bit-plane container of the fused write transform in a self-contained
frame: an 8-byte header (``<II``: raw_len, padded_len), then the
container (``osd/fused_transform.py`` ``bitplane_compress_host`` and
``bitplane_decompress``). The OSD write path runs this stage on the card
inside the fused write transform (the K3 kernel) and carries raw_len and
padded_len in the object's HashInfo comp_info instead.
"""

from __future__ import annotations

import errno
import importlib.util
import struct
import zlib

from ..osd import fused_transform
from .base import Compressor, CompressorError

__all__ = ["ZlibCompressor", "ZstdCompressor", "SnappyCompressor",
           "Lz4Compressor", "DeviceBitplaneCompressor", "HAVE_ZSTD",
           "HAVE_SNAPPY", "HAVE_LZ4"]


def _probe(modname: str) -> bool:
    """Whether a host library's module is installed; find_spec never
    runs the module, so an absent package reads as False here and as
    ENOENT at load, not as an ImportError at first use."""
    try:
        return importlib.util.find_spec(modname) is not None
    except (ImportError, ValueError):
        return False


HAVE_ZSTD = _probe("zstandard")
HAVE_SNAPPY = _probe("snappy")
HAVE_LZ4 = _probe("lz4")


class ZlibCompressor(Compressor):
    """Deflate (src/compressor/zlib/ZlibCompressor.cc) at the reference's
    compressor_zlib_level default of 5."""

    name = "zlib"

    def __init__(self, level: int = 5):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(bytes(data), self.level)

    def decompress(self, data: bytes) -> bytes:
        try:
            return zlib.decompress(bytes(data))
        except zlib.error as e:
            raise CompressorError(errno.EIO, "zlib decompress: %s" % e)


class ZstdCompressor(Compressor):
    """Zstandard (src/compressor/zstd/) at the reference's
    compressor_zstd_level default of 1, with persistent contexts."""

    name = "zstd"

    def __init__(self, level: int = 1):
        if not HAVE_ZSTD:
            raise ImportError("zstandard module not present")
        import zstandard
        self._mod = zstandard
        self.level = level
        self._cctx = zstandard.ZstdCompressor(level=level)
        self._dctx = zstandard.ZstdDecompressor()

    def compress(self, data: bytes) -> bytes:
        return self._cctx.compress(bytes(data))

    def decompress(self, data: bytes) -> bytes:
        try:
            return self._dctx.decompress(bytes(data))
        except self._mod.ZstdError as e:
            raise CompressorError(errno.EIO, "zstd decompress: %s" % e)


class SnappyCompressor(Compressor):
    name = "snappy"

    def __init__(self):
        if not HAVE_SNAPPY:
            raise ImportError("snappy module not present")
        import snappy
        self._mod = snappy

    def compress(self, data: bytes) -> bytes:
        return self._mod.compress(bytes(data))

    def decompress(self, data: bytes) -> bytes:
        try:
            return self._mod.decompress(bytes(data))
        except Exception as e:
            raise CompressorError(errno.EIO, "snappy decompress: %s" % e)


class Lz4Compressor(Compressor):
    name = "lz4"

    def __init__(self):
        if not HAVE_LZ4:
            raise ImportError("lz4 module not present")
        import lz4.block
        self._mod = lz4.block

    def compress(self, data: bytes) -> bytes:
        return self._mod.compress(bytes(data))

    def decompress(self, data: bytes) -> bytes:
        try:
            return self._mod.decompress(bytes(data))
        except Exception as e:
            raise CompressorError(errno.EIO, "lz4 decompress: %s" % e)


class DeviceBitplaneCompressor(Compressor):
    """The bit-plane container in a self-contained frame."""

    name = "jax_device"

    def compress(self, data: bytes) -> bytes:
        data = bytes(data)
        body, padded = fused_transform.bitplane_compress_host(data)
        return struct.pack("<II", len(data), padded) + body

    def decompress(self, data: bytes) -> bytes:
        data = bytes(data)
        try:
            raw_len, padded = struct.unpack_from("<II", data, 0)
            if padded % 64 or padded < raw_len:
                raise ValueError("bad frame header")
            out = fused_transform.bitplane_decompress(data[8:], padded)
            if len(out) < raw_len:
                raise ValueError("short frame")
            return out[:raw_len]
        except (ValueError, struct.error) as e:
            raise CompressorError(
                errno.EIO, "jax_device decompress: %s" % e)
