"""Compressor interface.

Port of ``ceph_tpu/compressor/base.py`` (``Compressor``,
``CompressorError``), the role of the reference's Compressor
(src/compressor/Compressor.h): named algorithms, whole-buffer compress
and decompress.
"""

from __future__ import annotations

import abc

from ..errors import ErasureCodeError

__all__ = ["Compressor", "CompressorError"]


class CompressorError(ErasureCodeError):
    """errno-carrying compressor failure (same idiom as the EC side)."""


class Compressor(abc.ABC):
    """A named compression algorithm over byte buffers."""

    name = "generic"

    @abc.abstractmethod
    def compress(self, data: bytes) -> bytes: ...

    @abc.abstractmethod
    def decompress(self, data: bytes) -> bytes: ...

    def get_type_name(self) -> str:
        return self.name
