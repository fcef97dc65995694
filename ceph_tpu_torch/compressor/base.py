"""Compressor interface and compression policy.

Port of ``ceph_tpu/compressor/base.py``, the role of Ceph's Compressor
(src/compressor/Compressor.{h,cc}): named algorithms, whole-buffer
compress and decompress, and the BlueStore-facing compression modes
(``CompressionMode``: none / passive / aggressive / force) with the
required-ratio admission check (bluestore_compression_required_ratio).
"""

from __future__ import annotations

import abc
import errno

from ..errors import ErasureCodeError

__all__ = ["Compressor", "CompressorError", "MODE_NONE", "MODE_PASSIVE",
           "MODE_AGGRESSIVE", "MODE_FORCE", "should_compress",
           "compress_if_worthwhile"]


class CompressorError(ErasureCodeError):
    """errno-carrying compressor failure (same idiom as the EC side)."""


# Compression modes (Compressor.h COMP_NONE/PASSIVE/AGGRESSIVE/FORCE).
MODE_NONE = "none"
MODE_PASSIVE = "passive"        # compress only if hinted compressible
MODE_AGGRESSIVE = "aggressive"  # compress unless hinted incompressible
MODE_FORCE = "force"            # always compress

_MODES = (MODE_NONE, MODE_PASSIVE, MODE_AGGRESSIVE, MODE_FORCE)


class Compressor(abc.ABC):
    """A named compression algorithm over byte buffers."""

    name = "generic"

    @abc.abstractmethod
    def compress(self, data: bytes) -> bytes: ...

    @abc.abstractmethod
    def decompress(self, data: bytes) -> bytes: ...

    def get_type_name(self) -> str:
        return self.name


def should_compress(mode: str, hint_compressible: bool = False,
                    hint_incompressible: bool = False) -> bool:
    """BlueStore's admission policy for a write (Compressor.h modes)."""
    if mode not in _MODES:
        raise CompressorError(errno.EINVAL,
                              "unknown compression mode %r" % mode)
    if mode == MODE_NONE:
        return False
    if mode == MODE_FORCE:
        return True
    if mode == MODE_PASSIVE:
        return hint_compressible
    return not hint_incompressible  # aggressive


def compress_if_worthwhile(compressor: Compressor | None, data: bytes,
                           required_ratio: float = 0.875):
    """Compress, and keep the result only if it paid off.

    Returns (algorithm name or None, payload): a compressed blob is kept
    only when len(out) <= len(in) * required_ratio
    (bluestore_compression_required_ratio, default 0.875)."""
    if compressor is None or not data:
        return None, data
    out = compressor.compress(data)
    if len(out) <= len(data) * required_ratio:
        return compressor.get_type_name(), out
    return None, data
