"""The bit-plane compressor of the fused write transform, as a plugin.

Port of ``ceph_tpu/compressor/plugins.py:100-134``
(``JaxDeviceCompressor``), named ``jax_device`` as the reference names
it, so pool options and tooling name the algorithm alike. The OSD write
path runs this stage on the device inside the fused write transform
(``osd/fused_transform.py``, the K3 kernel); the plugin exposes the same
container standalone, on the host, over ``bitplane_compress_host`` and
``bitplane_decompress``.

Self-contained frame: an 8-byte header (``<II``: raw_len, padded_len),
then the bit-plane container. The fused path instead carries raw_len and
padded_len in the object's HashInfo comp_info.
"""

from __future__ import annotations

import errno
import struct

from ..osd import fused_transform
from .base import Compressor, CompressorError

__all__ = ["DeviceBitplaneCompressor"]


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
