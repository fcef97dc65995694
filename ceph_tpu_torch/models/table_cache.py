"""Decode-table cache: bounded LRU keyed by erasure signature.

Port of ``ceph_tpu/models/table_cache.py``, the rendition of the ISA
plugin's table cache (src/erasure-code/isa/ErasureCodeIsaTableCache.{h,cc}):
the reference keeps an LRU of per-erasure-pattern decode tables so
repeated degraded reads skip the matrix inversion. Here each cached entry
also carries the bitplane expansion of the decode matrix and, once used on
a device, the device-resident copy keyed by that ``torch.device``.

The companion fast path (`xor_parity_rows` / `xor_recover`) is the analog
of the reference's single-erasure region-XOR shortcut
(src/erasure-code/isa/xor_op.{h,cc}): when exactly one chunk is missing
and the first parity row is a plain XOR of the data (true for
RS-Vandermonde), recovery is a pure XOR over the surviving chunks.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["TableCache", "device_entry_key", "xor_parity_rows",
           "xor_recover"]

# The reference sizes its cache for the largest supported (k,m)=(12,4)
# pattern space (ErasureCodeIsaTableCache.cc); 4096 covers C(16,4) and
# keeps the host-side footprint bounded.
DEFAULT_CAPACITY = 4096


def device_entry_key(device: torch.device) -> str:
    """Entry-dict key under which the copy of a decode bitmatrix on
    `device` lives ("bitmat_dev@cuda:0"), so two devices sharing one
    cached table each keep their own copy. A bare "cuda" is keyed as the
    current CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return "bitmat_dev@%s" % device


class TableCache:
    """Thread-safe bounded LRU of decode-table entries.

    Keys are erasure signatures (the sorted tuple of available logical
    chunk rows); values are dicts carrying the GF decode matrix, its
    bitmatrix expansion, and (lazily) the device-side copies.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, signature: tuple):
        with self._lock:
            entry = self._entries.get(signature)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(signature)
            self.hits += 1
            return entry

    def put(self, signature: tuple, entry: dict) -> dict:
        """Insert; returns the winning entry (first writer wins on a race)."""
        with self._lock:
            existing = self._entries.get(signature)
            if existing is not None:
                return existing
            self._entries[signature] = entry
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
            return entry

    def clear(self) -> None:
        """Drop all entries and reset stats (a re-prepare is a new config)."""
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.evictions = 0

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


def xor_parity_rows(bitmat: np.ndarray, k: int, w: int) -> list[int]:
    """Parity rows of an encode bitmatrix that are plain XORs of the data.

    Parity row r qualifies when its w x (k*w) bitplane block is k identity
    blocks — multiplying every data chunk by 1 and XOR-accumulating. Row 0
    qualifies for every RAID-6-style technique in the jerasure family.
    """
    rows = []
    m = bitmat.shape[0] // w
    eye = np.eye(w, dtype=bitmat.dtype)
    for r in range(m):
        block = bitmat[r * w:(r + 1) * w].reshape(w, k, w).swapaxes(0, 1)
        if all(np.array_equal(block[c], eye) for c in range(k)):
            rows.append(r)
    return rows


def xor_recover(chunks: dict) -> np.ndarray:
    """XOR all buffers together: the recovery kernel of the fast path.

    `chunks` holds the surviving members of an XOR group (every row of
    {0..k-1, k+xor_row} except the missing one); their byte-wise XOR IS
    the missing row. Pure host bandwidth — no GF math, no device.
    """
    out = None
    for buf in chunks.values():
        buf = np.asarray(buf, dtype=np.uint8)
        out = buf.copy() if out is None else np.bitwise_xor(out, buf, out=out)
    return out
