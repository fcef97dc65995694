"""Trivial k=2, m=1 XOR codec, the interface's own test fixture.

Port of ``ceph_tpu/models/xor_example.py``. Parity target:
ErasureCodeExample (src/test/erasure-code/ErasureCodeExample.h:38), a
minimal in-tree code that exercises the interface and the registry
without real codec math. It runs in numpy on the host, as the
reference's does.
"""

from __future__ import annotations

import errno

import numpy as np

from .base import ErasureCode, ErasureCodeError


class XorExample(ErasureCode):
    technique = "xor"

    def get_chunk_count(self) -> int:
        return 3

    def get_data_chunk_count(self) -> int:
        return 2

    def get_chunk_size(self, object_size: int) -> int:
        return -(-object_size // 2)

    def minimum_to_decode_with_cost(self, want_to_read, available):
        # With every chunk available, drop the strictly most expensive one
        # and recover it from the other two instead of reading it
        # (ErasureCodeExample.h:64-92).
        c2c = dict(available)
        if len(c2c) > 2:
            for victim in (0, 1, 2):
                others = [c2c[i] for i in (0, 1, 2) if i != victim]
                if all(c2c[victim] > c for c in others):
                    del c2c[victim]
                    break
        return self.minimum_to_decode(want_to_read, set(c2c))

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        return data[:, 0:1] ^ data[:, 1:2]

    def decode_batch(self, avail_rows: tuple, chunks: np.ndarray
                     ) -> np.ndarray:
        if len(avail_rows) != 2:
            raise ErasureCodeError(errno.EIO, "need 2 chunks")
        a, b = avail_rows
        x = chunks[:, 0]
        y = chunks[:, 1]
        missing = ({0, 1, 2} - {a, b}).pop()
        out = {a: x, b: y, missing: x ^ y}
        return np.stack([out[0], out[1], out[2]], axis=1)
