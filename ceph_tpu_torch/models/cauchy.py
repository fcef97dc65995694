"""Cauchy Reed-Solomon bitmatrix codecs.

Port of ``ceph_tpu/models/cauchy.py``. Parity targets: cauchy_orig /
cauchy_good techniques of the reference jerasure plugin
(src/erasure-code/jerasure/ErasureCodeJerasure.cc:254-323): generator
built as a Cauchy matrix, expanded to a bitmatrix and applied at packet
granularity by the packet kernel.
"""

from __future__ import annotations

import numpy as np

from ..ops import gf
from .matrix_base import BitmatrixErasureCode


class CauchyOrig(BitmatrixErasureCode):
    technique = "cauchy_orig"
    DEFAULT_K = "7"
    DEFAULT_M = "3"
    DEFAULT_W = "8"

    def make_generator(self) -> np.ndarray:
        return gf.cauchy_original_generator(self.k, self.m, self.w)


class CauchyGood(BitmatrixErasureCode):
    technique = "cauchy_good"
    DEFAULT_K = "7"
    DEFAULT_M = "3"
    DEFAULT_W = "8"

    def make_generator(self) -> np.ndarray:
        return gf.cauchy_good_generator(self.k, self.m, self.w)
