"""Reed-Solomon matrix codecs: Vandermonde and RAID6 P+Q.

Port of ``ceph_tpu/models/rs.py``. Parity targets: the reed_sol_van /
reed_sol_r6_op techniques of the reference jerasure plugin
(src/erasure-code/jerasure/ErasureCodeJerasure.cc:150-251, defaults at
ErasureCodeJerasure.h:90-121): w restricted to {8,16,32}, RAID6 forces
m=2, alignment formulas shared with MatrixErasureCode.
"""

from __future__ import annotations

import errno

import numpy as np

from ..ops import gf
from .base import ErasureCodeError
from .matrix_base import MatrixErasureCode


class ReedSolomonVandermonde(MatrixErasureCode):
    technique = "reed_sol_van"
    DEFAULT_K = "7"
    DEFAULT_M = "3"
    DEFAULT_W = "8"

    def parse(self, profile: dict, errors: list | None = None) -> None:
        super().parse(profile, errors)
        if self.w not in (8, 16, 32):
            bad = self.w
            profile["w"] = "8"
            self.w = 8
            raise ErasureCodeError(
                errno.EINVAL, "w=%d must be one of {8, 16, 32}" % bad)

    def make_generator(self) -> np.ndarray:
        return gf.rs_vandermonde_generator(self.k, self.m, self.w)


class ReedSolomonRAID6(MatrixErasureCode):
    technique = "reed_sol_r6_op"
    DEFAULT_K = "7"
    DEFAULT_M = "2"
    DEFAULT_W = "8"

    def parse(self, profile: dict, errors: list | None = None) -> None:
        # RAID6 always has m=2 (ErasureCodeJerasure.cc:232-246).
        profile.pop("m", None)
        super().parse(profile, errors)
        self.m = 2
        profile["m"] = "2"
        if self.w not in (8, 16, 32):
            profile["w"] = "8"
            self.w = 8
            raise ErasureCodeError(
                errno.EINVAL, "w must be one of {8, 16, 32}")

    def make_generator(self) -> np.ndarray:
        return gf.rs_r6_generator(self.k, self.w)
