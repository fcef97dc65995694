"""Liberation-family RAID-6 bitmatrix codecs.

Port of ``ceph_tpu/models/liberation.py``: technique parity with the
reference jerasure plugin
(src/erasure-code/jerasure/ErasureCodeJerasure.h:197-257: liberation,
blaum_roth, liber8tion), with the constructions of the published
descriptions:

  - liberation: Plank, "The RAID-6 Liberation Codes" (FAST'08). w prime,
    k <= w, m = 2. Q column i is the cyclic shift X^i plus one extra bit
    for i > 0 — NOT GF(2^w)-linear, hence a pure bitmatrix code.
  - blaum_roth: Blaum & Roth codes over the ring
    GF(2)[x]/M_p(x), M_p = 1+x+...+x^{p-1}, with p = w+1 prime. Q column
    i is the multiply-by-x^i matrix in that ring.
  - liber8tion: w = 8, m = 2, k <= 8 (Plank, "The RAID-6 Liber8tion
    Code"), as the GF(2^8) generator [1...1; 1, g, g^2, ...] (same
    geometry and erasure coverage as the published search-derived
    tables, a denser XOR schedule).

All three run on the packet-layout machinery (BitmatrixErasureCode ->
the packet kernel), with the packetsize semantics of the cauchy family.

The decode of the pure bitmatrix codes is GF(2) Gaussian elimination over
the stacked [I; coding] bitmatrix — the analog of the GF-domain
decode-matrix inversion the generator codecs use.
"""

from __future__ import annotations

import errno

import numpy as np

from ..ops import gf
from .base import ErasureCodeError
from .matrix_base import BitmatrixErasureCode

__all__ = ["Liberation", "BlaumRoth", "Liber8tion", "binary_invert"]


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for d in range(2, int(n ** 0.5) + 1):
        if n % d == 0:
            return False
    return True


def binary_invert(a: np.ndarray) -> np.ndarray:
    """Invert a square 0/1 matrix over GF(2); ValueError when singular."""
    a = np.asarray(a, dtype=np.uint8) & 1
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError("binary_invert needs a square matrix")
    aug = np.concatenate([a, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = col + int(np.argmax(aug[col:, col]))
        if aug[piv, col] == 0:
            raise ValueError("singular bitmatrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        mask = aug[:, col].copy()
        mask[col] = 0
        aug ^= np.outer(mask, aug[col])
    return np.ascontiguousarray(aug[:, n:])


class PureBitmatrixCode(BitmatrixErasureCode):
    """Bitmatrix codec whose parity is NOT GF(2^w)-linear.

    The encode matrix comes from make_bitmatrix(); decode entries are
    built by inverting the k*w x k*w binary submatrix of the stacked
    [identity; coding] bitmatrix selected by the surviving chunks. There
    is no GF generator (``coding`` is None) and so no decode bank.
    """

    def make_bitmatrix(self) -> np.ndarray:
        raise NotImplementedError

    def _check_geometry(self, primality_ok: bool = False) -> None:
        if not primality_ok and not _is_prime(self.w):
            raise ErasureCodeError(
                errno.EINVAL,
                "w=%d must be prime for %s" % (self.w, self.technique))
        if self.k > self.w:
            raise ErasureCodeError(
                errno.EINVAL,
                "k=%d must be <= w=%d for %s" % (self.k, self.w,
                                                 self.technique))
        self.require_word_packetsize()

    def prepare(self) -> None:
        try:
            self._bitmat = np.ascontiguousarray(
                self.make_bitmatrix().astype(np.uint8))
        except ValueError as e:
            raise ErasureCodeError(errno.EINVAL, str(e))
        self.coding = None
        self._reset_tables()

    def _stacked_bitmat(self) -> np.ndarray:
        kw = self.k * self.w
        return np.concatenate(
            [np.eye(kw, dtype=np.uint8), self._bitmat], axis=0)

    def _decode_entry(self, avail_rows: tuple):
        if len(avail_rows) != self.k:
            raise ErasureCodeError(errno.EIO, "need exactly k chunks")
        entry = self._decode_cache.get(avail_rows)
        if entry is None:
            full = self._stacked_bitmat()
            sub = np.concatenate(
                [full[r * self.w:(r + 1) * self.w] for r in avail_rows])
            try:
                inv = binary_invert(sub)
            except ValueError:
                raise ErasureCodeError(
                    errno.EIO, "erasure pattern %r is not decodable"
                    % (avail_rows,))
            dec = (full.astype(np.uint16) @ inv.astype(np.uint16)) % 2
            entry = self._decode_cache.put(
                avail_rows, {"gf": None, "bitmat": dec.astype(np.uint8)})
        return entry


class Liberation(PureBitmatrixCode):
    """RAID-6 liberation code: w prime, k <= w, m = 2."""

    technique = "liberation"
    DEFAULT_K = "2"
    DEFAULT_M = "2"
    DEFAULT_W = "7"

    def parse(self, profile: dict, errors: list | None = None) -> None:
        profile["m"] = "2"  # P+Q only, like reed_sol_r6_op
        super().parse(profile, errors)
        self._check_geometry()

    def make_bitmatrix(self) -> np.ndarray:
        k, w = self.k, self.w
        mat = np.zeros((2 * w, k * w), dtype=np.uint8)
        for i in range(k):
            for j in range(w):
                mat[j, i * w + j] = 1                      # P: identity
                mat[w + j, i * w + (j + i) % w] = 1        # Q: shift by i
            if i > 0:
                j = (i * ((w - 1) // 2)) % w               # the extra bit
                mat[w + j, i * w + (j + i - 1) % w] ^= 1
        return mat


class BlaumRoth(PureBitmatrixCode):
    """RAID-6 Blaum-Roth code over GF(2)[x]/M_p(x), p = w+1 prime."""

    technique = "blaum_roth"
    DEFAULT_K = "2"
    DEFAULT_M = "2"
    DEFAULT_W = "6"

    def parse(self, profile: dict, errors: list | None = None) -> None:
        profile["m"] = "2"
        super().parse(profile, errors)
        if not _is_prime(self.w + 1):
            raise ErasureCodeError(
                errno.EINVAL,
                "w=%d: w+1 must be prime for blaum_roth" % self.w)
        self._check_geometry(primality_ok=True)

    def make_bitmatrix(self) -> np.ndarray:
        k, w = self.k, self.w
        p = w + 1
        mat = np.zeros((2 * w, k * w), dtype=np.uint8)
        for i in range(k):
            for j in range(w):
                mat[j, i * w + j] = 1                      # P: identity
            # Q column block i: multiply-by-x^i in GF(2)[x]/M_p(x).
            # x^p = 1 in the ring; x^w reduces to 1 + x + ... + x^{w-1}.
            for c in range(w):
                e = (c + i) % p
                if e == w:
                    mat[w:2 * w, i * w + c] ^= 1
                else:
                    mat[w + e, i * w + c] ^= 1
        return mat


class Liber8tion(BitmatrixErasureCode):
    """RAID-6 with w fixed at 8, k <= 8, m = 2.

    GF(2^8) generator [1...1; 1, g, g^2, ...] in bitmatrix form (see the
    module docstring). Its C(k+2, k) <= 45 signatures ride the decode
    bank ([45, 80, 64] at k = 8).
    """

    technique = "liber8tion"
    DEFAULT_K = "2"
    DEFAULT_M = "2"
    DEFAULT_W = "8"

    def parse(self, profile: dict, errors: list | None = None) -> None:
        profile["m"] = "2"
        profile.setdefault("w", "8")
        super().parse(profile, errors)
        if self.w != 8:
            raise ErasureCodeError(
                errno.EINVAL, "w=%d must be 8 for liber8tion" % self.w)
        if self.k > 8:
            raise ErasureCodeError(
                errno.EINVAL, "k=%d must be <= 8 for liber8tion" % self.k)
        self.require_word_packetsize()

    def make_generator(self) -> np.ndarray:
        gen = np.zeros((2, self.k), dtype=np.int64)
        gen[0, :] = 1
        for i in range(self.k):
            gen[1, i] = gf.gf_pow(2, i, 8)
        return gen
