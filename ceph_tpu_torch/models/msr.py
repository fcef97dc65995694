"""Product-matrix MSR regenerating codec (repair-bandwidth-optimal).

Port of ``ceph_tpu/models/msr.py``: the minimum-storage-regenerating
point of the product-matrix construction (Rashmi/Shah/Kumar, "Fast
Product-Matrix Regenerating Codes"). Each of the n = k+m nodes stores
alpha = k-1 sub-symbols per chunk, and a lost chunk is rebuilt from
d = 2(k-1) helpers that each ship beta = 1 sub-symbol: chunk/alpha bytes
instead of a full chunk. Repair moves d*chunk/alpha = 2*chunk bytes,
whatever k is, against k*chunk for a Reed-Solomon rebuild.

Construction (all GF(2^8)):

  - Message matrix M = [[S1], [S2]] (2alpha x alpha) with S1, S2
    symmetric, holding B = alpha*(alpha+1) = k*alpha free symbols.
  - Encoding matrix Psi (n x d) is Vandermonde: row i is
    (1, x_i, ..., x_i^(d-1)); Phi_i = its first alpha entries and
    lambda_i = x_i^alpha. The x_i are picked greedily so that the lambda_i
    are distinct. Node i stores Psi_i . M (alpha sub-symbols).
  - Systematic precode: G_sys = G_full . inv(G_full[:k*alpha]), where
    G_full expands Psi over the symmetric basis of (S1, S2). Data chunks
    stay raw; the parity rows are G_sys[k*alpha:].

Repair of node f from helpers H (|H| = d): every helper ships the same
projection Phi_f . chunk_i (the chunk seen as [alpha, sub]); the primary
stacks the d fractions and applies C = [I_alpha | lambda_f*I_alpha] .
inv(Psi_H) ([alpha x d]), which gives back the chunk.

Encode, decode, the fraction and the combine are all element-layout GF
products on sub-symbol rows (``[B, rows*alpha, N/alpha]``), so on the
torch backend each is a launch of the GF bitmatrix kernel
(``ops/gf_kernel.py``) through ``xor_mm.matrix_encode``: at k=8, m=7 the
encode ``[392, 448]`` and every decode ``[840, 448]`` take the popcount
design, the fraction ``[8, 56]`` and the combine ``[56, 112]`` the
bit-sliced one; past 512 columns (k >= 10) the product is split into
column blocks, one launch each.
"""

from __future__ import annotations

import errno

import numpy as np

from ..ops import gf, gf_ref
from .base import ErasureCodeError
from .matrix_base import LARGEST_VECTOR_WORDSIZE, MatrixErasureCode

__all__ = ["MsrProductMatrix"]


def _symmetric_basis(alpha: int) -> list[tuple[int, int]]:
    """Index pairs (p, q), p <= q, enumerating a symmetric alpha x alpha
    matrix's free entries."""
    return [(p, q) for p in range(alpha) for q in range(p, alpha)]


class MsrProductMatrix(MatrixErasureCode):
    """Product-matrix MSR codec: alpha = k-1, d = 2(k-1), beta = 1."""

    technique = "msr"
    DEFAULT_K = "8"
    DEFAULT_M = "7"   # repair needs n-1 >= d, i.e. m >= k-1
    DEFAULT_W = "8"

    def __init__(self, backend: str = "torch", device=None):
        super().__init__(backend, device)
        self.alpha = 0
        self.d = 0
        self._x: list[int] = []          # evaluation points, len n
        self._lam: list[int] = []        # x_i^alpha, all distinct
        self._psi: np.ndarray | None = None  # [n, d] Vandermonde
        self._g_sys: np.ndarray | None = None  # [n*alpha, k*alpha]

    # -- profile -----------------------------------------------------------

    def parse(self, profile: dict, errors: list | None = None) -> None:
        super().parse(profile, errors)
        self.per_chunk_alignment = False
        if self.w != 8:
            bad = self.w
            profile["w"] = "8"
            self.w = 8
            raise ErasureCodeError(
                errno.EINVAL, "w=%d must be 8 for technique=msr" % bad)
        if self.k < 3:
            raise ErasureCodeError(
                errno.EINVAL,
                "k=%d must be >= 3 for technique=msr (alpha = k-1 >= 2)"
                % self.k)
        if self.m < self.k - 1:
            raise ErasureCodeError(
                errno.EINVAL,
                "m=%d must be >= k-1=%d for technique=msr (repair degree "
                "d = 2(k-1) needs n-1 >= d helpers)" % (self.m, self.k - 1))
        self.alpha = self.k - 1
        self.d = 2 * (self.k - 1)
        # the derived repair geometry, echoed back into the profile
        profile["d"] = str(self.d)
        profile["beta"] = str(1)
        profile["alpha"] = str(self.alpha)

    def get_alignment(self) -> int:
        # a chunk splits into alpha sub-symbol rows of whole SIMD words
        return self.k * self.alpha * LARGEST_VECTOR_WORDSIZE

    # -- construction ------------------------------------------------------

    def _pick_points(self) -> list[int]:
        """Greedy x_i selection: distinct nonzero field elements whose
        powers lambda = x^alpha are pairwise distinct."""
        n = self.k + self.m
        xs: list[int] = []
        lams: set[int] = set()
        for cand in range(1, 1 << self.w):
            lam = gf.gf_pow(cand, self.alpha, self.w)
            if lam in lams:
                continue
            xs.append(cand)
            lams.add(lam)
            if len(xs) == n:
                return xs
        raise ValueError(
            "cannot pick %d evaluation points with distinct x^%d in "
            "GF(2^%d)" % (n, self.alpha, self.w))

    def _full_generator(self) -> np.ndarray:
        """G_full [n*alpha, B]: coefficient of message parameter t in
        stored sub-symbol a of node i, expanding Psi_i . M over the
        symmetric bases of S1 and S2."""
        n = self.k + self.m
        alpha = self.alpha
        basis = _symmetric_basis(alpha)
        G = np.zeros((n * alpha, 2 * len(basis)), dtype=np.uint8)
        for i in range(n):
            for a in range(alpha):
                row = G[i * alpha + a]
                for half in range(2):  # 0 -> S1 (Psi cols 0..alpha-1),
                    off = half * alpha  # 1 -> S2 (cols alpha..2alpha-1)
                    for t, (p, q) in enumerate(basis):
                        c = 0
                        if a == q:
                            c ^= self._psi[i, off + p]
                        if a == p and p != q:
                            c ^= self._psi[i, off + q]
                        row[half * len(basis) + t] = c
        return G

    def make_generator(self) -> np.ndarray:
        n = self.k + self.m
        alpha, d = self.alpha, self.d
        self._x = self._pick_points()
        self._lam = [gf.gf_pow(x, alpha, self.w) for x in self._x]
        psi = np.zeros((n, d), dtype=np.uint8)
        for i, x in enumerate(self._x):
            for j in range(d):
                psi[i, j] = gf.gf_pow(x, j, self.w)
        self._psi = psi
        g_full = self._full_generator()
        ka = self.k * alpha
        g_inv = gf.gf_invert_matrix(g_full[:ka], self.w)
        self._g_sys = gf.gf_matmul(g_full, g_inv, self.w)
        if not np.array_equal(self._g_sys[:ka],
                              np.eye(ka, dtype=np.uint8)):
            raise ValueError("msr systematic precode is not identity")
        # parity generator in sub-symbol space: [m*alpha, k*alpha]
        return self._g_sys[ka:].copy()

    def _xor_parity_rows(self) -> list[int]:
        # no region-XOR planner: the bitmatrix's column blocks are
        # sub-symbol rows, not chunks
        return []

    # -- sub-symbol reshaping ----------------------------------------------

    def _sub_width(self, n_bytes: int) -> int:
        if n_bytes % self.alpha:
            raise ErasureCodeError(
                errno.EINVAL,
                "chunk size %d is not a multiple of alpha=%d"
                % (n_bytes, self.alpha))
        return n_bytes // self.alpha

    def _split(self, data, rows: int):
        """[B, rows, N] -> [B, rows*alpha, N/alpha] sub-symbol view."""
        b, r, n = data.shape
        if r != rows:
            raise ErasureCodeError(
                errno.EINVAL, "expected %d chunk rows, got %d" % (rows, r))
        return data.reshape(b, r * self.alpha, self._sub_width(n))

    # -- batched API (numpy in, numpy out; a tensor stays on its device) ----

    def encode_batch(self, data):
        b, k, n = data.shape
        out = self._apply_matrix(self.coding, self._bitmat,
                                 self._split(data, self.k))
        return out.reshape(b, self.m, n)

    def decode_batch(self, avail_rows: tuple, chunks):
        if len(avail_rows) != self.k:
            raise ErasureCodeError(errno.EIO, "need exactly k chunks")
        b, k, n = chunks.shape
        entry = self._decode_entry(tuple(avail_rows))
        out = self._apply_matrix(entry["gf"], entry["bitmat"],
                                 self._split(chunks, self.k), entry)
        return out.reshape(b, self.k + self.m, n)

    def _full_decode_matrix(self, avail_rows: tuple) -> np.ndarray:
        """[n*alpha, k*alpha] sub-symbol matrix mapping the k available
        chunks (stacked in avail_rows order) to every chunk."""
        rows = [i * self.alpha + a for i in avail_rows
                for a in range(self.alpha)]
        inv = gf.gf_invert_matrix(self._g_sys[rows], self.w)
        return gf.gf_matmul(self._g_sys, inv, self.w)

    # -- repair capability -------------------------------------------------

    def supports_repair(self) -> bool:
        return True

    def repair_fraction(self) -> float:
        """Fraction of a chunk each helper ships (beta/alpha)."""
        return 1.0 / self.alpha

    def repair_helper_count(self) -> int:
        return self.d

    def repair_sub_size(self, chunk_size: int) -> int:
        """Bytes of one shipped fraction for a given chunk size."""
        return self._sub_width(chunk_size)

    def _logical(self, phys: int) -> int:
        n = self.get_chunk_count()
        inv = {self.chunk_index(i): i for i in range(n)}
        if phys not in inv:
            raise ErasureCodeError(
                errno.EINVAL, "chunk %d is not in the mapping" % phys)
        return inv[phys]

    def minimum_to_repair(self, target: int, available: set) -> set:
        """d helper chunks (physical ids) for rebuilding `target`: any d
        survivors work (every d rows of Psi are independent), so the d
        lowest, for determinism."""
        cands = sorted(a for a in available if a != target)
        if len(cands) < self.d:
            raise ErasureCodeError(
                errno.EIO,
                "need %d helpers to repair, only %d available"
                % (self.d, len(cands)))
        return set(cands[:self.d])

    # -- repair matrices, cached beside the decode entries -------------------

    def _fraction_entry(self, target: int) -> dict:
        """[1, alpha] projection every helper applies for target f:
        Phi_f = (1, x_f, ..., x_f^(alpha-1))."""
        f = self._logical(target)
        key = ("frac", f)
        entry = self._decode_cache.get(key)
        if entry is None:
            phi = self._psi[f:f + 1, :self.alpha].copy()
            entry = self._decode_cache.put(
                key, {"gf": phi,
                      "bitmat": gf.generator_to_bitmatrix(phi, self.w)})
        return entry

    def _combine_entry(self, target: int, helpers: tuple) -> dict:
        """[alpha, d] matrix turning the stacked helper fractions (in
        `helpers` order, physical ids) back into target's chunk."""
        f = self._logical(target)
        key = ("comb", f, tuple(helpers))
        entry = self._decode_cache.get(key)
        if entry is None:
            hl = [self._logical(h) for h in helpers]
            if len(hl) != self.d or f in hl:
                raise ErasureCodeError(
                    errno.EINVAL, "repair needs %d helpers excluding the "
                    "target" % self.d)
            inv = gf.gf_invert_matrix(self._psi[hl], self.w)
            lam = np.zeros((self.alpha, self.d), dtype=np.uint8)
            for a in range(self.alpha):
                lam[a, a] = 1
                lam[a, self.alpha + a] = self._lam[f]
            comb = gf.gf_matmul(lam, inv, self.w)
            entry = self._decode_cache.put(
                key, {"gf": comb,
                      "bitmat": gf.generator_to_bitmatrix(comb, self.w)})
        return entry

    # -- repair batched API --------------------------------------------------

    def repair_fraction_batch(self, target: int, chunks):
        """Helper-side projection: [B, N] chunk streams -> [B, N/alpha]
        fractions for rebuilding `target` (physical id). The projection
        is the same for every helper, so the helper's own id is not
        needed."""
        b, n = chunks.shape
        entry = self._fraction_entry(target)
        sub = chunks.reshape(b, self.alpha, self._sub_width(n))
        out = self._apply_matrix(entry["gf"], entry["bitmat"], sub, entry)
        return out.reshape(b, self._sub_width(n))

    def repair_combine_batch(self, target: int, helpers: tuple, fractions):
        """Primary-side combine: [B, d, sub] fractions (rows in `helpers`
        order) -> [B, alpha*sub] = [B, chunk] rebuilt target chunks."""
        b, d, sub = fractions.shape
        if d != self.d:
            raise ErasureCodeError(
                errno.EIO, "combine needs %d fractions, got %d"
                % (self.d, d))
        entry = self._combine_entry(target, tuple(helpers))
        out = self._apply_matrix(entry["gf"], entry["bitmat"],
                                 fractions, entry)
        return out.reshape(b, self.alpha * sub)

    def repair_oracle(self, target: int, helpers: tuple,
                      chunks: dict) -> np.ndarray:
        """Host reference: the whole repair from helper chunk bytes, the
        fraction and the combine on ``gf_ref``; the bit-identity oracle of
        the tests and ``chip_smoke.py``."""
        frac_entry = self._fraction_entry(target)
        comb_entry = self._combine_entry(target, tuple(helpers))
        fracs = []
        for h in helpers:
            chunk = np.asarray(chunks[h], dtype=np.uint8)
            sub = chunk.reshape(self.alpha, self._sub_width(chunk.size))
            fracs.append(gf_ref.matrix_encode_ref(
                frac_entry["gf"], sub, self.w)[0])
        return gf_ref.matrix_encode_ref(
            comb_entry["gf"], np.stack(fracs), self.w).reshape(-1)
