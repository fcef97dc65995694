"""SHEC — Shingled Erasure Code (multiple/single parity techniques).

Port of ``ceph_tpu/models/shec.py``. Parity target:
src/erasure-code/shec/ErasureCodeShec.{h,cc}. SHEC(k, m, c) trades
MDS-ness for repair locality: each parity row covers only a cyclic window
of data chunks, every data chunk is covered by c parities, and
single-chunk recovery reads ~k*c/m chunks instead of k.

Semantics:
  - parameter rules (defaults k=4, m=3, c=2; c <= m <= k, k <= 12,
    k+m <= 20; ErasureCodeShec.cc:280-335)
  - generator construction: Vandermonde coding matrix with entries zeroed
    outside each parity's shingle window, split into (m1,c1)/(m2,c2)
    groups chosen by the recovery-efficiency heuristic
    (shec_reedsolomon_coding_matrix :456-523,
    shec_calc_recovery_efficiency1 :415-454)
  - recovery planning: exhaustive parity-subset search minimizing first
    the parity count then the matrix size, with GF determinant checks
    (shec_make_decoding_matrix :526-754) — cached per (want, avail)
    signature like ErasureCodeShecTableCache
  - minimum_to_decode built from the same search (:69-121)

On the torch backend a decode is ONE launch of the GF bitmatrix kernel
per signature: the plan's inversion and the shingle-window parity
recompute precomposed into one compact decode matrix (``decode_batch``).
The stepwise host path stays as the numpy backend and the oracle.
"""

from __future__ import annotations

import errno
import itertools
import math
import threading

import numpy as np

from ..ops import gf
from ..utils import profile as profile_util
from .base import ErasureCodeError
from .matrix_base import MatrixErasureCode, _bank_pick, _constant
from .table_cache import TableCache, device_entry_key


def calc_recovery_efficiency1(k, m1, m2, c1, c2) -> float:
    # ErasureCodeShec.cc:415-454
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [10 ** 8] * k
    r_e1 = 0.0
    for (mm, cc_count) in ((m1, c1), (m2, c2)):
        for rr in range(mm):
            start = ((rr * k) // mm) % k
            end = (((rr + cc_count) * k) // mm) % k
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc],
                                  ((rr + cc_count) * k) // mm
                                  - (rr * k) // mm)
                cc = (cc + 1) % k
            r_e1 += ((rr + cc_count) * k) // mm - (rr * k) // mm
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


class Shec(MatrixErasureCode):
    """SHEC over the element-layout matrix kernel."""

    technique = "multiple"
    DEFAULT_K = "4"
    DEFAULT_M = "3"
    DEFAULT_C = "2"
    DEFAULT_W = "8"

    def __init__(self, backend: str = "torch", device=None,
                 single: bool = False):
        super().__init__(backend, device)
        self.c = 0
        self.single = single
        self._plan_cache: dict = {}
        self._fused_cache = TableCache()   # bounded LRU, thread-safe
        self._fused_bank_lock = threading.Lock()
        self._fused_bank_state: str | None = None
        self._fused_bank_index: dict | None = None

    def _reset_tables(self) -> None:
        super()._reset_tables()
        self._plan_cache.clear()
        self._fused_cache.clear()
        self._fused_bank_state = None
        self._fused_bank_index = None

    # -- profile -----------------------------------------------------------

    def parse(self, profile: dict, errors: list | None = None) -> None:
        # ErasureCodeShec.cc:271-362: all three of k/m/c defaulted
        # together, or all must be present.
        present = [n for n in ("k", "m", "c") if profile.get(n)]
        if not present:
            profile["k"], profile["m"], profile["c"] = (
                self.DEFAULT_K, self.DEFAULT_M, self.DEFAULT_C)
        elif len(present) < 3:
            raise ErasureCodeError(errno.EINVAL, "(k, m, c) must be chosen")
        super().parse(profile, errors)
        self.c = profile_util.to_int("c", profile, self.DEFAULT_C, errors)
        k, m, c = self.k, self.m, self.c
        if c <= 0:
            raise ErasureCodeError(errno.EINVAL, "c must be positive")
        if m < c:
            raise ErasureCodeError(errno.EINVAL,
                                   "c=%d must be <= m=%d" % (c, m))
        if k > 12:
            raise ErasureCodeError(errno.EINVAL, "k=%d must be <= 12" % k)
        if k + m > 20:
            raise ErasureCodeError(errno.EINVAL,
                                   "k+m=%d must be <= 20" % (k + m))
        if k < m:
            raise ErasureCodeError(errno.EINVAL,
                                   "m=%d must be <= k=%d" % (m, k))
        if self.w not in (8, 16, 32):
            raise ErasureCodeError(errno.EINVAL,
                                   "w must be one of {8, 16, 32}")

    def get_alignment(self) -> int:
        # ErasureCodeShec.cc:266-269
        return self.k * self.w * 4

    def get_chunk_size(self, object_size: int) -> int:
        # ErasureCodeShec.cc:59-67
        alignment = self.get_alignment()
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    # -- generator ---------------------------------------------------------

    def make_generator(self) -> np.ndarray:
        k, m, c = self.k, self.m, self.c
        if self.single:
            m1, c1 = 0, 0
        else:
            best = None
            for c1 in range(c // 2 + 1):
                for m1_ in range(m + 1):
                    c2, m2 = c - c1, m - m1_
                    if m1_ < c1 or m2 < c2:
                        continue
                    if (m1_ == 0) != (c1 == 0) or (m2 == 0) != (c2 == 0):
                        continue
                    r = calc_recovery_efficiency1(k, m1_, m2, c1, c2)
                    if r >= 0 and (best is None or r < best[0] - 1e-12):
                        best = (r, c1, m1_)
            if best is None:
                raise ErasureCodeError(errno.EINVAL,
                                       "no valid shec pattern")
            _, c1, m1 = best
        m2, c2 = m - m1, c - c1
        gen = gf.rs_vandermonde_generator(k, m, self.w)
        for rr in range(m1):
            end = ((rr * k) // m1) % k
            start = (((rr + c1) * k) // m1) % k
            cc = start
            while cc != end:
                gen[rr, cc] = 0
                cc = (cc + 1) % k
        for rr in range(m2):
            end = ((rr * k) // m2) % k
            start = (((rr + c2) * k) // m2) % k
            cc = start
            while cc != end:
                gen[m1 + rr, cc] = 0
                cc = (cc + 1) % k
        return gen

    # -- recovery planning (shec_make_decoding_matrix port) ----------------

    def _plan(self, want: frozenset, avail: frozenset):
        """Return (rows, cols, inv) or raise EIO.

        rows: chunk indices whose values feed the solve (selected
        parities + available data in their windows); cols: the data
        columns covered (including the erased ones); inv: [len, len] GF
        matrix with inv @ row_values = col_values.
        """
        key = (want, avail)
        plan = self._plan_cache.get(key)
        if plan is not None:
            return plan
        k, m = self.k, self.m
        mat = self.coding
        want_vec = [1 if i in want else 0 for i in range(k + m)]
        # wanting an erased parity implies wanting its window's data
        # (ErasureCodeShec.cc:539-547)
        for i in range(m):
            if want_vec[k + i] and (k + i) not in avail:
                for j in range(k):
                    if mat[i, j]:
                        want_vec[j] = 1
        mindup, minp = k + 1, k + 1
        best = None
        for pp in range(1 << m):
            p = [i for i in range(m) if pp >> i & 1]
            if len(p) > minp:
                continue
            if any((k + i) not in avail for i in p):
                continue
            tmprow = set(k + i for i in p)
            tmpcol = set(j for j in range(k)
                         if want_vec[j] and j not in avail)
            for i in p:
                for j in range(k):
                    if mat[i, j]:
                        tmpcol.add(j)
                        if j in avail:
                            tmprow.add(j)
            if len(tmprow) != len(tmpcol):
                continue
            dup = len(tmprow)
            if dup == 0:
                mindup, best = 0, ([], [], None)
                break
            if dup < mindup:
                rows = sorted(tmprow)
                cols = sorted(tmpcol)
                sub = np.zeros((dup, dup), dtype=np.int64)
                for ri, r in enumerate(rows):
                    for ci, col in enumerate(cols):
                        sub[ri, ci] = (1 if r == col else 0) if r < k \
                            else int(mat[r - k, col])
                try:
                    inv = gf.gf_invert_matrix(sub, self.w)
                except ValueError:
                    continue
                mindup = dup
                minp = len(p)
                best = (rows, cols, inv)
        if best is None:
            raise ErasureCodeError(errno.EIO, "can't find recover matrix")
        if len(self._plan_cache) > 4096:
            self._plan_cache.clear()
        self._plan_cache[key] = best
        return best

    # -- interface overrides ------------------------------------------------

    def minimum_to_decode(self, want_to_read: set, available: set) -> set:
        # ErasureCodeShec.cc:69-121 + :695-718
        for i in itertools.chain(want_to_read, available):
            if i < 0 or i >= self.k + self.m:
                raise ErasureCodeError(errno.EINVAL, "bad chunk id %d" % i)
        want = frozenset(want_to_read)
        avail = frozenset(available)
        rows, cols, _ = self._plan(want, avail)
        minimum = set(rows)
        k, m = self.k, self.m
        want_vec = [1 if i in want else 0 for i in range(k + m)]
        for i in range(m):
            if want_vec[k + i] and (k + i) not in avail:
                for j in range(k):
                    if self.coding[i, j]:
                        want_vec[j] = 1
        for i in range(k):
            if want_vec[i] and i in avail:
                minimum.add(i)
        for i in range(m):
            if want_vec[k + i] and (k + i) in avail and (k + i) not in minimum:
                if any(self.coding[i, j] and not want_vec[j]
                       for j in range(k)):
                    minimum.add(k + i)
        return minimum

    def decode(self, want_to_read: set, chunks: dict) -> dict:
        """Reconstruct only want_to_read (ErasureCodeShec::decode_chunks
        plans for the wanted chunks, which is what makes the
        minimum_to_decode locality contract work: the caller fetches the
        minimum set and decode must succeed from exactly that set)."""
        have = set(chunks)
        if want_to_read <= have:
            return {i: np.asarray(chunks[i], dtype=np.uint8)
                    for i in want_to_read}
        k, m = self.k, self.m
        avail = frozenset(chunks)
        want = frozenset(want_to_read - have)
        out = {i: np.asarray(b, dtype=np.uint8) for i, b in chunks.items()}
        rows, cols, inv = self._plan(want, avail)
        if inv is not None and rows:
            stacked = np.stack([out[r] for r in rows])[None]
            solved = self._apply_plan(inv, stacked)[0]
            for ci, col in enumerate(cols):
                out[col] = solved[ci]
        # wanted erased parity rows: their windows are now complete
        for i in range(m):
            if (k + i) in want and (k + i) not in out:
                window = [j for j in range(k) if self.coding[i, j]]
                if any(j not in out for j in window):
                    raise ErasureCodeError(errno.EIO, "window incomplete")
                row = self.coding[i:i + 1, window]
                stacked = np.stack([out[j] for j in window])[None]
                out[k + i] = self._apply_plan(
                    np.asarray(row), stacked)[0][0]
        missing = set(want_to_read) - set(out)
        if missing:
            raise ErasureCodeError(errno.EIO,
                                   "unable to read %s" % sorted(missing))
        return {i: out[i] for i in set(want_to_read) | have}

    def decode_all(self, chunks: dict) -> dict:
        """Reconstruct every chunk from the available ones (non-MDS aware:
        uses the shingle recovery search, not 'any k rows')."""
        k, m = self.k, self.m
        avail = frozenset(chunks)
        want = frozenset(i for i in range(k + m) if i not in avail)
        out = {i: np.asarray(b, dtype=np.uint8) for i, b in chunks.items()}
        if not want:
            return out
        rows, cols, inv = self._plan(want, avail)
        if inv is not None and rows:
            stacked = np.stack([out[r] for r in rows])[None]
            solved = self._apply_plan(inv, stacked)[0]
            for ci, col in enumerate(cols):
                out[col] = solved[ci]
        # erased parity rows recomputed from (now complete) data
        missing_parity = [i for i in range(m) if (k + i) not in out]
        if missing_parity:
            if any(j not in out for j in range(k)):
                raise ErasureCodeError(errno.EIO,
                                       "data incomplete for parity rebuild")
            data = np.stack([out[j] for j in range(k)])[None]
            parity = self.encode_batch(data)[0]
            for i in missing_parity:
                out[k + i] = parity[i]
        return out

    # -- fused device decode (one program per signature) -------------------

    #: precompute + device-upload the decode bank when the signature
    #: space (every recoverable erasure set of size <= m) is small
    FUSED_BANK_LIMIT = 512

    def _fused_decode_matrix(self, want: frozenset,
                             avail: frozenset) -> np.ndarray:
        """[n, n] GF matrix D with D @ full_chunks = all chunks, where
        full_chunks is the n-row layout with erased rows zeroed.

        Runs the recovery machinery SYMBOLICALLY: identity rows for
        survivors, the plan's inversion rows for solved data columns,
        and shingle-window parity recomposition as a GF combination of
        already-composed rows. The whole reconstruction then rides ONE
        xor_mm dispatch instead of a host loop per plan application
        (the reference measured its host path 5 orders below encode).
        Rows neither available nor wanted stay zero, matching the
        decode_batch contract."""
        k, m = self.k, self.m
        n = k + m
        rows, cols, inv = self._plan(want, avail)
        D = np.zeros((n, n), dtype=np.int64)
        for r in avail:
            D[r, r] = 1
        if inv is not None and rows:
            for ci, col in enumerate(cols):
                if col in avail:
                    continue   # identity row already serves it
                for j, r in enumerate(rows):
                    D[col, r] = int(inv[ci, j])
        # wanted erased parity rows: window recompute composed over the
        # (identity or solved) data rows
        for i in range(m):
            r = k + i
            if r not in want or r in avail:
                continue
            if np.any(D[r]):
                continue   # the plan already solved it
            window = [j for j in range(k) if self.coding[i, j]]
            if any(not np.any(D[j]) and j not in avail for j in window):
                raise ErasureCodeError(errno.EIO, "window incomplete")
            D[r] = gf.gf_matmul(self.coding[i:i + 1, :k],
                                D[:k, :], self.w)[0]
        return D

    def _ensure_fused_bank(self) -> bool:
        """Stack every full-reconstruction signature's COMPACT fused
        decode bitmatrix into one device upload per erasure count (the
        RS decode bank's analog, matrix_base._ensure_decode_bank): a
        cache miss then costs a view of the bank, not a host compose
        and a per-miss upload. Grouped by erased count because the
        compact matrix width is len(avail)*w — uniform within a group.
        Built for the torch backend when the signature space (every
        erasure set of size <= m) is at most FUSED_BANK_LIMIT."""
        if self._fused_bank_state is None:
            with self._fused_bank_lock:
                if self._fused_bank_state is None:
                    self._build_fused_bank()
        return self._fused_bank_state == "built"

    def _build_fused_bank(self) -> None:
        n = self.k + self.m
        count = sum(math.comb(n, e) for e in range(1, self.m + 1))
        if self.backend != "torch" or count > self.FUSED_BANK_LIMIT:
            self._fused_bank_state = "infeasible"
            return
        banks: dict = {}
        for e in range(1, self.m + 1):
            idx: dict = {}
            gfs, bms = [], []
            for erased in itertools.combinations(range(n), e):
                want = frozenset(erased)
                avail_t = tuple(i for i in range(n) if i not in want)
                try:
                    D = self._fused_decode_matrix(want, frozenset(avail_t))
                except ErasureCodeError:
                    continue   # unrecoverable signature
                Dc = D[:, list(avail_t)]
                idx[(want, avail_t)] = len(gfs)
                gfs.append(Dc)
                bms.append(gf.generator_to_bitmatrix(Dc, self.w))
            if gfs:
                banks[e] = (idx, gfs, bms,
                            _constant(np.stack(bms), self.device))
        self._fused_bank_index = banks
        self._fused_bank_state = "built"

    def _fused_entry(self, want: frozenset, avail_rows: tuple) -> dict:
        """Compact decode entry: [n, len(avail)] GF matrix whose
        columns follow avail_rows ORDER — applied straight to the
        caller's stacked chunks, no scatter pass. Raises EIO for an
        unrecoverable signature."""
        key = (want, avail_rows)
        entry = self._fused_cache.get(key)
        if entry is None:
            bank = None
            if self._ensure_fused_bank():
                bank = self._fused_bank_index.get(len(want))
            if bank is not None and key in bank[0]:
                idx, gfs, bms, dev = bank
                i = idx[key]
                entry = {"gf": gfs[i], "bitmat": bms[i],
                         device_entry_key(self.device):
                             _bank_pick(dev, np.int64(i))}
            else:
                D = self._fused_decode_matrix(want, frozenset(avail_rows))
                Dc = D[:, list(avail_rows)]
                entry = {"gf": Dc,
                         "bitmat": gf.generator_to_bitmatrix(Dc, self.w)}
            entry = self._fused_cache.put(key, entry)
        return entry

    def _apply_plan(self, inv: np.ndarray, stacked: np.ndarray) -> np.ndarray:
        return self._apply_matrix(inv, gf.generator_to_bitmatrix(inv, self.w),
                                  stacked)

    DECODE_BATCH_ANY = True

    def decode_batch(self, avail_rows: tuple, chunks,
                     want_rows: tuple | None = None):
        """Batched reconstruction from the given rows.

        Unlike the MDS codecs, avail_rows may be any recoverable subset
        (not necessarily of size k). want_rows names the rows the caller
        actually needs (default: every missing row) — the shingle plan
        only has to cover those, which is what makes sub-k local-repair
        reads work; rows neither available nor wanted come back as
        zeros and must not be consumed.

        torch backend: ONE kernel launch per signature — the plan's
        inversion + window recompute precomposed into a compact
        [n, len(avail)] matrix (served from a device-resident bank when
        the signature space is small). numpy backend keeps the stepwise
        host path, which doubles as the oracle."""
        if self.backend == "torch":
            return self._decode_batch_fused(avail_rows, chunks, want_rows)
        return self._decode_batch_host(avail_rows, chunks, want_rows)

    def _want(self, avail: frozenset, want_rows) -> frozenset:
        if want_rows is None:
            return frozenset(i for i in range(self.k + self.m)
                             if i not in avail)
        return frozenset(want_rows) - avail

    def _decode_batch_fused(self, avail_rows: tuple, chunks,
                            want_rows: tuple | None = None):
        avail_rows = tuple(avail_rows)
        want = self._want(frozenset(avail_rows), want_rows)
        entry = self._fused_entry(want, avail_rows)  # EIO if unrecov.
        return self._apply_matrix(entry["gf"], entry["bitmat"], chunks,
                                  entry)

    def _decode_batch_host(self, avail_rows: tuple, chunks: np.ndarray,
                           want_rows: tuple | None = None) -> np.ndarray:
        k, m = self.k, self.m
        avail = frozenset(avail_rows)
        want = self._want(avail, want_rows)
        row_of = {r: i for i, r in enumerate(avail_rows)}
        out = [None] * (k + m)
        for r in avail_rows:
            out[r] = chunks[:, row_of[r]]
        if want:
            rows, cols, inv = self._plan(want, avail)
            if inv is not None and rows:
                stacked = np.stack([out[r] for r in rows], axis=1)
                solved = self._apply_plan(inv, stacked)
                for ci, col in enumerate(cols):
                    out[col] = solved[:, ci]
            # wanted erased parity rows: recompute each from its OWN
            # shingle window (like decode()), not from all k data rows —
            # minimum_to_decode hands over only the window, and
            # demanding full data would EIO a recoverable parity
            for i in range(m):
                if (k + i) not in want or out[k + i] is not None:
                    continue
                window = [j for j in range(k) if self.coding[i, j]]
                if any(out[j] is None for j in window):
                    raise ErasureCodeError(errno.EIO,
                                           "window incomplete")
                row = self.coding[i:i + 1, window]
                stacked = np.stack([out[j] for j in window], axis=1)
                out[k + i] = self._apply_plan(row, stacked)[:, 0]
            still = [r for r in want if out[r] is None]
            if still:
                raise ErasureCodeError(errno.EIO,
                                       "unable to read %s" % sorted(still))
        zeros = None
        for r in range(k + m):
            if out[r] is None:
                if zeros is None:
                    zeros = np.zeros_like(np.asarray(chunks[:, 0]))
                out[r] = zeros
        return np.stack(out, axis=1)


class ShecMultiple(Shec):
    technique = "multiple"

    def __init__(self, backend: str = "torch", device=None):
        super().__init__(backend, device, single=False)


class ShecSingle(Shec):
    technique = "single"

    def __init__(self, backend: str = "torch", device=None):
        super().__init__(backend, device, single=True)
