"""Shared machinery for generator-matrix codecs (jerasure-style techniques).

Port of ``ceph_tpu/models/matrix_base.py``. Covers both encode styles
of the reference jerasure plugin
(src/erasure-code/jerasure/ErasureCodeJerasure.cc):

  - MatrixErasureCode: element-layout GF(2^w) matrix codes
    (reed_sol_van, reed_sol_r6_op; jerasure_matrix_encode semantics),
    applied by the GF bitmatrix kernel (:mod:`ceph_tpu_torch.ops.gf_kernel`).
  - BitmatrixErasureCode: packet-layout bitmatrix codes
    (cauchy_*, liberation, blaum_roth, liber8tion;
    jerasure_schedule_encode semantics with `packetsize`), applied by the
    packet kernel (:mod:`ceph_tpu_torch.ops.packet_kernel`).

The generator (or cached decode matrix — the analog of
ErasureCodeIsaTableCache, src/erasure-code/isa/ErasureCodeIsaTableCache.cc)
expands to a 0/1 bitplane matrix that the layout's kernel applies.

Backends: "torch" (the device path; tensors on ``device``, CUDA by
default) and "numpy" (the exact CPU reference of ``ops.gf_ref``, needing
no device).
"""

from __future__ import annotations

import errno
import itertools
import math
import threading

import numpy as np
import torch

from ..device import host_tensor, resolve_device
from ..ops import gf, gf_ref, xor_mm
from ..utils import profile as profile_util
from .base import ErasureCode, ErasureCodeError
from .table_cache import (TableCache, device_entry_key, xor_parity_rows,
                          xor_recover)

LARGEST_VECTOR_WORDSIZE = 16  # reference SIMD word (ErasureCodeJerasure.cc:31)

BACKENDS = ("torch", "numpy")


def _roundup(x: int, align: int) -> int:
    return x + (align - x % align) % align if x % align else x


def _constant(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host bitmatrix; ``.to`` of pageable memory
    returns only once the copy is done, so any stream may read it."""
    return host_tensor(a).to(device)


class GeneratorCodec(ErasureCode):
    """Common k/m/w parsing + cached encode/decode dispatch."""

    technique = "generic"
    DEFAULT_K = "7"
    DEFAULT_M = "3"
    DEFAULT_W = "8"

    def __init__(self, backend: str = "torch", device=None):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError("backend %r not in %s" % (backend, BACKENDS))
        self.backend = backend
        self.device = resolve_device(device) if backend == "torch" else None
        self.k = 0
        self.m = 0
        self.w = 0
        self.per_chunk_alignment = False
        self.coding: np.ndarray | None = None   # [m, k] GF generator
        self._bitmat: np.ndarray | None = None  # [m*w, k*w] encode bitmatrix
        self._bitmat_dev_by: dict = {}  # device key -> device copy
        self._decode_cache = TableCache()
        self._xor_rows: list[int] = []  # parity rows that are plain XORs
        self.xor_fast_hits = 0
        # device-resident decode-matrix bank (see _ensure_decode_bank)
        self._bank_lock = threading.Lock()
        self._bank_state: str | None = None
        self._bank_index: dict | None = None
        self._bank_host = None
        self._bank_dev: torch.Tensor | None = None

    # -- profile -----------------------------------------------------------

    def parse(self, profile: dict, errors: list | None = None) -> None:
        super().parse(profile, errors)
        self.k = profile_util.to_int("k", profile, self.DEFAULT_K, errors)
        self.m = profile_util.to_int("m", profile, self.DEFAULT_M, errors)
        self.w = profile_util.to_int("w", profile, self.DEFAULT_W, errors)
        if self.chunk_mapping and len(self.chunk_mapping) != self.k + self.m:
            self.chunk_mapping = []
            raise ErasureCodeError(
                errno.EINVAL,
                "mapping maps %d chunks instead of the expected %d"
                % (len(profile.get("mapping", "")), self.k + self.m))
        self.sanity_check_k(self.k)
        if self.m < 1:
            raise ErasureCodeError(errno.EINVAL, "m=%d must be >= 1" % self.m)
        if self.w not in gf.PRIM_POLY:
            raise ErasureCodeError(
                errno.EINVAL, "w=%d must be in 2..32" % self.w)

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        raise NotImplementedError

    def get_chunk_size(self, object_size: int) -> int:
        # Shared by every jerasure-style technique
        # (ErasureCodeJerasure.cc:74-97).
        alignment = self.get_alignment()
        if self.per_chunk_alignment:
            chunk_size = -(-object_size // self.k)
            return _roundup(max(chunk_size, alignment), alignment)
        padded = _roundup(object_size, alignment)
        assert padded % self.k == 0
        return padded // self.k

    # -- generator ---------------------------------------------------------

    def make_generator(self) -> np.ndarray:
        raise NotImplementedError

    def prepare(self) -> None:
        try:
            self.coding = self.make_generator()
        except ValueError as e:
            # field-size violations (k+m > 2^w etc.) are profile errors
            raise ErasureCodeError(errno.EINVAL, str(e))
        self._bitmat = gf.generator_to_bitmatrix(self.coding, self.w)
        self._reset_tables()

    def _reset_tables(self) -> None:
        self._bitmat_dev_by = {}
        self._decode_cache.clear()
        self.xor_fast_hits = 0
        self._xor_rows = xor_parity_rows(self._bitmat, self.k, self.w)
        self._bank_state = None
        self._bank_index = None
        self._bank_host = None
        self._bank_dev = None

    def _device_bitmat(self, device: torch.device) -> torch.Tensor:
        key = device_entry_key(device)
        dev = self._bitmat_dev_by.get(key)
        if dev is None:
            dev = self._bitmat_dev_by.setdefault(
                key, _constant(self._bitmat, device))
        return dev

    def _as_device(self, bitmat, entry: dict | None,
                   device: torch.device) -> torch.Tensor:
        """Device copy of a bitmatrix, cached on the encode path or inside
        the decode-cache entry — keyed per device (table_cache
        .device_entry_key), so a repeated erasure signature reuses the
        copy already on ITS device and a second device never consumes (or
        clobbers) the first device's copy."""
        if bitmat is self._bitmat:
            return self._device_bitmat(device)
        if entry is None:
            return _constant(bitmat, device)
        key = device_entry_key(device)
        dev = entry.get(key)
        if dev is None:
            dev = entry.setdefault(key, _constant(bitmat, device))
        return dev

    def _full_decode_matrix(self, avail_rows: tuple) -> np.ndarray:
        """[k+m, k] GF matrix mapping k available chunks -> all chunks."""
        dec = gf.decode_matrix(self.coding, self.k, avail_rows, self.w)
        parity = gf.gf_matmul(self.coding, dec, self.w)
        return np.concatenate([dec, parity], axis=0)

    #: precompute + device-upload the whole decode bank when the
    #: pattern space is at most this many C(n, k) signatures
    DECODE_BANK_LIMIT = 512

    def _ensure_decode_bank(self) -> bool:
        """Build the device-resident decode-matrix BANK: every C(n,k)
        erasure signature's decode bitmatrix, stacked into one tensor
        ([165, 88, 64] uint8 for k=8, m=3, w=8) and uploaded in ONE
        transfer to the codec's device. A cache miss then costs a view
        of the bank instead of a host matrix inversion and a per-miss
        upload. The numpy backend has no device, and a pure bitmatrix code
        no GF generator: neither builds a bank."""
        if self._bank_state is None:
            with self._bank_lock:
                if self._bank_state is None:
                    self._build_decode_bank()
        return self._bank_state == "built"

    def _build_decode_bank(self) -> None:
        n = self.get_chunk_count()
        if self.backend != "torch" or self.coding is None or \
                math.comb(n, self.k) > self.DECODE_BANK_LIMIT:
            self._bank_state = "infeasible"
            return
        idx: dict = {}
        gfs, bms = [], []
        for avail in itertools.combinations(range(n), self.k):
            full = self._full_decode_matrix(avail)
            idx[avail] = len(gfs)
            gfs.append(full)
            bms.append(gf.generator_to_bitmatrix(full, self.w))
        self._bank_index = idx
        self._bank_host = (gfs, bms)
        self._bank_dev = _constant(np.stack(bms), self.device)
        self._bank_state = "built"

    def _decode_entry(self, avail_rows: tuple):
        """Cache of per-erasure-signature decode matrices.

        The reference's ISA plugin keeps the same LRU-style cache of decode
        tables keyed by erasure signature
        (ErasureCodeIsaTableCache.{h,cc}); here the cached object also
        carries the device-side bitmatrix, served as a row of the
        device-resident bank when the signature space is small enough
        (_ensure_decode_bank).
        """
        if len(avail_rows) != self.k:
            raise ErasureCodeError(errno.EIO, "need exactly k chunks")
        entry = self._decode_cache.get(avail_rows)
        if entry is None:
            if self._ensure_decode_bank() and \
                    avail_rows in self._bank_index:
                i = self._bank_index[avail_rows]
                gfs, bms = self._bank_host
                entry = self._decode_cache.put(
                    avail_rows,
                    {"gf": gfs[i], "bitmat": bms[i],
                     device_entry_key(self.device): self._bank_dev[i]})
            else:
                full = self._full_decode_matrix(avail_rows)
                entry = self._decode_cache.put(
                    avail_rows,
                    {"gf": full,
                     "bitmat": gf.generator_to_bitmatrix(full, self.w)})
        return entry

    def table_cache_stats(self) -> dict:
        stats = self._decode_cache.stats()
        stats["xor_fast_hits"] = self.xor_fast_hits
        return stats

    # -- single-erasure XOR fast path ---------------------------------------

    def xor_group(self, missing_logical: int):
        """Logical chunk rows whose byte-wise XOR reproduces the missing
        row, or None when no plain-XOR parity covers it (isa/xor_op
        analog). Valid for a missing data row (any XOR parity row serves)
        or a missing XOR parity row itself."""
        if not self._xor_rows:
            return None
        if missing_logical < self.k:
            row = self._xor_rows[0]
        elif missing_logical - self.k in self._xor_rows:
            row = missing_logical - self.k
        else:
            return None
        group = set(range(self.k))
        group.add(self.k + row)
        group.discard(missing_logical)
        return group

    def xor_plan(self, missing_phys: int, available_phys) -> set | None:
        """Physical chunk set whose XOR reproduces `missing_phys`, or None.

        The single shared planner behind the region-XOR shortcut: maps
        the missing physical index through the chunk mapping, asks
        xor_group for the logical group, and checks every member
        survived in `available_phys`.
        """
        n = self.get_chunk_count()
        inv = {self.chunk_index(i): i for i in range(n)}
        ml = inv.get(missing_phys)
        group = self.xor_group(ml) if ml is not None else None
        if group is None:
            return None
        phys = {self.chunk_index(i) for i in group}
        return phys if phys <= set(available_phys) else None

    def minimum_to_decode(self, want_to_read: set, available: set) -> set:
        """Prefer the XOR group for a single erasure so the read path
        fetches exactly the shards the region-XOR shortcut needs (the
        reference's ISA plugin biases shard selection the same way)."""
        if want_to_read <= available:
            return set(want_to_read)
        missing = want_to_read - available
        if len(missing) == 1:
            plan = self.xor_plan(next(iter(missing)), available)
            if plan is not None:
                return plan
        return super().minimum_to_decode(want_to_read, available)

    def decode(self, want_to_read: set, chunks: dict) -> dict:
        """Single-erasure region-XOR shortcut before the matrix path.

        Fires when exactly one wanted chunk is missing and every member of
        its XOR group survived — whether the caller handed us all n-1
        survivors or just the k chunks minimum_to_decode asked for.
        """
        have = set(chunks)
        missing = want_to_read - have
        if len(missing) == 1:
            m_phys = next(iter(missing))
            plan = self.xor_plan(m_phys, have)
            if plan is not None:
                rec = xor_recover({i: chunks[i] for i in plan})
                self.xor_fast_hits += 1
                out = {m_phys: rec}
                for idx in have:  # base decode echoes survivors back too
                    out[idx] = np.asarray(chunks[idx], dtype=np.uint8)
                return out
        return super().decode(want_to_read, chunks)

    # -- batched device API -------------------------------------------------

    def _host_apply(self, gf_matrix: np.ndarray, bitmat: np.ndarray,
                    data: np.ndarray) -> np.ndarray:
        """The numpy oracle of the layout on one [k, N] stripe."""
        raise NotImplementedError

    def _device_apply(self, bitmat: torch.Tensor, data: torch.Tensor,
                      host_bitmat: np.ndarray) -> torch.Tensor:
        """The layout's kernel on [B, k, N] tensors of one device;
        `host_bitmat` is the host copy of `bitmat`."""
        raise NotImplementedError

    def _apply_matrix(self, gf_matrix: np.ndarray, bitmat: np.ndarray,
                      data, entry: dict | None = None):
        """[B, k, N] -> [B, R/w, N]: numpy in, numpy out; a tensor in, a
        tensor out on the same device (the counterpart of the
        reference's jax-array passthrough)."""
        if self.backend == "numpy":
            data = np.asarray(data, dtype=np.uint8)
            return np.stack([self._host_apply(gf_matrix, bitmat, data[b])
                             for b in range(data.shape[0])])
        if isinstance(data, torch.Tensor):
            return self._device_apply(
                self._as_device(bitmat, entry, data.device),
                data.contiguous(), bitmat)
        out = self._device_apply(
            self._as_device(bitmat, entry, self.device),
            host_tensor(data).to(self.device), bitmat)
        return out.cpu().numpy()

    def encode_batch(self, data):
        return self._apply_matrix(self.coding, self._bitmat, data)

    def decode_batch(self, avail_rows: tuple, chunks):
        entry = self._decode_entry(tuple(avail_rows))
        return self._apply_matrix(entry["gf"], entry["bitmat"], chunks,
                                  entry)


class MatrixErasureCode(GeneratorCodec):
    """Element-layout GF(2^w) matrix codec (Reed-Solomon family)."""

    def parse(self, profile: dict, errors: list | None = None) -> None:
        super().parse(profile, errors)
        self.per_chunk_alignment = profile_util.to_bool(
            "jerasure-per-chunk-alignment", profile, "false")

    def get_alignment(self) -> int:
        # ErasureCodeJerasure.cc:168-178.
        if self.per_chunk_alignment:
            return self.w * LARGEST_VECTOR_WORDSIZE
        if (self.w * 4) % LARGEST_VECTOR_WORDSIZE:
            return self.k * self.w * LARGEST_VECTOR_WORDSIZE
        return self.k * self.w * 4

    def _host_apply(self, gf_matrix, bitmat, data):
        return gf_ref.matrix_encode_ref(gf_matrix, data, self.w)

    def _device_apply(self, bitmat, data, host_bitmat):
        return xor_mm.matrix_encode(bitmat, data, self.w)


class BitmatrixErasureCode(GeneratorCodec):
    """Packet-layout bitmatrix codec (Cauchy / Liberation families).

    Chunk layout: S superblocks x w packets x packetsize bytes
    (jerasure_schedule_encode semantics; packetsize default 2048,
    ErasureCodeJerasure.h:141). Decode converts the GF-domain decode
    matrix to a bitmatrix — valid because gf.generator_to_bitmatrix is a
    ring homomorphism, so the bitmatrix of the inverse is the inverse of
    the bitmatrix. Nothing of the decode bank is specific to a layout, so
    a small signature space (liber8tion's 45) rides the bank too.
    """

    DEFAULT_PACKETSIZE = "2048"

    def __init__(self, backend: str = "torch", device=None):
        super().__init__(backend, device)
        self.packetsize = 0

    def parse(self, profile: dict, errors: list | None = None) -> None:
        super().parse(profile, errors)
        self.packetsize = profile_util.to_int(
            "packetsize", profile, self.DEFAULT_PACKETSIZE, errors)
        if self.packetsize < 1:
            raise ErasureCodeError(
                errno.EINVAL, "packetsize=%d must be >= 1" % self.packetsize)
        self.per_chunk_alignment = profile_util.to_bool(
            "jerasure-per-chunk-alignment", profile, "false")

    def require_word_packetsize(self) -> None:
        """jerasure's liberation-family constraint: packetsize must cover
        whole machine words (shared by liberation/blaum_roth/liber8tion)."""
        if self.packetsize % 8:
            raise ErasureCodeError(
                errno.EINVAL,
                "packetsize=%d must be a multiple of 8" % self.packetsize)

    def get_alignment(self) -> int:
        # ErasureCodeJerasure.cc:273-287; per-chunk alignment must stay a
        # multiple of the w*packetsize superblock or encode would reject
        # its own chunk size (lcm, not roundup)
        if self.per_chunk_alignment:
            return math.lcm(self.w * self.packetsize,
                            LARGEST_VECTOR_WORDSIZE)
        if (self.w * self.packetsize * 4) % LARGEST_VECTOR_WORDSIZE:
            return self.k * self.w * self.packetsize * LARGEST_VECTOR_WORDSIZE
        return self.k * self.w * self.packetsize * 4

    def _host_apply(self, gf_matrix, bitmat, data):
        return gf_ref.bitmatrix_encode_ref(bitmat, data, self.w,
                                           self.packetsize)

    def _device_apply(self, bitmat, data, host_bitmat):
        return xor_mm.bitmatrix_encode(bitmat, data, self.w, self.packetsize,
                                       set_bits=int(host_bitmat.sum()))


def load_numpy_state(codec: GeneratorCodec, coding: np.ndarray | None,
                     bitmat: np.ndarray, packetsize: int = 0) -> None:
    """Take a reference codec's ``coding`` and ``_bitmat`` numpy arrays
    (``coding`` None for a pure bitmatrix code) and its ``packetsize``
    (0 for the element layout) into a port codec, so both packages hold
    the same generator. Raises ValueError if they differ from what the
    port derived itself."""
    if (coding is None) != (codec.coding is None):
        raise ValueError("coding matrix differs from the port's")
    if coding is not None:
        coding = np.asarray(coding, dtype=np.int64)
        if coding.shape != codec.coding.shape or \
                not np.array_equal(coding, codec.coding):
            raise ValueError("coding matrix differs from the port's")
    bitmat = np.asarray(bitmat, dtype=np.uint8)
    if bitmat.shape != codec._bitmat.shape or \
            not np.array_equal(bitmat, codec._bitmat):
        raise ValueError("bitmatrix differs from the port's")
    if packetsize != getattr(codec, "packetsize", 0):
        raise ValueError("packetsize %d differs from the port's %d"
                         % (packetsize, getattr(codec, "packetsize", 0)))
    codec.coding = None if coding is None else coding.copy()
    codec._bitmat = bitmat.copy()
    codec._reset_tables()
