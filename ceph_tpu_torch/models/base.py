"""The erasure-code interface and shared base implementation.

Port of ``ceph_tpu/models/base.py``. Python rendition of the contract
every Ceph plugin implements (src/erasure-code/ErasureCodeInterface.h:
170-449) plus the shared helpers of the base class
(src/erasure-code/ErasureCode.{h,cc}): systematic chunk model,
padding/alignment (encode_prepare, ErasureCode.cc:122-157), greedy
minimum_to_decode (:91-108), chunk remapping (:235-254), decode_concat
(:306-322).

Differences by design (device-first):
  - Chunks are numpy uint8 arrays (host) and the hot path is the *batched*
    API (`encode_batch` / `decode_batch`): [B, k, N] -> [B, m, N] in one
    kernel launch, on numpy arrays or on torch tensors (which stay on
    their device). The reference encodes one stripe per call inside a CPU
    loop (src/osd/ECUtil.cc:100-139).
  - With a non-trivial chunk mapping, parity is computed over the logical
    (unpermuted) data order and the remap is applied at placement time;
    encode/decode agree with each other on this convention.
"""

from __future__ import annotations

import abc
import errno

import numpy as np

from ..errors import ErasureCodeError
from ..utils import profile as profile_util

__all__ = ["ErasureCode", "ErasureCodeError", "SIMD_ALIGN"]


SIMD_ALIGN = 32  # reference buffer alignment constant (ErasureCode.cc:30)


class ErasureCode(abc.ABC):
    """Base class: profile handling, padding, decode orchestration."""

    def __init__(self):
        self._profile: dict = {}
        self.chunk_mapping: list[int] = []
        self.rule_root = "default"
        self.rule_failure_domain = "host"
        self.rule_device_class = ""

    # -- init / profile ----------------------------------------------------

    def init(self, profile: dict, errors: list | None = None) -> None:
        """Parse the profile and prepare generator matrices.

        Mutates `profile` in place, echoing resolved defaults back
        (registry contract, ErasureCodePlugin.cc:114-118). Raises
        ErasureCodeError on invalid parameters.
        """
        self.parse(profile, errors)
        self.prepare()
        self.rule_root = profile_util.to_string("crush-root", profile, "default")
        self.rule_failure_domain = profile_util.to_string(
            "crush-failure-domain", profile, "host")
        self.rule_device_class = profile_util.to_string(
            "crush-device-class", profile, "")
        self._profile = profile

    def parse(self, profile: dict, errors: list | None = None) -> None:
        self.chunk_mapping = profile_util.to_mapping(profile)

    def prepare(self) -> None:
        pass

    def get_profile(self) -> dict:
        return self._profile

    @staticmethod
    def sanity_check_k(k: int) -> None:
        if k < 2:
            raise ErasureCodeError(errno.EINVAL, "k=%d must be >= 2" % k)

    # -- geometry ----------------------------------------------------------

    @abc.abstractmethod
    def get_chunk_count(self) -> int: ...

    @abc.abstractmethod
    def get_data_chunk_count(self) -> int: ...

    #: True for codecs whose decode_batch accepts ANY recoverable row
    #: subset (locality codecs: shec, lrc) rather than exactly k rows, and
    #: takes the rows the caller wants (``want_rows``), enabling sub-k
    #: local-repair reads.
    DECODE_BATCH_ANY = False

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    @abc.abstractmethod
    def get_chunk_size(self, object_size: int) -> int: ...

    def get_chunk_mapping(self) -> list[int]:
        return self.chunk_mapping

    def chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if i < len(self.chunk_mapping) else i

    # -- minimum_to_decode -------------------------------------------------

    def minimum_to_decode(self, want_to_read: set, available: set) -> set:
        """Greedy minimum chunk selection (ErasureCode.cc:91-108)."""
        if want_to_read <= available:
            return set(want_to_read)
        k = self.get_data_chunk_count()
        if len(available) < k:
            raise ErasureCodeError(errno.EIO, "not enough chunks to decode")
        return set(sorted(available)[:k])

    def minimum_to_decode_with_cost(self, want_to_read: set,
                                    available: dict) -> set:
        """The chunks to read given {chunk: cost} of the available ones
        (ErasureCodeInterface.h minimum_to_decode_with_cost); the base
        ignores the costs."""
        return self.minimum_to_decode(want_to_read, set(available))

    # -- repair capability (regenerating codes) ----------------------------

    def supports_repair(self) -> bool:
        """True when the codec can rebuild one chunk from sub-chunk
        repair fractions (beta < chunk) instead of k full survivors.
        Advertising codecs also provide repair_helper_count(),
        minimum_to_repair(), repair_fraction_batch() and
        repair_combine_batch() (see models/msr.py)."""
        return False

    def repair_fraction(self) -> float:
        """Fraction of a chunk each helper ships on repair (beta/alpha);
        1.0 for codecs whose repair is a full decode."""
        return 1.0

    def repair_helper_count(self) -> int:
        """Helpers (d) a fraction repair needs; 0 when unsupported."""
        return 0

    # -- single-object API (wraps the batched device path) -----------------

    def encode_prepare(self, raw: bytes | np.ndarray) -> np.ndarray:
        """Split + zero-pad raw bytes into [k, blocksize] (logical order).

        Mirrors ErasureCode::encode_prepare (ErasureCode.cc:122-157).
        """
        raw = np.frombuffer(raw, dtype=np.uint8) if isinstance(
            raw, (bytes, bytearray, memoryview)) else np.asarray(
                raw, dtype=np.uint8).reshape(-1)
        k = self.get_data_chunk_count()
        blocksize = self.get_chunk_size(raw.size)
        out = np.zeros((k, blocksize), dtype=np.uint8)
        flat = out.reshape(-1)
        flat[:raw.size] = raw
        return out

    def encode(self, want_to_encode: set, raw: bytes | np.ndarray) -> dict:
        """Encode raw bytes -> {chunk index: [blocksize] uint8}."""
        data = self.encode_prepare(raw)
        parity = self.encode_batch(data[None])[0]
        out = {}
        k = self.get_data_chunk_count()
        for i in range(self.get_chunk_count()):
            idx = self.chunk_index(i)
            if idx in want_to_encode:
                out[idx] = data[i] if i < k else parity[i - k]
        return out

    def decode(self, want_to_read: set, chunks: dict) -> dict:
        """Reconstruct want_to_read from available chunks.

        chunks: {chunk index: [blocksize] uint8}, all the same length
        (ErasureCode.cc:183-216).
        """
        have = set(chunks)
        if want_to_read <= have:
            return {i: np.asarray(chunks[i], dtype=np.uint8)
                    for i in want_to_read}
        out = self.decode_all(chunks)
        result = {i: out[i] for i in want_to_read}
        for i in have:
            result.setdefault(i, np.asarray(chunks[i], dtype=np.uint8))
        return result

    def decode_all(self, chunks: dict) -> dict:
        """Reconstruct every chunk from >= k available ones."""
        k = self.get_data_chunk_count()
        n = self.get_chunk_count()
        inv = {self.chunk_index(i): i for i in range(n)}
        logical = {inv[idx]: np.asarray(buf, dtype=np.uint8)
                   for idx, buf in chunks.items()}
        avail = tuple(sorted(logical))
        use = avail[:k] if len(avail) >= k else None
        if use is None:
            raise ErasureCodeError(errno.EIO, "not enough chunks to decode")
        stacked = np.stack([logical[i] for i in use])
        full = self.decode_batch(use, stacked[None])[0]
        out = {}
        for i in range(n):
            idx = self.chunk_index(i)
            if idx in chunks:
                out[idx] = np.asarray(chunks[idx], dtype=np.uint8)
            else:
                out[idx] = np.asarray(full[i])
        return out

    def decode_concat(self, chunks: dict) -> bytes:
        """Concatenate the data chunks (ErasureCode.cc:306-322)."""
        k = self.get_data_chunk_count()
        want = {self.chunk_index(i) for i in range(k)}
        decoded = self.decode(want, chunks)
        return b"".join(
            decoded[self.chunk_index(i)].tobytes() for i in range(k))

    # -- batched device API (GPU hot path) ---------------------------------

    @abc.abstractmethod
    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """[B, k, N] uint8 -> parity [B, m, N] uint8 (logical order)."""

    @abc.abstractmethod
    def decode_batch(self, avail_rows: tuple, chunks: np.ndarray) -> np.ndarray:
        """Reconstruct all chunks from k available ones.

        avail_rows: sorted tuple of logical chunk indices, len == k.
        chunks: [B, k, N] in avail_rows order. Returns [B, k+m, N].
        """
