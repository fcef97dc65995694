"""Wrapper of the HBM chunk tier's digest kernel (``csrc/hbm_digest.cu``).

Port of the XLA program of ``ceph_tpu/osd/hbm_tier.py:60-78``
(``_device_digest``): per chunk of bytes, the pair

    s  = sum_i x_i                          mod 2^32
    ws = sum_i x_i * ((i mod 65535) + 1)    mod 2^32

that deep scrub compares (``osd/hbm_tier.py`` ``host_digest`` is its
numpy twin). :func:`chunk_digest` launches the kernel once for a CUDA
tensor and runs :func:`chunk_digest_plain` only for a CPU tensor; it
never falls back. :func:`chunk_digest_many` digests the rows of several
tensors of one row length in one launch, through a table of the rows'
device addresses (the tier's objects where they lie, ungathered;
``ops/row_table.row_table`` builds it and ``_rows_digest`` launches over
it). They
return uint32 tensors, which compare as values through
``t.view(torch.int32)`` (torch lacks uint32 arithmetic).

``LAUNCHES`` counts the wrapper's launches and :func:`cuda_launches` the
C entry point's; :func:`reset_launches` sets both to 0. Rows longer than
one 32 KiB span sum their spans through the scratch buffer that the
write kernels keep per (device, stream) (``write_kernels._scratch_for``):
every kernel that uses it leaves it all zeros, so no call clears it.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _build
from .row_table import row_indices, row_table
from .write_kernels import _scratch_for, _to_u32

__all__ = ["chunk_digest", "chunk_digest_many", "chunk_digest_plain",
           "cuda_launches",
           "reset_launches", "LAUNCHES", "PERIOD"]

_SOURCE = "hbm_digest"
PERIOD = 0xFFFF              # the weights run 1..65535, then again from 1
_M32 = 0xFFFFFFFF
_PLAIN_ELEMS = 1 << 24       # bytes the plain version widens at a time

LAUNCHES = 0
_count_lock = threading.Lock()
_lib = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.hbm_digest.argtypes = [p, p, ctypes.c_int, ll, ll, p, p, p, p]
        lib.hbm_digest.restype = ctypes.c_int
        lib.hbm_digest_scratch_words.argtypes = [ll, ll]
        lib.hbm_digest_scratch_words.restype = ll
        lib.hbm_digest_launches.argtypes = []
        lib.hbm_digest_launches.restype = ll
        lib.hbm_digest_reset_launches.argtypes = []
        lib.hbm_digest_reset_launches.restype = None
        _lib = lib
    return _lib


def cuda_launches() -> int:
    """CUDA launches since the last reset, as the C entry point counts
    them where it launches the kernel."""
    return 0 if _lib is None else int(_lib.hbm_digest_launches())


def reset_launches() -> None:
    """Sets ``LAUNCHES`` and the C entry point's count to 0."""
    global LAUNCHES
    with _count_lock:
        LAUNCHES = 0
        if _lib is not None:
            _lib.hbm_digest_reset_launches()


def _check(chunks: torch.Tensor) -> None:
    if chunks.dtype != torch.uint8 or chunks.dim() < 1:
        raise ValueError("chunks must be a [..., n] uint8 tensor, got %s %s"
                         % (chunks.dtype, tuple(chunks.shape)))
    if not chunks.is_contiguous():
        raise ValueError("chunks must be contiguous")
    if chunks.device.type not in ("cpu", "cuda"):
        raise ValueError("no kernel for device %s" % chunks.device)


def chunk_digest_plain(chunks: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (s, ws) uint32 [...] of
    chunks [..., n] uint8. The sums run in int64 and are masked to 32
    bits (exact: 255 * 65535 * n stays far inside int64 for any chunk a
    tier holds), over a few rows at a time so that the widened copy
    stays small."""
    *lead, n = chunks.shape
    flat = chunks.reshape(int(torch.Size(lead).numel()), n)
    dev = chunks.device
    s = torch.zeros(flat.shape[0], dtype=torch.int64, device=dev)
    ws = torch.zeros_like(s)
    weight = (torch.arange(n, dtype=torch.int64, device=dev) % PERIOD
              + 1).to(torch.int32)
    step = max(1, _PLAIN_ELEMS // max(n, 1))
    for r in range(0, flat.shape[0], step):
        x = flat[r:r + step]
        s[r:r + step] = x.sum(dim=-1, dtype=torch.int64)
        # x * weight <= 255 * 65535 fits int32; the sum runs in int64
        ws[r:r + step] = (x.to(torch.int32) * weight).sum(
            dim=-1, dtype=torch.int64)
    return (_to_u32(s & _M32).reshape(lead),
            _to_u32(ws & _M32).reshape(lead))


def _launch(device: torch.device, lead, rows: int, n: int,
            data: torch.Tensor | None, table: torch.Tensor | None,
            aligned: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch over `rows` rows of `n` bytes: data's, or those whose
    addresses `table` holds."""
    global LAUNCHES
    s = torch.empty(lead, dtype=torch.uint32, device=device)
    ws = torch.empty(lead, dtype=torch.uint32, device=device)
    if rows == 0:               # no work: the entry point launches nothing
        return s, ws
    lib = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        words = lib.hbm_digest_scratch_words(rows, n)
        scratch = _scratch_for(device, stream, words) if words else None
        rc = lib.hbm_digest(
            None if data is None else data.data_ptr(),
            None if table is None else table.data_ptr(), int(aligned),
            rows, n, None if scratch is None else scratch.data_ptr(),
            s.data_ptr(), ws.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("hbm_digest failed with code %d%s"
                           % (rc, _build.launch_failure(lib)))
    with _count_lock:
        LAUNCHES += 1
    return s, ws


def chunk_digest(chunks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, ws) uint32 [...] of chunks [..., n] uint8 through the GPU
    kernel: one launch a call, on the current stream, for a CUDA tensor;
    the plain version for a CPU tensor."""
    _check(chunks)
    if chunks.device.type == "cpu":
        return chunk_digest_plain(chunks)
    *lead, n = chunks.shape
    rows = chunks.numel() // n if n else int(torch.Size(lead).numel())
    return _launch(chunks.device, lead, rows, n, chunks, None, True)


def _rows_of(parts: list[torch.Tensor], picks) -> list[np.ndarray]:
    """Per part, the indices of its rows of n bytes that the call reads:
    all of them, or those of the sub-tensors parts[i][picks[i]]."""
    out = row_indices(parts)
    for i, t in enumerate(parts):
        if picks is None or picks[i] is None:
            continue
        per = out[i].size // t.shape[0] if t.dim() > 1 and t.shape[0] else 1
        sel = np.asarray(picks[i], dtype=np.int64)
        out[i] = (sel[:, None] * per + np.arange(per)).reshape(-1)
    return out


def _check_parts(parts: list[torch.Tensor]) -> None:
    if not parts:
        raise ValueError("no chunks to digest")
    for t in parts:
        _check(t)
    n, device = parts[0].shape[-1], parts[0].device
    if any(t.shape[-1] != n or t.device != device for t in parts):
        raise ValueError("parts must share one row length and device")


def _rows_digest(table: torch.Tensor, n: int, unaligned: int | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, ws) uint32 [rows] of the rows of n bytes at the addresses of a
    ``row_table`` (its triple: table, n, first address not on 16 bytes),
    in one launch: 16-byte vectors where every row allows them."""
    rows = table.numel()
    return _launch(table.device, [rows], rows, n, None, table,
                   n % 16 == 0 and unaligned is None)


def chunk_digest_many(parts: list[torch.Tensor], picks=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, ws) uint32 [rows] of the rows of `parts` (each [..., n] uint8,
    one n, one device; with `picks` only those of parts[i][picks[i]]),
    in order, as digests of their concatenation: one launch on a CUDA
    device, reading each row where it lies through a table of row
    addresses (uploaded with the call, 8 bytes a row); the plain version
    for CPU tensors."""
    _check_parts(parts)
    if parts[0].device.type != "cpu":
        return _rows_digest(*row_table(parts, _rows_of(parts, picks)))
    n = parts[0].shape[-1]
    pairs = [chunk_digest_plain(t.reshape(-1, n)[torch.from_numpy(rows)])
             if n else chunk_digest_plain(
                 torch.zeros((rows.size, 0), dtype=torch.uint8))
             for t, rows in zip(parts, _rows_of(parts, picks))]
    return (torch.cat([a for a, _ in pairs]),
            torch.cat([b for _, b in pairs]))
