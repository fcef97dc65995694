"""Wrapper of the GF(2^w) bitmatrix kernel (``csrc/gf_bitmatrix.cu``).

Port of ``ceph_tpu/ops/pallas_gf.py`` (``matrix_encode8`` and its Pallas
``_encode_kernel``). On Hopper the single pass that reads the k data bytes
of a column and writes its parity bytes, staging nothing in device memory,
is the natural kernel, so here it carries the main path: every encode and
every decode bitmatrix of the Reed-Solomon codecs, at w = 8, 16 and 32,
and the MSR code's products.

The source holds three designs, and its entry point picks one from the
geometry alone: the bit-sliced kernel for w = 8 with k*8 <= 128 where its
expanded bitmatrix fits in shared memory (the main path's), the popcount
kernel for w = 16 and 32 with k*w <= 128 (where it is faster), and the
mma kernel, on the int8 tensor cores, for every other geometry. The mma
kernel stages the bitmatrix a row group at a time, as many rows as the
card's opt-in shared memory holds beside its data tiles; the C entry
point plans the groups (:func:`row_groups` reads the plan), so any
number of rows is one launch, and k*w is limited by what one smallest
group takes (:func:`max_k`; ``xor_mm.matrix_encode`` splits a wider
product). A geometry the kernel refuses raises ValueError before any
launch; a CPU tensor's plain version has no such limit.

:func:`matrix_encode_multi` is the per-lane form, a port of the XLA
program of ``ceph_tpu/ops/xor_mm.py:91`` (``matrix_encode_multi``, the
vmap of ``matrix_encode`` with a different bitmatrix per lane): P lanes
in one launch of the same kernels (``gf_bitmatrix_encode_multi``).
:func:`matrix_encode_multi_rows` is the same product with each lane's k
data rows read where they lie, through a table of their addresses
(``gf_bitmatrix_encode_multi_rows``, ``ops/row_table.py``): the HBM chunk
tier's ``reconstruct_batch`` runs it on the survivors in their upload
batches, with no gathered copy.

:func:`matrix_encode` and :func:`matrix_encode_multi` launch the kernel
for a CUDA tensor and run their plain versions only for a CPU tensor;
they never fall back. ``LAUNCHES`` and ``MULTI_LAUNCHES`` count kernel
launches; :func:`launches_by_design` reads the counts that the C entry
points keep per design where they launch each kernel (``multi=True``
for the per-lane entry points, dense and through a table), and :func:`reset_launches` sets all of
them to 0.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .row_table import row_indices, row_table
from .xor_mm import pack_element_bits, unpack_element_bits, xor_matmul

__all__ = ["matrix_encode", "matrix_encode_plain", "matrix_encode_multi",
           "matrix_encode_multi_plain", "matrix_encode_multi_rows",
           "matrix_encode_multi_rows_plain", "kernel_design",
           "launches_by_design", "reset_launches", "row_groups",
           "max_k", "DESIGNS", "LAUNCHES", "MULTI_LAUNCHES"]

_SOURCE = "gf_bitmatrix"

DESIGNS = ("bitsliced", "mma", "popcount")  # by the C entry point's number

LAUNCHES = 0
MULTI_LAUNCHES = 0
_count_lock = threading.Lock()
_lib = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        lib.gf_bitmatrix_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.gf_bitmatrix_encode.restype = ctypes.c_int
        lib.gf_bitmatrix_encode_multi.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        lib.gf_bitmatrix_encode_multi.restype = ctypes.c_int
        lib.gf_bitmatrix_encode_multi_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.gf_bitmatrix_encode_multi_rows.restype = ctypes.c_int
        for fn in (lib.gf_bitmatrix_design, lib.gf_bitmatrix_group_rows):
            fn.argtypes = [ctypes.c_int] * 3
            fn.restype = ctypes.c_int
        lib.gf_bitmatrix_max_k.argtypes = [ctypes.c_int]
        lib.gf_bitmatrix_max_k.restype = ctypes.c_int
        lib.gf_bitmatrix_launches.argtypes = [ctypes.c_int] * 2
        lib.gf_bitmatrix_launches.restype = ctypes.c_longlong
        lib.gf_bitmatrix_reset_launches.argtypes = []
        lib.gf_bitmatrix_reset_launches.restype = None
        _lib = lib
    return _lib


def _ask(fn: str, device, *args) -> int:
    """C query `fn`(*args) on CUDA `device`: ValueError where it refuses
    the geometry (-1), RuntimeError where the device query fails."""
    with torch.cuda.device(torch.device(device)):
        rc = getattr(_kernel(), fn)(*args)
    if rc == -1:
        raise ValueError("%s%s: a geometry the kernel does not take (k*w "
                         "past what one row group of the mma design and its "
                         "data tiles hold in shared memory, or a w, k or "
                         "row count it refuses)" % (fn, args))
    if rc < 0:
        raise RuntimeError("%s%s failed with code %d" % (fn, args, rc))
    return rc


def kernel_design(rows: int, k: int, w: int, device) -> str:
    """The design the kernel's entry point takes for a [rows, k*w]
    bitmatrix on a CUDA device: one of ``DESIGNS``."""
    return DESIGNS[_ask("gf_bitmatrix_design", device, rows, k, w)]


def row_groups(rows: int, k: int, w: int, device) -> list[tuple[int, int]]:
    """The (start, stop) bitmatrix rows of each row group that the mma
    design stages for a [rows, k*w] bitmatrix on `device`, one group a
    row of blocks of the one launch, as the C entry point plans them;
    one group for another design or the CPU."""
    if torch.device(device).type != "cuda" or rows == 0:
        return [(0, rows)]
    span = _ask("gf_bitmatrix_group_rows", device, rows, k, w) or rows
    return [(r, min(r + span, rows)) for r in range(0, rows, span)]


def max_k(w: int, device) -> int | None:
    """The most data rows at `w` that one launch takes on `device` (k*w =
    1,792 bits on an H100), None for the CPU, whose plain version takes
    any."""
    if torch.device(device).type != "cuda":
        return None
    return _ask("gf_bitmatrix_max_k", device, w)


def launches_by_design(multi: bool = False) -> dict[str, int]:
    """{design: kernel launches since the last reset}, as the C entry
    point counts them where it launches each kernel: the single-matrix
    entry point's, or with `multi` the per-lane one's."""
    if _lib is None:            # nothing was built, so nothing launched
        return dict.fromkeys(DESIGNS, 0)
    return {d: int(_lib.gf_bitmatrix_launches(i, int(multi)))
            for i, d in enumerate(DESIGNS)}


def reset_launches() -> None:
    """Sets ``LAUNCHES``, ``MULTI_LAUNCHES`` and the per-design counts of
    both entry points to 0."""
    global LAUNCHES, MULTI_LAUNCHES
    with _count_lock:
        LAUNCHES = 0
        MULTI_LAUNCHES = 0
        if _lib is not None:
            _lib.gf_bitmatrix_reset_launches()


def _check_geometry(rows: int, cols: int, k: int, n: int, w: int,
                    device) -> None:
    """Checks an [R, cols] bitmatrix on k data rows of N bytes at w, and
    on a CUDA `device` that the kernel takes it."""
    if w not in (8, 16, 32):
        raise ValueError("w=%d must be one of 8, 16, 32" % w)
    if cols != k * w:
        raise ValueError("bitmat has %d columns, data k*w is %d"
                         % (cols, k * w))
    if rows % w or n % (w // 8):
        raise ValueError("bitmat rows %d and N %d must be multiples of "
                         "w=%d and w/8" % (rows, n, w))
    if torch.device(device).type == "cuda":
        kernel_design(rows, k, w, device)


def _check(bitmat: torch.Tensor, data: torch.Tensor, w: int,
           lanes: int | None = None) -> None:
    """Checks a [R, k*w] bitmatrix and [..., k, N] data, or with `lanes`
    a [P, R, k*w] stack and [P, ..., k, N] data."""
    if bitmat.dtype != torch.uint8 or data.dtype != torch.uint8:
        raise TypeError("bitmat and data must be uint8, got %s and %s"
                        % (bitmat.dtype, data.dtype))
    lead = 0 if lanes is None else 1
    if bitmat.dim() != 2 + lead or data.dim() < 2 + lead:
        raise ValueError("bitmat must be %s[R, k*w] and data %s[..., k, N]; "
                         "got %s and %s" % ("[P] " * lead, "[P] " * lead,
                                            tuple(bitmat.shape),
                                            tuple(data.shape)))
    if lead and (bitmat.shape[0] != lanes or data.shape[0] != lanes):
        raise ValueError("bitmats have %d lanes, data %d"
                         % (bitmat.shape[0], data.shape[0]))
    rows, cols = bitmat.shape[-2:]
    k, n = data.shape[-2:]
    if bitmat.device != data.device:
        raise ValueError("bitmat on %s, data on %s"
                         % (bitmat.device, data.device))
    _check_geometry(rows, cols, k, n, w, data.device)
    if not (bitmat.is_contiguous() and data.is_contiguous()):
        raise ValueError("bitmat and data must be contiguous")


def matrix_encode_plain(bitmat: torch.Tensor, data: torch.Tensor,
                        w: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: unpack, 0/1 matmul, pack."""
    return pack_element_bits(
        xor_matmul(bitmat, unpack_element_bits(data, w)), w)


def matrix_encode(bitmat: torch.Tensor, data: torch.Tensor,
                  w: int) -> torch.Tensor:
    """[..., k, N] uint8 -> [..., R/w, N] uint8 through the GPU kernel.

    bitmat: [R, k*w] 0/1 uint8 on data's device. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel on the current
    stream or raises."""
    global LAUNCHES
    _check(bitmat, data, w)
    if data.device.type == "cpu":
        return matrix_encode_plain(bitmat, data, w)
    if data.device.type != "cuda":
        raise ValueError("no kernel for device %s" % data.device)
    rows = bitmat.shape[0]
    *lead, k, n = data.shape
    batch = data.numel() // (k * n) if k * n else 0
    out = torch.empty((*lead, rows // w, n), dtype=torch.uint8,
                      device=data.device)
    if out.numel() == 0:        # no work: the entry point launches nothing
        return out
    lib = _kernel()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.gf_bitmatrix_encode(
            bitmat.data_ptr(), rows, k, w, data.data_ptr(), out.data_ptr(),
            batch, n, stream)
    if rc != 0:
        raise RuntimeError("gf_bitmatrix_encode failed with code %d%s"
                           % (rc, _build.launch_failure(lib)))
    with _count_lock:
        LAUNCHES += 1
    return out


def matrix_encode_multi_plain(bitmats: torch.Tensor, data: torch.Tensor,
                              w: int) -> torch.Tensor:
    """The per-lane kernel's function in plain PyTorch: lane p's data
    [..., k, N] times lane p's bitmatrix, as one broadcast 0/1 matmul."""
    lead = data.dim() - 3                  # dims between P and [k, N]
    bm = bitmats.reshape(bitmats.shape[0], *([1] * lead),
                         *bitmats.shape[1:])
    return pack_element_bits(xor_matmul(bm, unpack_element_bits(data, w)),
                             w)


def matrix_encode_multi(bitmats: torch.Tensor, data: torch.Tensor,
                        w: int) -> torch.Tensor:
    """[P, ..., k, N] uint8 -> [P, ..., R/w, N] uint8 with a different
    bitmatrix per lane, in one launch of the GPU kernel whatever P is.

    bitmats: [P, R, k*w] 0/1 uint8 on data's device. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel on the current
    stream or raises."""
    global MULTI_LAUNCHES
    lanes = bitmats.shape[0] if bitmats.dim() == 3 else -1
    _check(bitmats, data, w, lanes)
    if data.device.type == "cpu":
        return matrix_encode_multi_plain(bitmats, data, w)
    if data.device.type != "cuda":
        raise ValueError("no kernel for device %s" % data.device)
    rows = bitmats.shape[1]
    _, *lead, k, n = data.shape
    batch = int(torch.Size(lead).numel())
    out = torch.empty((lanes, *lead, rows // w, n), dtype=torch.uint8,
                      device=data.device)
    if out.numel() == 0:        # no work: the entry point launches nothing
        return out
    lib = _kernel()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.gf_bitmatrix_encode_multi(
            bitmats.data_ptr(), lanes, rows, k, w, data.data_ptr(),
            out.data_ptr(), batch, n, stream)
    if rc != 0:
        raise RuntimeError("gf_bitmatrix_encode_multi failed with code %d%s"
                           % (rc, _build.launch_failure(lib)))
    with _count_lock:
        MULTI_LAUNCHES += 1
    return out


def _check_rows(bitmats: torch.Tensor, parts: list[torch.Tensor], rows,
                w: int) -> tuple[int, int, list]:
    """Checks a [P, R, k*w] bitmatrix stack against P*k rows of parts;
    returns (k, n, the rows' indices per part)."""
    if not parts:
        raise ValueError("no survivor rows")
    if bitmats.dim() != 3 or bitmats.dtype != torch.uint8:
        raise ValueError("bitmats must be uint8 [P, R, k*w], got %s %s"
                         % (bitmats.dtype, tuple(bitmats.shape)))
    if w not in (8, 16, 32):
        raise ValueError("w=%d must be one of 8, 16, 32" % w)
    k = bitmats.shape[2] // w
    n = parts[0].shape[-1]
    if any(t.dtype != torch.uint8 or t.shape[-1] != n or
           t.device != bitmats.device for t in parts):
        raise ValueError("rows must be uint8 of one length on the "
                         "bitmatrices' device")
    idx = row_indices(parts, rows)
    count = sum(i.size for i in idx)
    if count != bitmats.shape[0] * k:
        raise ValueError("%d lanes of k=%d need %d rows, got %d"
                         % (bitmats.shape[0], k, bitmats.shape[0] * k,
                            count))
    _check_geometry(bitmats.shape[1], bitmats.shape[2], k, n, w,
                    bitmats.device)
    return k, n, idx


def matrix_encode_multi_rows_plain(bitmats: torch.Tensor,
                                   parts: list[torch.Tensor], rows,
                                   w: int) -> torch.Tensor:
    """The table entry point's function in plain PyTorch: the rows
    stacked into [P, 1, k, n] and :func:`matrix_encode_multi_plain`."""
    k, n, idx = _check_rows(bitmats, parts, rows, w)
    data = torch.cat([t.reshape(-1, n)[torch.from_numpy(i).to(t.device)]
                      for t, i in zip(parts, idx)])
    return matrix_encode_multi_plain(
        bitmats, data.reshape(bitmats.shape[0], 1, k, n), w)[:, 0]


def _multi_rows(bitmats: torch.Tensor, table: torch.Tensor, n: int,
                w: int) -> torch.Tensor:
    """[P, R/w, n]: one launch over the rows at a ``row_table``'s
    addresses (P*k of them, every one on 16 bytes)."""
    global MULTI_LAUNCHES
    lanes, rows, cols = bitmats.shape
    k = cols // w
    if table.numel() != lanes * k or table.dtype != torch.int64:
        raise ValueError("a table of %d int64 addresses for %d lanes of "
                         "k=%d, got %d" % (lanes * k, lanes, k,
                                           table.numel()))
    out = torch.empty((lanes, rows // w, n), dtype=torch.uint8,
                      device=bitmats.device)
    if out.numel() == 0:        # no work: the entry point launches nothing
        return out
    lib = _kernel()
    with torch.cuda.device(bitmats.device):
        stream = torch.cuda.current_stream(bitmats.device).cuda_stream
        rc = lib.gf_bitmatrix_encode_multi_rows(
            bitmats.data_ptr(), lanes, rows, k, w, table.data_ptr(),
            out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError("gf_bitmatrix_encode_multi_rows failed with "
                           "code %d%s" % (rc, _build.launch_failure(lib)))
    with _count_lock:
        MULTI_LAUNCHES += 1
    return out


def matrix_encode_multi_rows(bitmats: torch.Tensor,
                             parts: list[torch.Tensor], rows,
                             w: int) -> torch.Tensor:
    """[P, R/w, n] uint8: lane p's bitmatrix times its k data rows, which
    are rows p*k ... p*k + k - 1 of the parts' rows in order (rows[i]
    indexes parts[i].reshape(-1, n); None takes all), in one launch of
    the GPU kernel that reads each row where it lies.

    bitmats: [P, R, k*w] 0/1 uint8 on the parts' device. CUDA rows must
    start on 16 bytes (the kernel's vector): a row that does not is
    refused with its address. The caller keeps the parts from reuse
    until the launch has read them (``record_stream``). A CPU tensor
    takes the plain version."""
    k, n, idx = _check_rows(bitmats, parts, rows, w)
    if bitmats.device.type == "cpu":
        return matrix_encode_multi_rows_plain(bitmats, parts, idx, w)
    if bitmats.device.type != "cuda":
        raise ValueError("no kernel for device %s" % bitmats.device)
    if not bitmats.is_contiguous():
        raise ValueError("bitmats must be contiguous")
    table, n, unaligned = row_table(parts, idx)
    if unaligned is not None:
        raise ValueError("row at 0x%x is not on 16 bytes, which the "
                         "kernel's vector loads need" % unaligned)
    return _multi_rows(bitmats, table, n, w)
