"""Wrapper of the GF(2^w) bitmatrix kernel (``csrc/gf_bitmatrix.cu``).

Port of ``ceph_tpu/ops/pallas_gf.py`` (``matrix_encode8`` and its Pallas
``_encode_kernel``). On Hopper the single pass that reads the k data bytes
of a column and writes its parity bytes, staging nothing in device memory,
is the natural kernel, so here it carries the main path: every encode and
every decode bitmatrix of the Reed-Solomon codecs, at w = 8, 16 and 32.

The source holds two designs, and its entry point picks one from the
geometry alone: the bit-sliced kernel for w = 8 with k*8 <= 128 (the main
path's), the popcount kernel for every other geometry.

:func:`matrix_encode` launches the kernel for a CUDA tensor and runs
:func:`matrix_encode_plain` only for a CPU tensor; it never falls back.
``LAUNCHES`` counts kernel launches; :func:`launches_by_design` reads the
counts that the C entry point keeps per design where it launches each
kernel, and :func:`reset_launches` sets all of them to 0.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .xor_mm import pack_element_bits, unpack_element_bits, xor_matmul

__all__ = ["matrix_encode", "matrix_encode_plain", "kernel_design",
           "launches_by_design", "reset_launches", "DESIGNS", "LAUNCHES",
           "MAX_BITS"]

MAX_BITS = 512              # k*w the kernel takes
_MAX_SMEM = 48 * 1024       # packed bitmatrix bytes of the popcount design
_SOURCE = "gf_bitmatrix"

DESIGNS = ("popcount", "bitsliced")  # by the C entry point's design number

LAUNCHES = 0
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
        lib.gf_bitmatrix_design.argtypes = [ctypes.c_int] * 3
        lib.gf_bitmatrix_design.restype = ctypes.c_int
        lib.gf_bitmatrix_launches.argtypes = [ctypes.c_int]
        lib.gf_bitmatrix_launches.restype = ctypes.c_longlong
        lib.gf_bitmatrix_reset_launches.argtypes = []
        lib.gf_bitmatrix_reset_launches.restype = None
        _lib = lib
    return _lib


def kernel_design(rows: int, k: int, w: int, device) -> str:
    """The design the kernel's entry point takes for a [rows, k*w]
    bitmatrix on a CUDA device: "bitsliced" or "popcount"."""
    lib = _kernel()
    with torch.cuda.device(torch.device(device)):
        rc = lib.gf_bitmatrix_design(rows, k, w)
    if rc < 0:
        raise RuntimeError("gf_bitmatrix_design(%d, %d, %d) failed with "
                           "code %d" % (rows, k, w, rc))
    return DESIGNS[rc]


def launches_by_design() -> dict[str, int]:
    """{design: kernel launches since the last reset}, as the C entry
    point counts them where it launches each kernel."""
    if _lib is None:            # nothing was built, so nothing launched
        return dict.fromkeys(DESIGNS, 0)
    return {d: int(_lib.gf_bitmatrix_launches(i))
            for i, d in enumerate(DESIGNS)}


def reset_launches() -> None:
    """Sets ``LAUNCHES`` and the per-design counts to 0."""
    global LAUNCHES
    with _count_lock:
        LAUNCHES = 0
        if _lib is not None:
            _lib.gf_bitmatrix_reset_launches()


def _mask_words(bits: int) -> int:
    """uint32 masks per bitmatrix row in the kernel (power of two)."""
    nw = 1
    while nw * 32 < bits:
        nw *= 2
    return nw


def _check(bitmat: torch.Tensor, data: torch.Tensor, w: int) -> None:
    if w not in (8, 16, 32):
        raise ValueError("w=%d must be one of 8, 16, 32" % w)
    if bitmat.dtype != torch.uint8 or data.dtype != torch.uint8:
        raise TypeError("bitmat and data must be uint8, got %s and %s"
                        % (bitmat.dtype, data.dtype))
    if bitmat.dim() != 2 or data.dim() < 2:
        raise ValueError("bitmat must be [R, k*w] and data [..., k, N]; "
                         "got %s and %s" % (tuple(bitmat.shape),
                                            tuple(data.shape)))
    rows, cols = bitmat.shape
    k, n = data.shape[-2:]
    if cols != k * w:
        raise ValueError("bitmat has %d columns, data k*w is %d"
                         % (cols, k * w))
    if cols > MAX_BITS:
        raise ValueError("k*w=%d exceeds %d" % (cols, MAX_BITS))
    if rows % w or n % (w // 8):
        raise ValueError("bitmat rows %d and N %d must be multiples of "
                         "w=%d and w/8" % (rows, n, w))
    if rows * _mask_words(cols) * 4 > _MAX_SMEM:
        raise ValueError("bitmatrix of %d rows exceeds the kernel's "
                         "shared memory" % rows)
    if bitmat.device != data.device:
        raise ValueError("bitmat on %s, data on %s"
                         % (bitmat.device, data.device))
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
        rc = lib.gf_bitmatrix_encode(bitmat.data_ptr(), rows, k, w,
                                     data.data_ptr(), out.data_ptr(), batch,
                                     n, stream)
    if rc != 0:
        raise RuntimeError("gf_bitmatrix_encode failed with code %d" % rc)
    with _count_lock:
        LAUNCHES += 1
    return out
