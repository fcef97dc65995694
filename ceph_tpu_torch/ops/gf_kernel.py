"""Wrapper of the GF(2^w) bitmatrix kernel (``csrc/gf_bitmatrix.cu``).

Port of ``ceph_tpu/ops/pallas_gf.py`` (``matrix_encode8`` and its Pallas
``_encode_kernel``). On Hopper the single pass that reads the k data bytes
of a column and writes its parity bytes, staging nothing in device memory,
is the natural kernel, so here it carries the main path: every encode and
every decode bitmatrix of the Reed-Solomon codecs, at w = 8, 16 and 32.

:func:`matrix_encode` launches the kernel for a CUDA tensor and runs
:func:`matrix_encode_plain` only for a CPU tensor; it never falls back.
``LAUNCHES`` counts kernel launches (set it to 0 to start a count).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .xor_mm import pack_element_bits, unpack_element_bits, xor_matmul

__all__ = ["matrix_encode", "matrix_encode_plain", "LAUNCHES", "MAX_BITS"]

MAX_BITS = 512              # k*w the kernel takes
_MAX_SMEM = 48 * 1024       # packed bitmatrix bytes the kernel takes
_SOURCE = "gf_bitmatrix"

LAUNCHES = 0
_count_lock = threading.Lock()
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load(_SOURCE).gf_bitmatrix_encode
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    fn = _kernel()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = fn(bitmat.data_ptr(), rows, k, w, data.data_ptr(),
                out.data_ptr(), batch, n, stream)
    if rc != 0:
        raise RuntimeError("gf_bitmatrix_encode failed with code %d" % rc)
    with _count_lock:
        LAUNCHES += 1
    return out
