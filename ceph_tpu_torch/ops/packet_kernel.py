"""Wrapper of the packet-layout bitmatrix kernel (``csrc/gf_packet.cu``).

Port of ``ceph_tpu/ops/xor_mm.py:bitmatrix_encode``, the XLA program that
applies the Cauchy and Liberation bitmatrix techniques: data
``[..., k, N]`` read as ``[..., k, S, w, P]`` (S superblocks of w packets
of P bytes), output packet ``(i, s, t)`` the bytewise XOR of the input
packets ``(j, s, u)`` with ``bitmat[i*w + t, j*w + u] = 1``.

:func:`bitmatrix_encode` launches the kernel for a CUDA tensor and runs
:func:`ceph_tpu_torch.ops.xor_mm.bitmatrix_encode_plain` only for a CPU
tensor; it never falls back. The C entry point picks one of three
designs (``DESIGNS``) from the geometry, the bitmatrix's count of set
entries where the caller gives it, and the pointers' alignment: "staged"
(each superblock's packets tiled through shared memory, every input byte
read once), "vector" (16-byte columns loaded per set bit, for geometries
past the staged design's budget and where it was faster: at most 3
selects per input packet on average) and "byte" (a packetsize not a
multiple of 16 or an unaligned pointer); :func:`kernel_design` asks it
which. ``LAUNCHES`` counts kernel launches; :func:`launches_by_design`
reads the counts that the C entry point keeps per design, and
:func:`reset_launches` sets all of them to 0.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .xor_mm import bitmatrix_encode_plain

__all__ = ["bitmatrix_encode", "kernel_design", "launches_by_design",
           "reset_launches", "smem_bytes", "check_smem", "LAUNCHES",
           "DESIGNS"]

_SOURCE = "gf_packet"

DESIGNS = ("staged", "vector", "byte")  # by the C entry point's number

LAUNCHES = 0
_count_lock = threading.Lock()
_lib = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        args = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong]
        lib.gf_packet_encode.argtypes = [*args, ctypes.c_longlong,
                                         ctypes.c_void_p]
        lib.gf_packet_encode.restype = ctypes.c_int
        lib.gf_packet_encode_design.argtypes = [ctypes.c_int, *args,
                                                ctypes.c_void_p]
        lib.gf_packet_encode_design.restype = ctypes.c_int
        lib.gf_packet_design.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_longlong]
        lib.gf_packet_design.restype = ctypes.c_int
        lib.gf_packet_launches.argtypes = [ctypes.c_int]
        lib.gf_packet_launches.restype = ctypes.c_longlong
        lib.gf_packet_reset_launches.argtypes = []
        lib.gf_packet_reset_launches.restype = None
        _lib = lib
    return _lib


def kernel_design(bitmat: torch.Tensor, data: torch.Tensor, w: int,
                  packetsize: int, set_bits: int | None = None) -> str:
    """The design :func:`bitmatrix_encode` takes for these CUDA tensors
    and arguments: the geometry, the data pointer's alignment (the
    output's is always 16 bytes) and `set_bits`."""
    lib = _kernel()
    k, n = data.shape[-2:]
    with torch.cuda.device(data.device):
        rc = lib.gf_packet_design(
            bitmat.shape[0], k, w, packetsize, int(data.data_ptr() % 16 == 0),
            -1 if set_bits is None else set_bits)
    if rc < 0:
        raise RuntimeError("gf_packet_design(%d, %d, %d, %d) failed with "
                           "code %d" % (bitmat.shape[0], k, w, packetsize,
                                        rc))
    return DESIGNS[rc]


def launches_by_design() -> dict[str, int]:
    """{design: kernel launches since the last reset}, as the C entry point
    counts them where it launches each kernel."""
    if _lib is None:            # nothing was built, so nothing launched
        return dict.fromkeys(DESIGNS, 0)
    return {d: int(_lib.gf_packet_launches(i)) for i, d in enumerate(DESIGNS)}


def reset_launches() -> None:
    """Sets ``LAUNCHES`` and the per-design counts to 0."""
    global LAUNCHES
    with _count_lock:
        LAUNCHES = 0
        if _lib is not None:
            _lib.gf_packet_reset_launches()


def smem_bytes(rows: int, cols: int) -> int:
    """Shared memory of one block of the vector and byte designs, the most
    any geometry needs (the staged design is taken only where it fits): an
    8-byte offset per input packet of a superblock and ceil(cols/32)
    uint32 masks per bitmatrix row."""
    return cols * 8 + rows * (-(-cols // 32)) * 4


def check_smem(rows: int, cols: int, limit: int) -> None:
    """Raises ValueError when a [rows, cols] bitmatrix needs more than
    `limit` bytes of shared memory per block."""
    if smem_bytes(rows, cols) > limit:
        raise ValueError("a [%d, %d] bitmatrix exceeds the kernel's %d bytes "
                         "of shared memory" % (rows, cols, limit))


def _check(bitmat: torch.Tensor, data: torch.Tensor, w: int,
           packetsize: int) -> None:
    if not 2 <= w <= 32:
        raise ValueError("w=%d must be in 2..32" % w)
    if packetsize < 1:
        raise ValueError("packetsize=%d must be >= 1" % packetsize)
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
    if rows % w or n % (w * packetsize):
        raise ValueError("bitmat rows %d and N %d must be multiples of w=%d "
                         "and w*packetsize=%d" % (rows, n, w, w * packetsize))
    if bitmat.device != data.device:
        raise ValueError("bitmat on %s, data on %s"
                         % (bitmat.device, data.device))
    if data.device.type == "cuda":     # the card's own opt-in limit
        check_smem(rows, cols, torch.cuda.get_device_properties(
            data.device).shared_memory_per_block_optin)
    if not (bitmat.is_contiguous() and data.is_contiguous()):
        raise ValueError("bitmat and data must be contiguous")


def bitmatrix_encode(bitmat: torch.Tensor, data: torch.Tensor, w: int,
                     packetsize: int, design: str | None = None,
                     set_bits: int | None = None) -> torch.Tensor:
    """[..., k, N] uint8 -> [..., R/w, N] uint8 through the GPU kernel.

    bitmat: [R, k*w] 0/1 uint8 on data's device; N a multiple of
    w*packetsize. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel on the current stream or raises. `set_bits`, the
    count of set entries of `bitmat` where the caller knows it (a codec
    does, from its host copy), steers the design and nothing else.
    `design`, one
    of ``DESIGNS``, launches that design in place of the one the
    geometry takes, so that designs can be timed against each other on
    one geometry; the launch raises where it does not take the geometry
    or the pointers' alignment."""
    global LAUNCHES
    _check(bitmat, data, w, packetsize)
    if design is not None and design not in DESIGNS:
        raise ValueError("design %r is not one of %s" % (design, DESIGNS))
    if data.device.type == "cpu":
        return bitmatrix_encode_plain(bitmat, data, w, packetsize)
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
        args = (bitmat.data_ptr(), rows, k, w, packetsize, data.data_ptr(),
                out.data_ptr(), batch, n)
        if design is None:
            rc = lib.gf_packet_encode(
                *args, -1 if set_bits is None else set_bits, stream)
        else:
            rc = lib.gf_packet_encode_design(DESIGNS.index(design), *args,
                                             stream)
    if rc != 0:
        raise RuntimeError("gf_packet_encode (design %s) failed with code %d"
                           % (design or "picked", rc))
    with _count_lock:
        LAUNCHES += 1
    return out
