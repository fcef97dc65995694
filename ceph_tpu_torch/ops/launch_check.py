"""Wrapper of ``csrc/launch_common.cu``: a launch at the edge of
``launch_common::resident_blocks``' shared-memory opt-in.

:func:`smem_edge` launches a kernel with 1 KiB of static shared memory and
`dynamic_bytes` of dynamic shared memory (48 KiB by default, so that the
two together pass the 48 KiB a block takes without the opt-in) and returns
its static size and each block's sum; :func:`smem_edge_expected` is the
sum every block must give. CUDA only: there is no plain version, the
check is of the launch itself.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

EDGE_BYTES = 48 * 1024
_STATIC_WORDS = 256


def smem_edge(dynamic_bytes: int = EDGE_BYTES, blocks: int = 4,
              device="cuda") -> tuple[int, torch.Tensor]:
    """(static shared bytes of the kernel, sums [blocks] int64) of one
    launch; raises, naming the sizes, if the launch is refused."""
    if dynamic_bytes % 4:
        raise ValueError("dynamic_bytes must be a multiple of 4")
    device = torch.device(device)
    lib = _build.load("launch_common")
    fn = lib.launch_smem_edge
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    sums = torch.zeros(blocks, dtype=torch.int64, device=device)
    static = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        rc = fn(dynamic_bytes, blocks, sums.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream,
                ctypes.byref(static))
    if rc != 0:
        raise RuntimeError("launch_smem_edge(%d dynamic bytes) failed with "
                           "code %d%s" % (dynamic_bytes, rc,
                                          _build.launch_failure(lib)))
    return static.value, sums


def smem_edge_expected(dynamic_bytes: int = EDGE_BYTES) -> int:
    """The sum each block of :func:`smem_edge` writes."""
    words = dynamic_bytes // 4
    total = sum(range(_STATIC_WORDS))
    total += sum((i * 2654435761) & 0xFFFFFFFF for i in range(words))
    return total
