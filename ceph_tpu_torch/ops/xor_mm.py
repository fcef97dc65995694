"""XOR-matmul: the GF(2) primitive behind every codec, in plain PyTorch.

Port of ``ceph_tpu/ops/xor_mm.py``. GF(2^w) erasure-code math decomposes
into binary matrices applied to bit vectors with XOR accumulation (see
:mod:`ceph_tpu_torch.ops.gf`). The helpers here are the plain PyTorch
form of that product (unpack -> 0/1 matmul -> ``& 1`` -> pack); they make
up :func:`ceph_tpu_torch.ops.gf_kernel.matrix_encode_plain`, which the CPU
path runs and the GPU kernel is held against.

Layout (matching :mod:`ceph_tpu_torch.ops.gf_ref`): element layout, a
chunk is a flat array of little-endian w-bit elements; bit c of element j
of a column sits on row ``j*w + c``.
"""

from __future__ import annotations

import torch


def xor_matmul(bitmat: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """out[..., r, f] = XOR_c bitmat[r, c] & bits[..., c, f].

    bitmat: [R, C] 0/1. bits: [..., C, F] 0/1. Returns [..., R, F] uint8.
    The product runs as a float32 matmul of 0/1 values: every product is
    0 or 1 and every partial sum an integer <= C <= 2^24, all exactly
    representable in float32, so the sum and the ``& 1`` are exact in any
    summation order. (torch.matmul has no int32 kernel on CUDA, and int8
    matmul on the CPU returns int8.) TF32 must be off for a comparison on
    the card: 0/1 inputs survive TF32's 10-bit mantissa too, but the
    reference states and sets it.
    """
    acc = torch.matmul(bitmat.to(torch.float32), bits.to(torch.float32))
    return (acc.to(torch.int32) & 1).to(torch.uint8)


def unpack_element_bits(data: torch.Tensor, w: int) -> torch.Tensor:
    """[..., k, N] uint8 -> [..., k*w, N*8//w] bits (element-bit layout)."""
    *lead, k, n = data.shape
    wb = w // 8
    ne = n // wb
    x = data.reshape(*lead, k, ne, wb)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = (x[..., None] >> shifts) & 1              # [..., k, ne, wb, 8]
    bits = bits.movedim(-3, -1)                      # [..., k, wb, 8, ne]
    return bits.reshape(*lead, k * w, ne)


def pack_element_bits(bits: torch.Tensor, w: int) -> torch.Tensor:
    """[..., m*w, ne] bits -> [..., m, ne*w//8] uint8."""
    *lead, rows, ne = bits.shape
    wb = w // 8
    m = rows // w
    x = bits.reshape(*lead, m, wb, 8, ne).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8,
                          device=bits.device).reshape(8, 1)
    byts = (x << shifts).sum(dim=-2, dtype=torch.uint8)  # [..., m, wb, ne]
    byts = byts.movedim(-2, -1)                          # [..., m, ne, wb]
    return byts.reshape(*lead, m, ne * wb)


def matrix_encode(bitmat: torch.Tensor, data: torch.Tensor,
                  w: int) -> torch.Tensor:
    """Element-layout GF(2^w) encode: [..., k, N] uint8 -> [..., R/w, N].

    bitmat is the [R, k*w] bitplane expansion of a generator or decode
    matrix (gf.generator_to_bitmatrix). Runs the hand-written GPU kernel
    on a CUDA tensor and its plain version on a CPU tensor. One launch
    takes up to ``gf_kernel.max_k`` data rows (k*w = 1,792 bits on an
    H100: the MSR code up to k = 15); a wider product is one launch per
    even block of data rows, and the partial products are XORed (GF(2)
    sums are XORs)."""
    from .gf_kernel import matrix_encode as kernel_encode, max_k
    if bitmat.dim() != 2 or data.dim() < 2:
        return kernel_encode(bitmat, data, w)   # refused with its shapes
    k = data.shape[-2]
    step = max_k(w, data.device)
    if step is None or k <= step:
        return kernel_encode(bitmat, data, w)
    if bitmat.shape[1] != k * w:
        raise ValueError("bitmat has %d columns, data k*w is %d"
                         % (bitmat.shape[1], k * w))
    step = -(-k // -(-k // step))           # even blocks of at most step
    acc = None
    for j in range(0, k, step):
        part = kernel_encode(bitmat[:, j * w:(j + step) * w].contiguous(),
                             data[..., j:j + step, :].contiguous(), w)
        acc = part if acc is None else acc.bitwise_xor_(part)
    return acc


def bitmatrix_encode_plain(bitmat: torch.Tensor, data: torch.Tensor, w: int,
                           packetsize: int) -> torch.Tensor:
    """Packet-layout bitmatrix encode in plain PyTorch: [..., k, N] uint8
    -> [..., R/w, N], N a multiple of w*packetsize (ref
    ``ceph_tpu/ops/xor_mm.py:110``). Each superblock's k*w packets are
    unpacked to bits, multiplied by the 0/1 bitmatrix and packed back."""
    *lead, k, n = data.shape
    m = bitmat.shape[0] // w
    p = packetsize
    s = n // (w * p)
    pk = data.reshape(*lead, k, s, w, p).movedim(-4, -3)  # [..., s, k, w, p]
    pk = pk.reshape(*lead, s, k * w, p)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((pk[..., None] >> shifts) & 1).reshape(*lead, s, k * w, p * 8)
    out_bits = xor_matmul(bitmat, bits)                   # [..., s, m*w, p*8]
    x = out_bits.reshape(*lead, s, m * w, p, 8)
    byts = (x << shifts).sum(dim=-1, dtype=torch.uint8)   # [..., s, m*w, p]
    byts = byts.reshape(*lead, s, m, w, p).movedim(-4, -3)
    return byts.reshape(*lead, m, n)


def bitmatrix_encode(bitmat: torch.Tensor, data: torch.Tensor, w: int,
                     packetsize: int, set_bits: int | None = None
                     ) -> torch.Tensor:
    """Packet-layout bitmatrix encode: [..., k, N] uint8 -> [..., R/w, N]
    (the Cauchy and Liberation techniques). Runs the hand-written GPU
    kernel on a CUDA tensor and :func:`bitmatrix_encode_plain` on a CPU
    tensor; `set_bits`, the count of set entries of `bitmat` where the
    caller knows it, steers the kernel's design."""
    from .packet_kernel import bitmatrix_encode as kernel_encode
    return kernel_encode(bitmat, data, w, packetsize, set_bits=set_bits)
