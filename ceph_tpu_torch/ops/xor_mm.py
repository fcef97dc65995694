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
    on a CUDA tensor and its plain version on a CPU tensor. A product
    wider than the kernel's ``MAX_BITS`` columns (the MSR code from
    k = 10) is split by :func:`split_encode`, on either device."""
    from .gf_kernel import smem_limit
    return split_encode(bitmat, data, w, smem_limit(data.device))


def split_blocks(rows: int, cols: int, w: int,
                 smem_limit: int | None) -> tuple[list, list]:
    """The (start, stop) row and column blocks of an [rows, cols]
    bitmatrix that one kernel launch each takes: columns in blocks of at
    most ``MAX_BITS`` (whole elements, since MAX_BITS is a multiple of
    w), and rows in blocks of whole elements whose popcount masks fit
    `smem_limit` bytes (None: no limit, one row block)."""
    from .gf_kernel import MAX_BITS, mask_bytes
    col_blocks = [(c, min(c + MAX_BITS, cols))
                  for c in range(0, cols, MAX_BITS)] or [(0, cols)]
    step = rows or 1
    if smem_limit is not None and rows:
        per_row = mask_bytes(1, min(cols, MAX_BITS))
        step = smem_limit // per_row // w * w
        if step < w:
            raise ValueError("one element row of a [%d, %d] bitmatrix "
                             "exceeds %d bytes of shared memory"
                             % (rows, cols, smem_limit))
    row_blocks = [(r, min(r + step, rows))
                  for r in range(0, rows, step)] or [(0, rows)]
    return row_blocks, col_blocks


def split_encode(bitmat: torch.Tensor, data: torch.Tensor, w: int,
                 smem_limit: int | None) -> torch.Tensor:
    """:func:`matrix_encode` in blocks (:func:`split_blocks`): each
    column block is one kernel launch on its slice of the data rows, and
    the partial products of a row block are XORed (glue around the
    launches: GF(2) sums are XORs); row blocks are concatenated. One
    block is one plain launch."""
    from .gf_kernel import matrix_encode as kernel_encode
    if bitmat.dim() != 2 or data.dim() < 2:
        return kernel_encode(bitmat, data, w)   # refused with its shapes
    rows, cols = bitmat.shape
    row_blocks, col_blocks = split_blocks(rows, cols, w, smem_limit)
    if len(row_blocks) == 1 and len(col_blocks) == 1:
        return kernel_encode(bitmat, data, w)
    if cols != data.shape[-2] * w:
        raise ValueError("bitmat has %d columns, data k*w is %d"
                         % (cols, data.shape[-2] * w))
    parts = []
    for r0, r1 in row_blocks:
        acc = None
        for c0, c1 in col_blocks:
            part = kernel_encode(bitmat[r0:r1, c0:c1].contiguous(),
                                 data[..., c0 // w:c1 // w, :].contiguous(),
                                 w)
            acc = part if acc is None else acc.bitwise_xor_(part)
        parts.append(acc)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


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
