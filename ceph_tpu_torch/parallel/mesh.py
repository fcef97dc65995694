"""Device-mesh sharding of the codec hot path.

Port of ``ceph_tpu/parallel/mesh.py``. EC stripes are embarrassingly
parallel, so the natural mesh is 2-D:

  - "stripe" axis: data parallelism over the batch of in-flight stripes;
  - "block" axis: parallelism over byte columns (a single huge object's
    chunks split across devices).

A product partitions along both with no exchange between devices:
parity bytes depend only on their own byte column. The reference's mesh
is a ``jax.sharding.Mesh`` over the devices of one process; here it is a
:class:`Mesh` over a list of ``torch.device``s of one process, which may
repeat a device (``["cpu"] * 8`` in the tests, ``["cuda:0"] * 4`` on one
card). A sharded step splits a ``[B, r, N]`` array into the reference's
blocks (:func:`partition`: device (i, j) holds stripes
``i*B/a:(i+1)*B/a`` and columns ``j*N/b:(j+1)*N/b``), each its own
contiguous tensor on its device; the codec's layout kernel runs on each
block there (``xor_mm.matrix_encode``, one GF-kernel launch a block on
the card, with the bitmatrix cached per device), and the block outputs
are reassembled: a host array for a host input, a tensor on the input's
device for a tensor.

Columns split on whole words: a w-bit element of the element layout, a
superblock of w packets of the packet layout (:func:`_word`). Where the
reference's psum reduces a checksum across devices, the port sums the
per-block partials: each block's byte sum mod 2^32 is the digest
kernel's sum half (``ops/digest_kernel.chunk_digest``, one launch a
block on the card), and the partials are summed mod 2^32 on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..common.profiler import PROFILER
from ..device import resolve_device
from ..ops import digest_kernel
from .placement import _local_devices

__all__ = ["Mesh", "Block", "make_mesh", "partition", "encode_sharded",
           "decode_sharded", "MeshChecksumError", "mesh_checksum",
           "recover_sharded", "repair_sharded"]

_M32 = 0xFFFFFFFF


class Mesh:
    """An n-D grid of torch devices with named axes: ``devices`` is a
    numpy object array of ``torch.device``, ``shape[name]`` the size of
    an axis, as on the reference's ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names):
        given = np.asarray(devices, dtype=object)
        if given.ndim != len(axis_names):
            raise ValueError("mesh of shape %s for axes %r"
                             % (given.shape, tuple(axis_names)))
        self.devices = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(given.shape):
            self.devices[idx] = torch.device(given[idx])
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, given.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _factor2(n: int) -> tuple[int, int]:
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return max(a, 1), n // max(a, 1)


def mesh_devices(n_devices: int | None = None, devices=None) -> np.ndarray:
    """The first n of `devices` (an explicit list, resolved: a bare
    "cuda" is the current card; default: the visible CUDA devices) as a
    flat object array; raises where there are none or too few."""
    if devices is None:
        devices = _local_devices()
        if not devices:
            raise RuntimeError(
                "CUDA is not available; pass devices=[...] (for example "
                "['cpu'] * 4) to build a mesh on the host")
    devices = [resolve_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError("a mesh of %d devices over %d given"
                         % (n_devices, len(devices)))
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices[:n_devices]
    return grid


def make_mesh(n_devices: int | None = None, devices=None,
              axis_names=("stripe", "block")) -> Mesh:
    """A 2-D mesh over the first n of `devices` (default: the visible
    CUDA devices), factored as near a square as n allows. An explicit
    list may repeat a device."""
    grid = mesh_devices(n_devices, devices)
    return Mesh(grid.reshape(_factor2(grid.size)), axis_names)


@dataclass(frozen=True)
class Block:
    """One device's block of a sharded [B, r, N] array."""
    index: tuple            # (i, j) on the mesh
    device: torch.device
    stripes: tuple          # (start, stop) along B
    columns: tuple          # (start, stop) along N
    data: torch.Tensor | None = None


def _word(codec) -> int:
    """Bytes a block's columns come in: a w-bit word of the element
    layout, a superblock of w packets of the packet layout."""
    packetsize = getattr(codec, "packetsize", 0)
    return codec.w * packetsize if packetsize else max(1, codec.w // 8)


def partition(shape, mesh: Mesh, word: int = 1) -> list[Block]:
    """The blocks of a [B, r, N] array over a (stripe, block) mesh, in
    the mesh's order, without data: device (i, j) holds stripes
    i*B/a:(i+1)*B/a and columns j*N/b:(j+1)*N/b (the reference's
    ``P(stripe, None, block)``). B must divide by a and N by b words."""
    stripe, block = mesh.axis_names
    a, b = mesh.shape[stripe], mesh.shape[block]
    n_b, n = int(shape[0]), int(shape[-1])
    if n_b % a or n % (b * word):
        raise ValueError(
            "[%d, ..., %d] does not split into %d x %d blocks of whole "
            "%d-byte words" % (n_b, n, a, b, word))
    bs, bn = n_b // a, n // b
    return [Block((i, j), mesh.devices[i, j], (i * bs, (i + 1) * bs),
                  (j * bn, (j + 1) * bn))
            for i in range(a) for j in range(b)]


def _upload(part, device: torch.device) -> torch.Tensor:
    if isinstance(part, torch.Tensor):
        return part.to(device).contiguous()
    part = np.ascontiguousarray(part, dtype=np.uint8)
    if not part.flags.writeable:
        part = part.copy()
    return torch.from_numpy(part).to(device)


def _place(x, mesh: Mesh, word: int) -> list[Block]:
    """Each block of x copied to its device as a contiguous tensor."""
    return [Block(p.index, p.device, p.stripes, p.columns, _upload(
        x[p.stripes[0]:p.stripes[1], :, p.columns[0]:p.columns[1]],
        p.device)) for p in partition(x.shape, mesh, word)]


def _step(bitmat, x, blocks: list[Block], apply) -> list[torch.Tensor]:
    """One sharded product: `apply` on each block where it lies. Its
    profiler signature is the bitmatrix's and the whole input's shape,
    as the reference's jitted step keys on them."""
    return [apply(blk.data) for blk in blocks]


_STEPS = {name: PROFILER.wrap_kernel("mesh." + name, _step)
          for name in ("encode_sharded", "decode_sharded", "repair_sharded")}


def _run(name, codec, entry, x, blocks) -> list[torch.Tensor]:
    """The codec's layout kernel with `entry`'s matrix on every block;
    the bitmatrix's device copy is cached per device in the entry (the
    generator's in the codec)."""
    gf_matrix, bitmat = entry["gf"], entry["bitmat"]
    return _STEPS[name](bitmat, x, blocks, lambda d: codec._apply_matrix(
        gf_matrix, bitmat, d, entry))


def _assemble(blocks: list[Block], outs: list[torch.Tensor], like):
    """The block outputs as one [B, R, N] array: numpy for a host input,
    a tensor on the input's device for a tensor."""
    n_b = max(blk.stripes[1] for blk in blocks)
    n = max(blk.columns[1] for blk in blocks)
    shape = (n_b, outs[0].shape[1], n)
    if isinstance(like, torch.Tensor):
        out = torch.empty(shape, dtype=torch.uint8, device=like.device)
        for blk, o in zip(blocks, outs):
            out[blk.stripes[0]:blk.stripes[1], :,
                blk.columns[0]:blk.columns[1]] = o.to(like.device)
        return out
    out = np.empty(shape, dtype=np.uint8)
    for blk, o in zip(blocks, outs):
        out[blk.stripes[0]:blk.stripes[1], :,
            blk.columns[0]:blk.columns[1]] = o.cpu().numpy()
    return out


def encode_sharded(codec, data, mesh: Mesh):
    """Encode a [B, k, N] batch sharded over (stripe, block): one product
    a block, on its device; returns the [B, m, N] parity, reassembled.
    B must divide by the stripe axis and N by the block axis in words."""
    blocks = _place(data, mesh, _word(codec))
    entry = {"gf": codec.coding, "bitmat": codec._bitmat}
    return _assemble(blocks, _run("encode_sharded", codec, entry, data,
                                  blocks), data)


def decode_sharded(codec, avail_rows, chunks, mesh: Mesh):
    """Reconstruct all chunk rows from k available ones, sharded like
    encode_sharded: chunks [B, k, N] -> [B, n, N]. The decode bitmatrix
    comes from the codec's table cache; byte columns decode
    independently."""
    entry = codec._decode_entry(tuple(avail_rows))
    blocks = _place(chunks, mesh, _word(codec))
    return _assemble(blocks, _run("decode_sharded", codec, entry, chunks,
                                  blocks), chunks)


class MeshChecksumError(RuntimeError):
    """The checksum of the device-resident survivor chunks disagrees
    with the host sum taken when they were received: the bytes that
    reached the mesh are not the bytes the primary got."""


def _checksum(blocks: list[Block]) -> int:
    """Sum of every block's bytes mod 2^32: per block the digest
    kernel's sum half (its rows' sums mod 2^32), summed in int64."""
    total = 0
    for blk in blocks:
        if blk.data.numel() == 0:
            continue
        s, _ws = digest_kernel.chunk_digest(
            blk.data.reshape(-1, blk.data.shape[-1]))
        total += int((s.view(torch.int32).to(torch.int64) & _M32).sum())
    return total & _M32


def mesh_checksum(x, mesh: Mesh, word: int = 1) -> int:
    """The mesh checksum of a [B, r, N] array: its blocks' byte sums
    mod 2^32, each taken on its device, summed mod 2^32."""
    return _checksum(_place(x, mesh, word))


def _host_sum(a: np.ndarray) -> int:
    return int(a.astype(np.uint64).sum()) & _M32


def _padded(a: np.ndarray, mesh: Mesh, word: int) -> np.ndarray:
    """a zero-padded to whole blocks: stripes to the stripe axis, columns
    to whole words of the block axis. Zero stripes and columns code to
    zeros (the code is linear and byte columns are independent)."""
    stripe, block = mesh.axis_names
    s, n = a.shape[0], a.shape[-1]
    pad_s = (-s) % mesh.shape[stripe]
    pad_n = (-n) % (mesh.shape[block] * word)
    if not (pad_s or pad_n):
        return a
    return np.pad(a, ((0, pad_s), (0, 0), (0, pad_n)))


def _checked_blocks(a, mesh, word, expected_sum, what) -> list[Block]:
    """a's blocks on their devices, after their checksum has matched
    `expected_sum` (the host sum of a, taken here when None)."""
    if expected_sum is None:
        expected_sum = _host_sum(a)
    blocks = _place(_padded(a, mesh, word), mesh, word)
    got = _checksum(blocks)
    if got != expected_sum & _M32:
        raise MeshChecksumError(
            "mesh %s checksum mismatch: device sum %d != host sum %d"
            % (what, got, expected_sum & _M32))
    return blocks


def recover_sharded(codec, avail_rows, chunks, target_row, mesh=None,
                    expected_sum=None):
    """Cross-chip recovery: reconstruct one missing row from k survivor
    chunk streams without gathering them on one device.

    chunks: [S, k, N] host survivors (rows ordered as avail_rows). The
    batch is padded to whole blocks and sharded over (stripe, block), the
    mesh checksum is compared against `expected_sum` (host sum mod 2^32
    of the survivors, computed here when not supplied), and the decode
    runs on the blocks already on their devices. Returns the target row
    [S, N] as host uint8; raises MeshChecksumError when the checksum
    trips."""
    if mesh is None:
        mesh = make_mesh()
    chunks = np.asarray(chunks, dtype=np.uint8)
    s, _k, n = chunks.shape
    blocks = _checked_blocks(chunks, mesh, _word(codec), expected_sum,
                             "recovery")
    entry = codec._decode_entry(tuple(avail_rows))
    outs = _run("decode_sharded", codec, entry, chunks, blocks)
    row = _assemble(blocks, [o[:, target_row:target_row + 1] for o in outs],
                    chunks)
    return np.ascontiguousarray(row[:s, 0, :n])


def repair_sharded(codec, target, helpers, fractions, mesh=None,
                   expected_sum=None):
    """Mesh combine of MSR helper repair fractions (the repair analog of
    recover_sharded): [S, d, sub] stacked fractions (rows in `helpers`
    order) -> rebuilt target chunks [S, alpha*sub], with the same
    checksum before the combine matrix runs on each block. Raises
    MeshChecksumError on mismatch."""
    if mesh is None:
        mesh = make_mesh()
    fractions = np.asarray(fractions, dtype=np.uint8)
    s, _d, sub = fractions.shape
    blocks = _checked_blocks(fractions, mesh, _word(codec), expected_sum,
                             "repair")
    entry = codec._combine_entry(target, tuple(helpers))
    full = _assemble(blocks, _run("repair_sharded", codec, entry, fractions,
                                  blocks), fractions)
    return np.ascontiguousarray(full[:s, :, :sub]).reshape(s, -1)
