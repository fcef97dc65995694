"""Fused write transform: the OSD's whole-object write on the device.

Port of ``ceph_tpu/osd/fused_transform.py``. Ceph's write path runs
checksum -> (compress) -> EC encode as separate host passes; here the
whole object write transform runs on the device over the staged
[S, k, chunk] batch, with no host read between its launches:

  (a) per-chunk crc32c + xxh32 digests of the raw data
      (K1 and K2 of ``csrc/write_transform.cu``),
  (b) in compress mode, an entropy probe (256-bin histogram -> Shannon
      bound) and the bit-plane container, with the compress-or-store
      decision taken on the device (K3),
  (c) the EC encode of the stored stream (``csrc/gf_bitmatrix.cu``), and
  (d) per-shard crc32 of the stored chunk streams in the zlib polynomial,
      exactly what HashInfo and deep scrub verify on disk (K1, un-shifting
      the zero tail of the capacity in compress mode).

One h2d of raw data, the launches, one d2h of parity + digests + the
stored stream. On a codec made with ``device="cpu"`` every step runs its
plain PyTorch version (``ceph_tpu_torch.ops.write_kernels``).

Compressed container layout (``alg=jax_device``, the reference's name, so
that the two packages read each other's objects; block B=64 bytes):
  [2*nb header bytes: (flags, consts) per block][stored planes, 8B each]
flags bit p set => bit-plane p stored raw; else constant, with its value
in consts bit p. Worst case 66/64 expansion; the device stores raw unless
comp_len / N <= required_ratio and the probe accepts. The ratio test runs
in 64-bit integers (the reference's int32 product wraps above 2,454,267
bytes at the default ratio). Decompression is a vectorized numpy pass.

Only element-layout matrix codecs (Reed-Solomon family, SHEC) fuse; other
codecs take the separate path.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import host_tensor, pinned_copy, to_numpy
from ..models.table_cache import device_entry_key
from ..ops import write_kernels, xor_mm

__all__ = ["FusedResult", "fused_supported", "run_fused", "finish_fused",
           "result_from_host", "plan_capacity", "bitplane_decompress",
           "bitplane_compress_host", "crc32c_host", "xxh32_host",
           "device_crc32", "dev_consts", "shannon_bytes_per_byte",
           "to_host", "COMP_ALG", "POLY_ZLIB", "POLY_C"]

COMP_ALG = "jax_device"
_BLOCK = 64

# -- GF(2) crc machinery (host precompute) ---------------------------------
#
# Column-mask convention: a 32x32 GF(2) matrix M is stored as 32 uint32
# columns, M[j] = M . e_j; apply(M, x) = XOR_{j: bit j of x} M[j].

POLY_ZLIB = 0xEDB88320    # reflected crc32 (zlib/HashInfo/deep-scrub)
POLY_C = 0x82F63B78       # reflected crc32c (Castagnoli)
_LEVELS = 31              # shift matrices for appends up to 2^30 bytes


def _crc_table(poly: int) -> np.ndarray:
    tab = np.zeros(256, dtype=np.uint64)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (poly if c & 1 else 0)
        tab[b] = c
    return tab.astype(np.uint32)


def _mat_apply(mat: np.ndarray, x: int) -> int:
    r = 0
    j = 0
    while x:
        if x & 1:
            r ^= int(mat[j])
        x >>= 1
        j += 1
    return r


def _mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.array([_mat_apply(a, int(b[j])) for j in range(32)],
                    dtype=np.uint32)


def _mat_inv(mat: np.ndarray) -> np.ndarray:
    """GF(2) inverse by Gaussian elimination (rows as bit-vectors)."""
    m = [[(int(mat[j]) >> i) & 1 for j in range(32)] for i in range(32)]
    inv = [[1 if i == j else 0 for j in range(32)] for i in range(32)]
    for col in range(32):
        piv = next(r for r in range(col, 32) if m[r][col])
        m[col], m[piv] = m[piv], m[col]
        inv[col], inv[piv] = inv[piv], inv[col]
        for r in range(32):
            if r != col and m[r][col]:
                m[r] = [a ^ b for a, b in zip(m[r], m[col])]
                inv[r] = [a ^ b for a, b in zip(inv[r], inv[col])]
    out = np.zeros(32, dtype=np.uint32)
    for j in range(32):
        col = 0
        for i in range(32):
            col |= inv[i][j] << i
        out[j] = col
    return out


class _PolyConsts:
    """Per-polynomial host constants: byte table, append-2^l-zero-bytes
    matrices (and inverses), built once per process."""

    def __init__(self, poly: int):
        self.poly = poly
        self.table = _crc_table(poly)
        m1 = np.array([self._zero_byte_update(1 << j) for j in range(32)],
                      dtype=np.uint32)
        shifts = [m1]
        for _ in range(_LEVELS - 1):
            shifts.append(_mat_mul(shifts[-1], shifts[-1]))
        self.shift = np.stack(shifts)              # [.., 32]: append 2^l B
        self.inv = np.stack([_mat_inv(s) for s in shifts])

    def _zero_byte_update(self, state: int) -> int:
        return (state >> 8) ^ int(self.table[state & 0xFF])

    def shift_n(self, state: int, nbytes: int) -> int:
        """Host: crc register after appending nbytes zero bytes."""
        lvl = 0
        while nbytes:
            if nbytes & 1:
                state = _mat_apply(self.shift[lvl], state)
            nbytes >>= 1
            lvl += 1
        return state

    def slicing_tables(self) -> np.ndarray:
        """[15, 256]: T_k[b], k = 1..15, the register of byte b followed
        by k zero bytes (T_0 is the byte table), for K1's 16-byte steps."""
        tables = [self.table.astype(np.uint32)]
        for _ in range(15):
            prev = tables[-1]
            tables.append((prev >> np.uint32(8)) ^
                          tables[0][prev & np.uint32(0xFF)])
        return np.stack(tables[1:])

    def packed(self) -> np.ndarray:
        """The kernel's constants: table, shift matrices, inverses, then
        the slicing tables T_1..T_15."""
        return np.concatenate([self.table, self.shift.reshape(-1),
                               self.inv.reshape(-1),
                               self.slicing_tables().reshape(-1)]
                              ).astype(np.uint32)


_CONSTS: dict = {}
_CONSTS_LOCK = threading.RLock()


def _poly_consts(poly: int) -> _PolyConsts:
    with _CONSTS_LOCK:
        pc = _CONSTS.get(poly)
        if pc is None:
            pc = _CONSTS.setdefault(poly, _PolyConsts(poly))
        return pc


def dev_consts(device) -> dict:
    """{polynomial: uint32 [write_kernels.CONSTS_WORDS]} on `device`: the
    CRC tables, shift matrices and inverses, cached per torch.device (the
    codec bitmatrix constants' keying idiom)."""
    key = device_entry_key(device)
    with _CONSTS_LOCK:
        cache = _CONSTS.setdefault("dev", {})
        ent = cache.get(key)
        if ent is None:
            ent = cache.setdefault(key, {
                poly: torch.from_numpy(_poly_consts(poly).packed().view(
                    np.int32)).to(device).view(torch.uint32)
                for poly in (POLY_ZLIB, POLY_C)})
    return ent


# -- host oracles (tests, read path, scrub fallback) -----------------------

def crc32c_host(data, crc: int = 0) -> int:
    """crc32c (Castagnoli) of a byte buffer — the host oracle the device
    digests are verified against."""
    tab = _poly_consts(POLY_C).table
    c = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    for b in bytes(data):
        c = int(tab[(c ^ b) & 0xFF]) ^ (c >> 8)
    return (c ^ 0xFFFFFFFF) & 0xFFFFFFFF


_XXP1, _XXP2, _XXP3 = 2654435761, 2246822519, 3266489917
_XXP4, _XXP5 = 668265263, 374761393
_M32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32_host(data, seed: int = 0) -> int:
    """Pure-python xxh32 (spec implementation; host oracle)."""
    data = bytes(data)
    n = len(data)
    i = 0
    if n >= 16:
        acc = [(seed + _XXP1 + _XXP2) & _M32, (seed + _XXP2) & _M32,
               seed & _M32, (seed - _XXP1) & _M32]
        while i + 16 <= n:
            for lane in range(4):
                w = int.from_bytes(data[i + 4 * lane:i + 4 * lane + 4],
                                   "little")
                acc[lane] = (_rotl32((acc[lane] + w * _XXP2) & _M32, 13)
                             * _XXP1) & _M32
            i += 16
        h = (_rotl32(acc[0], 1) + _rotl32(acc[1], 7) + _rotl32(acc[2], 12)
             + _rotl32(acc[3], 18)) & _M32
    else:
        h = (seed + _XXP5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        w = int.from_bytes(data[i:i + 4], "little")
        h = (_rotl32((h + w * _XXP3) & _M32, 17) * _XXP4) & _M32
        i += 4
    while i < n:
        h = (_rotl32((h + data[i] * _XXP5) & _M32, 11) * _XXP1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _XXP2) & _M32
    h ^= h >> 13
    h = (h * _XXP3) & _M32
    h ^= h >> 16
    return h


def shannon_bytes_per_byte(data) -> float:
    """Host entropy probe twin: Shannon bound in bits/byte / 8."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    if arr.size == 0:
        return 0.0
    counts = np.bincount(arr, minlength=256).astype(np.float64)
    p = counts[counts > 0] / arr.size
    return float(-(p * np.log2(p)).sum() / 8.0)


def bitplane_compress_host(data) -> tuple[bytes, int]:
    """Host twin of the device bit-plane stage: same container, byte for
    byte. Returns (container, padded_len) — the tests use it as the oracle
    the device stage must match."""
    raw = np.frombuffer(bytes(data), dtype=np.uint8)
    padded = _roundup(max(raw.size, 1), _BLOCK)
    if padded != raw.size:
        raw = np.concatenate(
            [raw, np.zeros(padded - raw.size, dtype=np.uint8)])
    nb = padded // _BLOCK
    shifts = np.arange(8, dtype=np.uint8)
    bits = (raw.reshape(nb, 1, _BLOCK) >> shifts[None, :, None]) & 1
    b4 = bits.reshape(nb, 8, 8, 8)                           # [nb,p,g,t]
    packed = (b4.astype(np.uint16)
              << shifts[None, None, None, :].astype(np.uint16)
              ).sum(axis=-1).astype(np.uint8)                # [nb,p,g]
    all0 = np.all(packed == 0, axis=-1)
    all1 = np.all(packed == 0xFF, axis=-1)
    stored = ~(all0 | all1)
    pw = shifts.astype(np.uint32)
    flags = (stored.astype(np.uint32) << pw).sum(
        axis=-1).astype(np.uint8)
    consts = (all1.astype(np.uint32) << pw).sum(
        axis=-1).astype(np.uint8)
    header = np.stack([flags, consts], axis=1).reshape(2 * nb)
    payload = packed[stored].reshape(-1)                     # (nb,p) order
    return header.tobytes() + payload.tobytes(), padded


def bitplane_decompress(buf, padded_len: int) -> bytes:
    """Inverse of the device bit-plane stage (vectorized numpy).

    buf: the compressed container (comp_len bytes). padded_len: the
    64-aligned raw length the compressor saw; the caller trims to the
    original object length.
    """
    nb = padded_len // _BLOCK
    raw = np.frombuffer(bytes(buf), dtype=np.uint8)
    flags = raw[0:2 * nb:2]
    consts = raw[1:2 * nb:2]
    payload = raw[2 * nb:]
    shifts = np.arange(8, dtype=np.uint8)
    stored = ((flags[:, None] >> shifts) & 1).astype(bool)       # [nb, 8]
    planes = np.zeros((nb, 8, 8), dtype=np.uint8)                # [nb, p, g]
    cnt = int(stored.sum())
    planes[stored] = payload[:cnt * 8].reshape(cnt, 8)
    const_fill = np.where(((consts[:, None] >> shifts) & 1).astype(bool),
                          0xFF, 0).astype(np.uint8)              # [nb, 8]
    planes[~stored] = np.broadcast_to(
        const_fill[:, :, None], (nb, 8, 8))[~stored]
    bits = ((planes[:, :, :, None] >> shifts) & 1)               # [nb,p,g,t]
    byts = (bits.astype(np.uint16)
            << shifts[None, :, None, None].astype(np.uint16)).sum(axis=1)
    return byts.astype(np.uint8).reshape(-1).tobytes()           # [nb*64]


def _roundup(x: int, a: int) -> int:
    return x + (a - x % a) % a if x % a else x


def plan_capacity(n_bytes: int, stripe_width: int) -> int:
    """Static stored-buffer capacity: fits the worst-case 66/64 container
    AND the raw payload, stripe aligned."""
    nb = _roundup(n_bytes, _BLOCK) // _BLOCK
    return _roundup(max(66 * nb, n_bytes), stripe_width)


# -- the transform on the device -------------------------------------------

def fused_supported(codec) -> bool:
    """Element-layout matrix codecs with a device fuse: RS reed_sol_van,
    reed_sol_r6_op and SHEC (not the packet-layout bitmatrix techniques,
    not LRC)."""
    from ..models.matrix_base import MatrixErasureCode
    return (isinstance(codec, MatrixErasureCode)
            and getattr(codec, "_bitmat", None) is not None
            and getattr(codec, "device", None) is not None)


class FusedResult:
    """Host-side view of one fused write transform."""

    __slots__ = ("parity", "stored", "shard_crcs", "chunk_crc32c",
                 "chunk_xxh32", "compressed", "comp_len", "probe_ok",
                 "entropy_bpb", "used_stripes", "stored_len", "raw_len",
                 "padded_len", "dev_stored", "dev_parity")

    def as_dict(self) -> dict:
        return {s: getattr(self, s, None) for s in self.__slots__
                if not s.startswith("dev_")}


def _staged(codec, batch, data_dev) -> torch.Tensor:
    """The [S, k, chunk] uint8 batch on the codec's device."""
    device = codec.device
    if data_dev is not None:
        if data_dev.device != device:
            raise ValueError("staged data on %s, codec on %s"
                             % (data_dev.device, device))
        data = data_dev
    elif isinstance(batch, torch.Tensor):
        data = batch.to(device)
    else:
        data = host_tensor(np.ascontiguousarray(batch)).to(device)
    if data.dtype != torch.uint8 or data.dim() != 3:
        raise ValueError("batch must be [S, k, chunk] uint8, got %s %s"
                         % (data.dtype, tuple(data.shape)))
    return data.contiguous()


def _shard_crcs(consts, data, parity, pad=None) -> torch.Tensor:
    """crc32 of the k + m shard streams (stripe after stripe), read in
    place from [S, k, chunk] and [S, m, chunk]."""
    k, m = data.shape[1], parity.shape[1]
    out = torch.empty(k + m, dtype=torch.uint32, device=data.device)
    write_kernels.crc32_rows(data.permute(1, 0, 2), consts, pad, out[:k])
    write_kernels.crc32_rows(parity.permute(1, 0, 2), consts, pad, out[k:])
    return out


def run_fused(codec, batch, mode: str = "store",
              required_ratio: float = 0.875,
              entropy_max_bits: float = 7.0, data_dev=None) -> dict:
    """Run the fused transform over one staged batch on the codec's device.

    batch: [S, k, chunk] uint8 (numpy array or tensor). data_dev, when
    given, is the already-staged device copy (the dispatcher's h2d leg).
    Returns the on-device output dict; nothing is read back between the
    launches. Callers d2h it at once (finish_fused, or the dispatcher)."""
    if mode not in ("store", "compress"):
        raise ValueError("mode %r must be 'store' or 'compress'" % mode)
    data = _staged(codec, batch, data_dev)
    S, k, chunk = data.shape
    if k != codec.get_data_chunk_count():
        raise ValueError("batch has %d data chunks, codec k=%d"
                         % (k, codec.get_data_chunk_count()))
    device = data.device
    consts = dev_consts(device)
    bitmat = codec._device_bitmat(device)
    sw = k * chunk
    N = S * sw
    # (a) per-chunk digests of the RAW chunks
    chunk_crc32c = write_kernels.crc32_rows(
        data.view(S * k, 1, chunk), consts[POLY_C]).view(S, k)
    chunk_xxh32 = write_kernels.xxh32_rows(data.view(S * k, chunk)).view(S, k)
    if mode == "store":
        parity = xor_mm.matrix_encode(bitmat, data, codec.w)
        return {"parity": parity,
                "shard_crcs": _shard_crcs(consts[POLY_ZLIB], data, parity),
                "chunk_crc32c": chunk_crc32c, "chunk_xxh32": chunk_xxh32}
    # (b) probe + bit-plane container + decision, on the device
    cap2 = plan_capacity(N, sw)
    stored_flat, dec = write_kernels.bitplane_stage(
        data.view(N), cap2, sw, chunk, int(required_ratio * 1000),
        int(entropy_max_bits * 1000))
    stored = stored_flat.view(cap2 // sw, k, chunk)
    # (c) EC encode of the stored stream (a zero tail encodes to zero)
    parity = xor_mm.matrix_encode(bitmat, stored, codec.w)
    # (d) per-shard crc32 of the stored prefix: the capacity's crc, then
    # the zero tail un-shifted by the pad the decision left on the device
    out = {"parity": parity, "stored": stored,
           "shard_crcs": _shard_crcs(consts[POLY_ZLIB], stored, parity,
                                     dec[5:6]),
           "chunk_crc32c": chunk_crc32c, "chunk_xxh32": chunk_xxh32}
    for i, name in enumerate(write_kernels.DEC_FIELDS[:5]):
        out[name] = dec[i]
    return out


def to_host(out: dict) -> dict:
    """{name: numpy array} of a fused output dict: on CUDA every tensor is
    copied into pinned host memory on the current stream, then one
    synchronise."""
    device = next(iter(out.values())).device
    if device.type != "cuda":
        return to_numpy(out)
    host = pinned_copy(out)
    torch.cuda.current_stream(device).synchronize()
    return to_numpy(host)


def finish_fused(out: dict, S: int, k: int, chunk: int, mode: str):
    """One d2h of the fused outputs -> FusedResult (host numpy views)."""
    return result_from_host(to_host(out), S, k, chunk, mode, dev_out=out)


def result_from_host(host: dict, S: int, k: int, chunk: int, mode: str,
                     dev_out=None):
    """Build a FusedResult from an already-transferred host dict (the
    dispatcher's d2h stage drains the whole output at once and hands the
    host dict here). dev_out keeps the device-side outputs reachable."""
    r = FusedResult()
    r.raw_len = S * k * chunk
    r.padded_len = _roundup(r.raw_len, _BLOCK)
    r.chunk_crc32c = host["chunk_crc32c"]
    r.chunk_xxh32 = host["chunk_xxh32"]
    r.shard_crcs = [int(x) for x in host["shard_crcs"]]
    r.dev_parity = dev_out["parity"] if dev_out is not None else None
    if mode == "store":
        r.parity = host["parity"]
        r.stored = None
        r.dev_stored = None
        r.compressed = False
        r.comp_len = r.raw_len
        r.probe_ok = False
        r.entropy_bpb = None
        r.stored_len = r.raw_len
        r.used_stripes = S
        return r
    r.compressed = bool(host["do_compress"])
    r.comp_len = int(host["comp_len"])
    r.probe_ok = bool(host["probe_ok"])
    r.entropy_bpb = float(host["entropy_milli"]) / 8000.0
    r.used_stripes = int(host["used_stripes"])
    r.stored_len = r.comp_len if r.compressed else r.raw_len
    used = r.used_stripes
    r.parity = host["parity"][:used]
    r.stored = host["stored"][:used]
    r.dev_stored = dev_out["stored"] if dev_out is not None else None
    return r


def device_crc32(data, device=None) -> int:
    """zlib crc32 of ONE byte stream, computed on the device by K1. Deep
    scrub's audit hash for resident objects: the primary still reads the
    on-disk shard bytes, but the hash runs on the device (CUDA unless the
    caller passes ``device="cpu"``, where the plain version runs)."""
    from ..device import resolve_device
    dev = resolve_device(device)
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    stream = host_tensor(buf).to(dev)
    crc = write_kernels.crc32_rows(stream.view(1, 1, buf.size),
                                   dev_consts(dev)[POLY_ZLIB])
    return int(to_host({"crc": crc})["crc"][0])
