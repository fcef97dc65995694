"""Wrappers of the fused write transform's kernels (``csrc/write_transform.cu``).

Port of the XLA steps of ``ceph_tpu/osd/fused_transform.py:_build_program``
around the encode, each with its plain PyTorch version beside it:

  :func:`crc32_rows`      (K1) the reflected CRC-32 (init and xor-out
                          0xFFFFFFFF) of every row of a strided byte view,
                          for the polynomial whose constants it is given,
                          optionally un-shifted by a pad length on the
                          device (``_crc_raw_tree``, ``_crc32_full``,
                          ``_crc_unshift``, ``device_crc32``).
  :func:`xxh32_rows`      (K2) xxh32, seed 0, of every row (``_xxh32_dev``).
  :func:`bitplane_stage`  (K3) the histogram, entropy probe, bit-plane
                          container, ratio test, decision and stored stream
                          of the compress mode (:515-535, ``_bitplane_dev``).

A wrapper runs its plain version only for a CPU tensor; for a CUDA tensor
it launches the kernel on the current stream or raises. ``LAUNCHES``
counts wrapper calls that launched, per wrapper; :func:`launches_by_kernel`
reads the counts the C entry points keep per CUDA kernel (each wrapper is
one launch a call), :func:`bitplane_recomputed_tiles` the tiles K3 loaded
twice (past the resident grid), and :func:`reset_launches` sets all of
them to 0. K1 and K3 use a scratch buffer kept per (device, stream) that
each kernel leaves all zeros, so no call clears it first.

CRC constants (``consts``): uint32 ``[CONSTS_WORDS]`` on the view's device,
the polynomial's byte table ``[256]``, then the 31 "append 2^l zero bytes"
matrices and their 31 inverses, each 32 column masks, then the slicing
tables T_1..T_15 ``[15, 256]`` of K1's 16-byte steps (built by
:func:`ceph_tpu_torch.osd.fused_transform.dev_consts`). The plain versions
compute in int64 masked to 32 bits: torch on the CPU has no shifts on
uint32.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

__all__ = ["crc32_rows", "crc32_rows_plain", "xxh32_rows",
           "xxh32_rows_plain", "bitplane_stage", "bitplane_stage_plain",
           "launches_by_kernel", "bitplane_recomputed_tiles",
           "reset_launches", "CONSTS_WORDS",
           "KERNELS", "LAUNCHES", "BLOCK"]

_SOURCE = "write_transform"
LEVELS = 31                  # shift matrices for appends of 2^0..2^30 bytes
CONSTS_WORDS = 256 + 2 * LEVELS * 32 + 15 * 256
MAX_LEN = 1 << 30            # longest row K1 takes
BLOCK = 64                   # bytes of a bit-plane block
DEC_FIELDS = ("comp_len", "do_compress", "probe_ok", "entropy_milli",
              "used_stripes", "pad_bytes")

# CUDA kernels by the C entry points' kind number
KERNELS = ("crc_rows", "xxh32", "bitplane")

LAUNCHES = {"crc32_rows": 0, "xxh32_rows": 0, "bitplane_stage": 0}
_count_lock = threading.Lock()
_lib = None
# K1's, K3's and the chunk digest's (``digest_kernel``) scratch per
# (device, stream): all zeros between calls (each kernel leaves it so),
# reused by every call on the stream, which the stream orders; grown,
# zeroed, when a call needs more
_scratch: dict = {}
_scratch_lock = threading.Lock()

_M32 = 0xFFFFFFFF
_XXP1, _XXP2, _XXP3 = 2654435761, 2246822519, 3266489917
_XXP4, _XXP5 = 668265263, 374761393


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.wt_crc32_rows.argtypes = [p, ll, ll, ll, ll, ll, p, p, p, p, p]
        lib.wt_crc32_rows.restype = i
        lib.wt_crc_scratch_words.argtypes = [ll, ll]
        lib.wt_crc_scratch_words.restype = ll
        lib.wt_xxh32_rows.argtypes = [p, ll, ll, p, p]
        lib.wt_xxh32_rows.restype = i
        lib.wt_bitplane_scratch_words.argtypes = [ll]
        lib.wt_bitplane_scratch_words.restype = ll
        lib.wt_bitplane.argtypes = [p, ll, ll, ll, ll, i, i, p, p, p, p]
        lib.wt_bitplane.restype = i
        lib.wt_bitplane_recomputed_tiles.argtypes = []
        lib.wt_bitplane_recomputed_tiles.restype = ll
        lib.wt_launches.argtypes = [i]
        lib.wt_launches.restype = ll
        lib.wt_reset_launches.argtypes = []
        lib.wt_reset_launches.restype = None
        _lib = lib
    return _lib


def launches_by_kernel() -> dict[str, int]:
    """{CUDA kernel: launches since the last reset}, as the C entry points
    count them where they launch each kernel."""
    if _lib is None:            # nothing was built, so nothing launched
        return dict.fromkeys(KERNELS, 0)
    return {k: int(_lib.wt_launches(i)) for i, k in enumerate(KERNELS)}


def bitplane_recomputed_tiles() -> int:
    """Tiles of 256 64-byte blocks that K3 loaded and transposed a second
    time since the last reset: those past the grid the card holds at once
    (an input over about 8 MiB on an H100)."""
    return 0 if _lib is None else int(_lib.wt_bitplane_recomputed_tiles())


def reset_launches() -> None:
    """Sets ``LAUNCHES`` and the per-kernel counts to 0."""
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        if _lib is not None:
            _lib.wt_reset_launches()


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_rc(fn: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError("%s failed with code %d%s"
                           % (fn, rc, _build.launch_failure(_lib)))


def _require_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError("no kernel for device %s" % t.device)


# -- K1: CRC of strided rows ------------------------------------------------

def _to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> uint32, through int32 (conversions to
    and from uint32 are not implemented everywhere)."""
    return (x - ((x >> 31) << 32)).to(torch.int32).view(torch.uint32)


def _from_u32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32).to(torch.int64) & _M32


def _split_consts(consts: torch.Tensor):
    c = _from_u32(consts)
    table = c[:256]
    shift = c[256:256 + LEVELS * 32].view(LEVELS, 32)
    inv = c[256 + LEVELS * 32:256 + 2 * LEVELS * 32].view(LEVELS, 32)
    return table, shift, inv


def _mat_apply_plain(cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M.x for 32 column masks `cols` (int64) on int64 registers x."""
    r = torch.zeros_like(x)
    for j in range(32):
        r ^= cols[j] * ((x >> j) & 1)
    return r


def crc32_rows_plain(view: torch.Tensor, consts: torch.Tensor,
                     pad: torch.Tensor | None = None) -> torch.Tensor:
    """K1's function in plain PyTorch: the reference's table-and-tree
    form. Per-byte table CRCs are combined pairwise, level l applying the
    "append 2^l bytes" matrix to the left half; an odd level gets a zero
    node in front (leading zeros leave a register of 0 at 0)."""
    rows, nseg, seglen = view.shape
    length = nseg * seglen
    table, shift, inv = _split_consts(consts)
    v = table[view.reshape(rows, length).long()]
    lvl = 0
    while v.shape[-1] > 1:
        if v.shape[-1] % 2:
            v = torch.cat([torch.zeros_like(v[:, :1]), v], dim=-1)
        v = _mat_apply_plain(shift[lvl], v[:, 0::2]) ^ v[:, 1::2]
        lvl += 1
    reg = v[:, 0] if length else torch.zeros(rows, dtype=torch.int64,
                                             device=view.device)
    init = torch.full((), _M32, dtype=torch.int64, device=view.device)
    n, lvl = length, 0
    while n:                    # the init register carried over the row
        if n & 1:
            init = _mat_apply_plain(shift[lvl], init)
        n >>= 1
        lvl += 1
    reg = reg ^ init
    if pad is not None:         # undo the zero tail: inverse shifts
        p = pad.reshape(()).to(torch.int64)
        for lvl in range(LEVELS):
            bit = ((p >> lvl) & 1).bool()
            reg = torch.where(bit, _mat_apply_plain(inv[lvl], reg), reg)
    return _to_u32(reg ^ _M32)


def _check_crc(view, consts, pad, out) -> None:
    _require_device(view)
    if view.dtype != torch.uint8 or view.dim() != 3:
        raise ValueError("view must be a [rows, nseg, seglen] uint8 tensor, "
                         "got %s %s" % (view.dtype, tuple(view.shape)))
    if view.shape[2] > 1 and view.stride(2) != 1:
        raise ValueError("the bytes of a segment must be contiguous")
    if view.shape[1] * view.shape[2] >= MAX_LEN:
        raise ValueError("rows of %d bytes exceed %d"
                         % (view.shape[1] * view.shape[2], MAX_LEN))
    if consts.dtype != torch.uint32 or consts.shape != (CONSTS_WORDS,) or \
            not consts.is_contiguous():
        raise ValueError("consts must be a contiguous uint32 [%d] tensor"
                         % CONSTS_WORDS)
    if view.device.type == "cuda" and consts.data_ptr() % 16:
        raise ValueError("consts must start on 16 bytes: the kernel loads "
                         "them 16 bytes at a time")
    tensors = [consts]
    if pad is not None:
        if pad.dtype != torch.int64 or pad.numel() != 1:
            raise ValueError("pad must be one int64")
        tensors.append(pad)
    if out is not None:
        if out.dtype != torch.uint32 or out.shape != (view.shape[0],) or \
                not out.is_contiguous():
            raise ValueError("out must be a contiguous uint32 [%d] tensor"
                             % view.shape[0])
        tensors.append(out)
    for t in tensors:
        if t.device != view.device:
            raise ValueError("view on %s, an operand on %s"
                             % (view.device, t.device))


def _scratch_for(device: torch.device, stream: int,
                 words: int) -> torch.Tensor:
    """The zeroed scratch of at least `words` uint32 (as int32) for K1's,
    K3's and the chunk digest's calls on `stream`."""
    key = (device.index, stream)
    with _scratch_lock:
        buf = _scratch.get(key)
        if buf is None or buf.numel() < words:
            size = max(words, 1, 0 if buf is None else 2 * buf.numel())
            buf = _scratch[key] = torch.zeros(size, dtype=torch.int32,
                                              device=device)
        return buf


def crc32_rows(view: torch.Tensor, consts: torch.Tensor,
               pad: torch.Tensor | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """CRC-32 of each row of view [rows, nseg, seglen] uint8 (a row is its
    nseg segments in order; any row and segment strides, contiguous
    bytes within a segment) -> uint32 [rows], written into `out` if given.
    With `pad` (one int64 on the device), each result is un-shifted by
    pad zero bytes: the CRC of the row's first len - pad bytes when the
    rest are zeros."""
    _check_crc(view, consts, pad, out)
    if view.device.type == "cpu":
        res = crc32_rows_plain(view, consts, pad)
        return res if out is None else out.copy_(res)
    rows, nseg, seglen = view.shape
    if out is None:
        out = torch.empty(rows, dtype=torch.uint32, device=view.device)
    if rows == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(view.device):
        stream = _stream(view.device)
        scratch = _scratch_for(view.device, stream, lib.wt_crc_scratch_words(
            rows, nseg * seglen))
        rc = lib.wt_crc32_rows(
            view.data_ptr(), rows, view.stride(0), nseg, view.stride(1),
            seglen, consts.data_ptr(),
            None if pad is None else pad.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), stream)
    _raise_rc("wt_crc32_rows", rc)
    _count("crc32_rows")
    return out


# -- K2: xxh32 of rows -------------------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a < 2^32 in int64, the constant split in 16-bit
    halves so that no product leaves int64."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _words(x: torch.Tensor) -> torch.Tensor:
    """[..., 4] int64 bytes -> [...] little-endian words."""
    return x[..., 0] | (x[..., 1] << 8) | (x[..., 2] << 16) | (x[..., 3] << 24)


def xxh32_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """K2's function in plain PyTorch: the spec's xxh32, seed 0, with a
    Python loop over the 16-byte stripes of all rows at once."""
    n_rows, length = rows.shape
    x = rows.to(torch.int64)
    nblk = length // 16
    if nblk:
        words = _words(x[:, :nblk * 16].reshape(n_rows, nblk, 4, 4))
        acc = torch.tensor([(_XXP1 + _XXP2) & _M32, _XXP2, 0,
                            (-_XXP1) & _M32], dtype=torch.int64,
                           device=rows.device).expand(n_rows, 4)
        for i in range(nblk):
            acc = _mul32(_rotl((acc + _mul32(words[:, i], _XXP2)) & _M32, 13),
                         _XXP1)
        h = (_rotl(acc[:, 0], 1) + _rotl(acc[:, 1], 7) + _rotl(acc[:, 2], 12)
             + _rotl(acc[:, 3], 18)) & _M32
    else:
        h = torch.full((n_rows,), _XXP5, dtype=torch.int64,
                       device=rows.device)
    h = (h + length) & _M32
    i = nblk * 16
    while i + 4 <= length:
        h = _mul32(_rotl((h + _mul32(_words(x[:, i:i + 4]), _XXP3)) & _M32,
                         17), _XXP4)
        i += 4
    while i < length:
        h = _mul32(_rotl((h + _mul32(x[:, i], _XXP5)) & _M32, 11), _XXP1)
        i += 1
    h ^= h >> 15
    h = _mul32(h, _XXP2)
    h ^= h >> 13
    h = _mul32(h, _XXP3)
    h ^= h >> 16
    return _to_u32(h)


def xxh32_rows(rows: torch.Tensor) -> torch.Tensor:
    """xxh32 (seed 0) of each row of rows [R, L] uint8 (contiguous) ->
    uint32 [R]."""
    _require_device(rows)
    if rows.dtype != torch.uint8 or rows.dim() != 2 or \
            not rows.is_contiguous():
        raise ValueError("rows must be a contiguous [R, L] uint8 tensor, "
                         "got %s %s" % (rows.dtype, tuple(rows.shape)))
    if rows.device.type == "cpu":
        return xxh32_rows_plain(rows)
    n_rows, length = rows.shape
    out = torch.empty(n_rows, dtype=torch.uint32, device=rows.device)
    if n_rows == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(rows.device):
        rc = lib.wt_xxh32_rows(rows.data_ptr(), n_rows, length,
                               out.data_ptr(), _stream(rows.device))
    _raise_rc("wt_xxh32_rows", rc)
    _count("xxh32_rows")
    return out


# -- K3: bit-plane compress, probe and decision -----------------------------

def _roundup(x: int, a: int) -> int:
    return -(-x // a) * a


def bitplane_stage_plain(flat: torch.Tensor, cap2: int, sw: int, chunk: int,
                         required_milli: int, entropy_max_milli: int):
    """K3's function in plain PyTorch, the reference's steps in order:
    histogram -> entropy_milli -> probe; 64-byte blocks -> 8 bit-planes of
    8 bytes, header of (flags, consts), stored planes in (block, plane)
    order; comp_len, the ratio test in int64, the decision, the stored
    stream [cap2] and dec int64 [6] (``DEC_FIELDS``)."""
    n = flat.numel()
    dev = flat.device
    counts = torch.bincount(flat.long(), minlength=256)
    p = counts.to(torch.float32) / torch.tensor(float(n), dtype=torch.float32,
                                                device=dev)
    terms = torch.where(counts > 0, p * torch.log2(torch.clamp(p, min=1e-12)),
                        torch.zeros((), dtype=torch.float32, device=dev))
    ent = -terms.sum()
    milli = (ent * 1000).to(torch.int32).to(torch.int64)
    probe_ok = milli <= entropy_max_milli
    nb = _roundup(n, BLOCK) // BLOCK
    flat_p = torch.cat([flat, torch.zeros(nb * BLOCK - n, dtype=torch.uint8,
                                          device=dev)])
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    bits = (flat_p.view(nb, 1, BLOCK) >> shifts[None, :, None]) & 1
    b4 = bits.reshape(nb, 8, 8, 8).to(torch.int64)        # [nb, p, g, t]
    packed = (b4 << shifts.to(torch.int64)).sum(-1).to(torch.uint8)
    all0 = (packed == 0).all(-1)                          # [nb, p]
    all1 = (packed == 0xFF).all(-1)
    stored = ~(all0 | all1)
    pw = 1 << shifts.to(torch.int64)
    flags = (stored.to(torch.int64) * pw).sum(-1).to(torch.uint8)
    consts = (all1.to(torch.int64) * pw).sum(-1).to(torch.uint8)
    header = torch.stack([flags, consts], dim=1).reshape(2 * nb)
    payload = packed[stored].reshape(-1)                  # (block, plane)
    comp_len = 2 * nb + 8 * stored.sum().to(torch.int64)
    ratio_ok = comp_len * 1000 <= n * required_milli
    do_compress = probe_ok & ratio_ok
    comp_full = torch.zeros(cap2, dtype=torch.uint8, device=dev)
    comp_full[:2 * nb] = header
    comp_full[2 * nb:2 * nb + payload.numel()] = payload
    raw_full = torch.zeros(cap2, dtype=torch.uint8, device=dev)
    raw_full[:n] = flat
    stored_flat = torch.where(do_compress, comp_full, raw_full)
    stored_len = torch.where(do_compress, comp_len, n)
    used = (stored_len + sw - 1) // sw
    pad = (cap2 // sw - used) * chunk
    dec = torch.stack([comp_len, do_compress.to(torch.int64),
                       probe_ok.to(torch.int64), milli, used, pad])
    return stored_flat, dec


def bitplane_stage(flat: torch.Tensor, cap2: int, sw: int, chunk: int,
                   required_milli: int, entropy_max_milli: int):
    """flat [N] uint8 (contiguous) -> (stored [cap2] uint8, dec int64 [6]):
    the compress mode's probe, container and decision; dec holds
    ``DEC_FIELDS``. cap2 must be a multiple of the stripe width sw and
    hold N and the worst-case container (66 bytes per 64-byte block)."""
    _require_device(flat)
    if flat.dtype != torch.uint8 or flat.dim() != 1 or \
            not flat.is_contiguous():
        raise ValueError("flat must be a contiguous [N] uint8 tensor")
    n = flat.numel()
    nb = _roundup(n, BLOCK) // BLOCK
    if n < 1 or sw < 1 or chunk < 1 or cap2 % sw or cap2 < max(n, 66 * nb):
        raise ValueError("cap2=%d must be a multiple of sw=%d holding N=%d "
                         "and %d container bytes" % (cap2, sw, n, 66 * nb))
    if flat.device.type == "cpu":
        return bitplane_stage_plain(flat, cap2, sw, chunk, required_milli,
                                    entropy_max_milli)
    lib = _kernel()
    dev = flat.device
    dec = torch.empty(len(DEC_FIELDS), dtype=torch.int64, device=dev)
    stored = torch.empty(cap2, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        scratch = _scratch_for(dev, stream, lib.wt_bitplane_scratch_words(n))
        rc = lib.wt_bitplane(flat.data_ptr(), n, cap2, sw, chunk,
                             required_milli, entropy_max_milli,
                             scratch.data_ptr(), dec.data_ptr(),
                             stored.data_ptr(), stream)
    _raise_rc("wt_bitplane", rc)
    _count("bitplane_stage")
    return stored, dec
