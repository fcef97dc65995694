"""Stripe math + the batched encode/decode seam + integrity hashes.

Port of ``ceph_tpu/osd/ec_util.py``, the role of the reference's ECUtil
(src/osd/ECUtil.{h,cc}):

  StripeInfo     offset arithmetic between the logical object address
                 space and per-shard chunk address spaces (ECUtil.h:31-84)
  encode/decode  the whole multi-stripe payload reshaped to [S, k, chunk]
                 and coded in ONE batched device call (the reference loops
                 one stripe_width per codec call, ECUtil.cc:100-139)
  encode_fused   the whole-object write through the fused write transform
                 (osd/fused_transform.py): digests, compression decision
                 and encode on the device
  repair_fraction / repair_combine
                 a regenerating code's repair (models/msr.py): a helper's
                 chunk stream to the fraction it ships, and the d
                 fractions to the rebuilt shard, each one batched device
                 call over the stripes
  HashInfo       cumulative per-shard crc xattr (ECUtil.h:105-163)

All byte movement stays in numpy; the codec's batched calls own the
device. ``resident=(tier, key)`` on encode and encode_fused keeps the
object in the device chunk tier (osd/hbm_tier.py).

  recover_cross_chip / repair_cross_chip
                 one missing shard rebuilt, or an MSR combine run, with
                 the survivors (fractions) spread over several devices:
                 through the rateless dispatcher's queue where one is up
                 (parallel/rateless.py), else sharded over a device mesh
                 (parallel/mesh.py), each checksummed against the host
                 sum first. On one card they run only through a mesh or
                 a dispatcher the caller set.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..errors import ErasureCodeError
from ..parallel import rateless
from ..parallel.mesh import MeshChecksumError, recover_sharded, repair_sharded
from ..parallel.placement import local_device_count

__all__ = ["StripeInfo", "encode", "encode_fused", "decode",
           "decode_concat", "recover_cross_chip", "repair_fraction",
           "repair_combine", "repair_cross_chip", "HashInfo"]

CHUNK_ALIGNMENT = 64


class StripeInfo:
    """stripe_info_t: (stripe_count=k, stripe_width=k*chunk)."""

    def __init__(self, stripe_count: int, stripe_width: int):
        if stripe_width % stripe_count != 0:
            raise ValueError("stripe_width %d %% stripe_count %d != 0"
                             % (stripe_width, stripe_count))
        self.stripe_width = stripe_width
        self.chunk_size = stripe_width // stripe_count

    def logical_offset_is_stripe_aligned(self, logical: int) -> bool:
        return logical % self.stripe_width == 0

    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return ((offset + self.stripe_width - 1) // self.stripe_width) \
            * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        rem = offset % self.stripe_width
        return offset - rem + self.stripe_width if rem else offset

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        assert offset % self.stripe_width == 0
        return (offset // self.stripe_width) * self.chunk_size

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        assert offset % self.chunk_size == 0
        return (offset // self.chunk_size) * self.stripe_width

    def aligned_offset_len_to_chunk(self, off_len: tuple) -> tuple:
        off, length = off_len
        return (self.aligned_logical_offset_to_chunk_offset(off),
                self.aligned_logical_offset_to_chunk_offset(length))

    def offset_len_to_stripe_bounds(self, off_len: tuple) -> tuple:
        off, length = off_len
        start = self.logical_to_prev_stripe_offset(off)
        return (start,
                self.logical_to_next_stripe_offset((off - start) + length))


def _as_bytes(data) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else \
        np.asarray(data, dtype=np.uint8).reshape(-1)


def _stripes(sinfo: StripeInfo, codec, data):
    """The payload as [S, k, chunk], or None when it is empty."""
    arr = _as_bytes(data)
    if arr.size % sinfo.stripe_width != 0:
        raise ErasureCodeError(
            22, "payload %d not stripe aligned (width %d)"
            % (arr.size, sinfo.stripe_width))
    if arr.size == 0:
        return None
    return arr.reshape(arr.size // sinfo.stripe_width,
                       codec.get_data_chunk_count(), sinfo.chunk_size)


def _shard_map(codec, rows, parity, want) -> dict:
    k = codec.get_data_chunk_count()
    out = {}
    for i in range(codec.get_chunk_count()):
        idx = codec.chunk_index(i)
        if want is not None and idx not in want:
            continue
        src = rows[:, i, :] if i < k else parity[:, i - k, :]
        out[idx] = np.ascontiguousarray(np.asarray(src)).reshape(-1)
    return out


def _adopt(resident, rows, parity, codec, digests=None) -> None:
    """The tier adopts host arrays (its upload is the object's one
    crossing); a failure never fails the write: the tier is a cache."""
    tier, key = resident
    try:
        tier.adopt_encode(key, rows, parity, codec, digests=digests)
    except Exception:
        pass


def encode(sinfo: StripeInfo, codec, data, want=None,
           dispatcher=None, trace=None, resident=None) -> dict:
    """Encode a stripe-aligned payload -> {shard: chunk bytes}.

    data: bytes/uint8 array whose length is a multiple of stripe_width.
    ONE batched device call for all stripes. Returns every shard unless
    `want` restricts it. With a dispatcher (osd/gpu_dispatch.py),
    concurrent callers sharing this codec coalesce into one launch.

    resident=(tier, key) keeps the encode in the device chunk tier:
    through the dispatcher the pipeline adopts the staged device arrays
    (no chunk byte crosses again); without one the tier adopts the host
    arrays itself (that upload is then the object's one crossing)."""
    batch = _stripes(sinfo, codec, data)
    if batch is None:
        return {}
    if dispatcher is not None:
        parity = np.asarray(dispatcher.encode(codec, batch, trace=trace,
                                              resident=resident))
    else:
        parity = np.asarray(codec.encode_batch(batch))
        if resident is not None:
            _adopt(resident, batch, parity, codec)
    return _shard_map(codec, batch, parity, want)


def encode_fused(sinfo: StripeInfo, codec, data, want=None,
                 dispatcher=None, trace=None, resident=None,
                 mode: str = "store", required_ratio: float = 0.875,
                 entropy_max_bits: float = 7.0) -> tuple:
    """Whole-object write through the fused device transform: per-chunk
    digests, the compressibility probe + compress-vs-store decision, and
    the EC encode on the device — one h2d of the raw payload, the
    transform's launches, one d2h of parity + digests (+ the compressed
    payload when the device chose to compress).

    Returns (shard_map, FusedResult). shard_map is {shard: chunk stream}
    of what must land on disk: the compressed container's stripes when
    mode="compress" and the device chose to compress, the raw stripes
    otherwise. The FusedResult carries the device-computed per-shard crcs
    (HashInfo.set_device_hashes), the per-chunk crc32c/xxh32 digests, and
    the compression verdict the caller records in the hinfo xattr.

    resident=(tier, key) adopts the STORED rows, the parity and the shard
    crcs into the device chunk tier (scrub-from-digest), as encode()'s
    resident does."""
    from . import fused_transform
    batch = _stripes(sinfo, codec, data)
    if batch is None:
        return {}, None
    stripes, k, chunk = batch.shape
    if dispatcher is not None:
        r = dispatcher.fused_write(
            codec, batch, mode=mode, required_ratio=required_ratio,
            entropy_max_bits=entropy_max_bits, trace=trace,
            resident=resident)
    else:
        out = fused_transform.run_fused(
            codec, batch, mode=mode, required_ratio=required_ratio,
            entropy_max_bits=entropy_max_bits)
        r = fused_transform.finish_fused(out, stripes, k, chunk, mode)
        if resident is not None:
            _adopt(resident, r.stored if r.stored is not None else batch,
                   r.parity, codec,
                   np.asarray(r.shard_crcs, dtype=np.uint32))
    rows = r.stored if r.stored is not None else batch
    return _shard_map(codec, rows, r.parity, want), r


def decode(sinfo: StripeInfo, codec, to_decode: dict,
           want=None, dispatcher=None, trace=None) -> dict:
    """Reconstruct shards from per-shard chunk streams.

    to_decode: {shard: bytes of >= 1 chunks, equal lengths}. Returns
    {shard: bytes} for `want` (default: all shards). Batched across
    stripes in one device call (reference decode loops per stripe,
    ECUtil.cc:8-99). With a dispatcher, concurrent reads sharing an
    erasure signature coalesce into one launch (matrix codecs only — the
    locality codecs' want_rows plumbing stays direct)."""
    if not to_decode:
        raise ErasureCodeError(22, "decode with no chunks")
    to_decode = {shard: _as_bytes(v) for shard, v in to_decode.items()}
    lengths = {v.size for v in to_decode.values()}
    if len(lengths) != 1:
        raise ErasureCodeError(22, "chunks have unequal lengths %s" % lengths)
    total = lengths.pop()
    if total % sinfo.chunk_size != 0:
        raise ErasureCodeError(
            22, "chunk stream %d not chunk aligned (%d)"
            % (total, sinfo.chunk_size))
    k = codec.get_data_chunk_count()
    n = codec.get_chunk_count()
    want = set(range(n)) if want is None else set(want)
    stripes = total // sinfo.chunk_size

    inv = {codec.chunk_index(i): i for i in range(n)}
    logical = {inv[shard]: buf.reshape(stripes, sinfo.chunk_size)
               for shard, buf in to_decode.items()}

    have = set(to_decode)
    if want <= have:
        return {s: np.ascontiguousarray(
            logical[inv[s]]).reshape(-1) for s in want}

    # Single-erasure region-XOR shortcut (isa/xor_op analog), batched over
    # every stripe in the extent.
    missing_want = want - have
    if len(missing_want) == 1 and hasattr(codec, "xor_plan"):
        plan = codec.xor_plan(next(iter(missing_want)), have)
        if plan is not None:
            from ..models.table_cache import xor_recover
            rec = xor_recover({s: logical[inv[s]] for s in plan})
            codec.xor_fast_hits += 1
            return {s: (to_decode[s] if s in to_decode
                        else np.ascontiguousarray(rec).reshape(-1))
                    for s in want}

    if getattr(codec, "DECODE_BATCH_ANY", False):
        # locality codecs (lrc/shec) accept any recoverable subset and
        # need to know which rows are wanted
        use = tuple(sorted(logical))
        stacked = np.stack([logical[i] for i in use], axis=1)
        full = np.asarray(codec.decode_batch(
            use, stacked,
            want_rows=tuple(sorted(inv[s] for s in want))))
    else:
        use = tuple(sorted(logical))[:k]
        if len(use) < k:
            raise ErasureCodeError(
                5, "not enough chunks to decode (%d < %d)"
                % (len(use), k))
        stacked = np.stack([logical[i] for i in use], axis=1)  # [S,k,chunk]
        if dispatcher is not None:
            full = np.asarray(dispatcher.decode(codec, use, stacked,
                                                trace=trace))
        else:
            full = np.asarray(codec.decode_batch(use, stacked))
    out = {}
    for i in range(n):
        idx = codec.chunk_index(i)
        if idx not in want:
            continue
        if idx in to_decode:
            out[idx] = to_decode[idx]
        else:
            out[idx] = np.ascontiguousarray(full[:, i, :]).reshape(-1)
    return out


def _no_devices(mesh) -> bool:
    """True where the cross-chip path does not apply for want of devices:
    no mesh given, no rateless dispatcher set, and under two cards."""
    return mesh is None and rateless.get_dispatcher(create=False) is None \
        and local_device_count() < 2


def _check_sum(stacked: np.ndarray, expected_sum, what: str) -> None:
    """The rateless path's trust boundary: the bytes about to ride the
    queue against the host sum taken when they were received."""
    if expected_sum is None:
        return
    got = int(stacked.astype(np.uint64).sum()) % (1 << 32)
    if got != expected_sum % (1 << 32):
        raise MeshChecksumError(
            "rateless %s checksum mismatch: sum %d != expected %d"
            % (what, got, expected_sum % (1 << 32)))


def recover_cross_chip(sinfo: StripeInfo, codec, to_decode: dict,
                       target_shard: int, mesh=None, expected_sum=None):
    """Reconstruct ONE missing shard with the survivor chunk streams
    spread over several devices instead of gathered on one (ref
    ``ceph_tpu/osd/ec_util.py:294``): with no mesh and the rateless
    dispatcher up, the survivor batch rides its queue in micro-batches;
    else it is sharded over `mesh` (default: every visible card) by
    ``parallel.mesh.recover_sharded``, whose checksum over the blocks is
    compared with the survivors' host sum (`expected_sum`, taken here
    when None) and raises MeshChecksumError on mismatch. The rateless
    path compares the host sum only when `expected_sum` is given, as
    the reference does.

    Returns the target shard's bytes, or None where the path does not
    apply: a locality codec or one without matrix entries, a sub-symbol
    codec (msr: its cross-chip leg is repair_cross_chip), no mesh with
    no dispatcher set and under two cards, or a stream that is empty or
    not chunk aligned. The caller then falls back to decode()."""
    if getattr(codec, "DECODE_BATCH_ANY", False) or \
            not hasattr(codec, "_decode_entry"):
        return None
    if getattr(codec, "alpha", 1) > 1 or _no_devices(mesh):
        return None
    to_decode = {shard: _as_bytes(v) for shard, v in to_decode.items()}
    lengths = {v.size for v in to_decode.values()}
    if len(lengths) != 1:
        raise ErasureCodeError(22,
                               "chunks have unequal lengths %s" % lengths)
    total = lengths.pop()
    if total == 0 or total % sinfo.chunk_size != 0:
        return None
    k = codec.get_data_chunk_count()
    n = codec.get_chunk_count()
    if target_shard in to_decode:
        return np.ascontiguousarray(to_decode[target_shard]).tobytes()
    stripes = total // sinfo.chunk_size
    inv = {codec.chunk_index(i): i for i in range(n)}
    logical = {inv[shard]: buf.reshape(stripes, sinfo.chunk_size)
               for shard, buf in to_decode.items()}
    use = tuple(sorted(logical))[:k]
    if len(use) < k:
        raise ErasureCodeError(
            5, "not enough chunks to decode (%d < %d)" % (len(use), k))
    stacked = np.stack([logical[i] for i in use], axis=1)  # [S,k,chunk]
    disp = rateless.get_dispatcher() if mesh is None else None
    if disp is not None:
        _check_sum(stacked, expected_sum, "recovery")
        full = disp.decode(codec, use, stacked)
        return np.ascontiguousarray(
            full[:, inv[target_shard], :]).reshape(-1).tobytes()
    row = recover_sharded(codec, use, stacked, inv[target_shard],
                          mesh=mesh, expected_sum=expected_sum)
    return np.ascontiguousarray(row).reshape(-1).tobytes()


def decode_concat(sinfo: StripeInfo, codec, to_decode: dict,
                  dispatcher=None, trace=None) -> bytes:
    """Reconstruct and concatenate the data shards back into the logical
    payload (the read-path finish, ECUtil.cc:46-99)."""
    k = codec.get_data_chunk_count()
    want = {codec.chunk_index(i) for i in range(k)}
    shards = decode(sinfo, codec, to_decode, want, dispatcher=dispatcher,
                    trace=trace)
    total = len(next(iter(shards.values())))
    stripes = total // sinfo.chunk_size
    stacked = np.stack(
        [np.asarray(shards[codec.chunk_index(i)]).reshape(
            stripes, sinfo.chunk_size) for i in range(k)], axis=1)
    return np.ascontiguousarray(stacked).reshape(-1).tobytes()


def repair_fraction(sinfo: StripeInfo, codec, target_shard: int,
                    chunk_stream, dispatcher=None, trace=None) -> bytes:
    """Helper-side projection of a regenerating repair: one surviving
    shard's chunk stream -> the fraction stream it ships to the primary
    rebuilding `target_shard` (chunk/alpha bytes a chunk), batched across
    stripes in one device call; with a dispatcher it rides the staged
    pipeline."""
    arr = _as_bytes(chunk_stream)
    if arr.size == 0 or arr.size % sinfo.chunk_size != 0:
        raise ErasureCodeError(
            22, "chunk stream %d not chunk aligned (%d)"
            % (arr.size, sinfo.chunk_size))
    batch = arr.reshape(arr.size // sinfo.chunk_size, sinfo.chunk_size)
    if dispatcher is not None:
        frac = dispatcher.repair_fraction(codec, target_shard, batch,
                                          trace=trace)
    else:
        frac = codec.repair_fraction_batch(target_shard, batch)
    return np.ascontiguousarray(np.asarray(frac)).reshape(-1).tobytes()


def _stack_fractions(sinfo: StripeInfo, codec, fractions: dict):
    """{helper shard: fraction stream} -> (helpers tuple, [S, d, sub])."""
    d = codec.repair_helper_count()
    if len(fractions) != d:
        raise ErasureCodeError(
            5, "repair combine needs %d fractions, got %d"
            % (d, len(fractions)))
    helpers = tuple(sorted(fractions))
    bufs = {h: _as_bytes(v) for h, v in fractions.items()}
    lengths = {v.size for v in bufs.values()}
    if len(lengths) != 1:
        raise ErasureCodeError(
            22, "fractions have unequal lengths %s" % lengths)
    total = lengths.pop()
    sub = codec.repair_sub_size(sinfo.chunk_size)
    if total == 0 or total % sub != 0:
        raise ErasureCodeError(
            22, "fraction stream %d not sub-symbol aligned (%d)"
            % (total, sub))
    stripes = total // sub
    stacked = np.stack([bufs[h].reshape(stripes, sub) for h in helpers],
                       axis=1)  # [S, d, sub]
    return helpers, stacked


def repair_combine(sinfo: StripeInfo, codec, target_shard: int,
                   fractions: dict, dispatcher=None, trace=None) -> bytes:
    """Primary-side combine: the d helper fraction streams -> the rebuilt
    target shard's chunk stream, one batched device call (through the
    dispatcher where one is given)."""
    helpers, stacked = _stack_fractions(sinfo, codec, fractions)
    if dispatcher is not None:
        out = dispatcher.repair_combine(codec, target_shard, helpers,
                                        stacked, trace=trace)
    else:
        out = codec.repair_combine_batch(target_shard, helpers, stacked)
    return np.ascontiguousarray(np.asarray(out)).reshape(-1).tobytes()


def repair_cross_chip(sinfo: StripeInfo, codec, target_shard: int,
                      fractions: dict, mesh=None, expected_sum=None):
    """The repair analog of recover_cross_chip (ref
    ``ceph_tpu/osd/ec_util.py:449``): the stacked helper fractions ride
    the rateless dispatcher's queue where one is up and no mesh is
    given, else are sharded over `mesh` and combined there
    (``parallel.mesh.repair_sharded``) after the same checksum, so a
    rebuild never gathers whole survivors anywhere.

    Returns the rebuilt shard's bytes, or None where the path does not
    apply (a codec without fraction repair, no mesh with no dispatcher
    set and under two cards); the caller then falls back to
    repair_combine()."""
    if not getattr(codec, "supports_repair", lambda: False)() or \
            not hasattr(codec, "_combine_entry") or _no_devices(mesh):
        return None
    helpers, stacked = _stack_fractions(sinfo, codec, fractions)
    disp = rateless.get_dispatcher() if mesh is None else None
    if disp is not None:
        _check_sum(stacked, expected_sum, "repair")
        out = disp.repair_combine(codec, target_shard, helpers, stacked)
        return np.ascontiguousarray(out).reshape(-1).tobytes()
    out = repair_sharded(codec, target_shard, helpers, stacked,
                         mesh=mesh, expected_sum=expected_sum)
    return np.ascontiguousarray(out).reshape(-1).tobytes()


class HashInfo:
    """Cumulative per-shard crc + size xattr (ECUtil.h:105-163).

    append() must be called with stripe-aligned same-length per-shard
    appends; the crc chains so any historical corruption is detectable
    on deep scrub.

    The fused write transform bypasses the host crc chain: set_device_hashes()
    accepts the device-computed per-shard crcs wholesale for a full-object
    write, and comp_info records the on-device compression of the stored
    stream ({"alg", "orig_chunk_size", "comp_len", "padded_len"}); when set,
    total_chunk_size is the STORED (compressed) per-shard stream length
    while logical sizes derive from orig_chunk_size.
    """

    def __init__(self, num_chunks: int = 0):
        self.total_chunk_size = 0
        self.cumulative_shard_hashes = [0] * num_chunks
        self.projected_total_chunk_size = 0
        self.comp_info: dict | None = None

    def has_chunk_hash(self) -> bool:
        return bool(self.cumulative_shard_hashes)

    def append(self, old_size: int, to_append: dict) -> None:
        assert old_size == self.total_chunk_size
        sizes = {len(np.asarray(v).reshape(-1)) for v in to_append.values()}
        assert len(sizes) == 1
        size = sizes.pop()
        if self.has_chunk_hash():
            assert len(to_append) == len(self.cumulative_shard_hashes)
            for shard, buf in to_append.items():
                data = np.asarray(buf, dtype=np.uint8).reshape(-1).tobytes()
                self.cumulative_shard_hashes[shard] = zlib.crc32(
                    data, self.cumulative_shard_hashes[shard]) & 0xFFFFFFFF
        self.total_chunk_size += size

    def set_device_hashes(self, shard_crcs, total_chunk_size: int,
                          comp_info: dict | None = None) -> None:
        """Accept device-computed cumulative shard crcs wholesale (the
        fused write transform's output), valid only as a full-object
        (re)write, which is when the fused path runs. comp_info records
        (or, None, clears) the stored stream's compression."""
        self.cumulative_shard_hashes = [int(c) & 0xFFFFFFFF
                                        for c in shard_crcs]
        self.total_chunk_size = int(total_chunk_size)
        self.comp_info = dict(comp_info) if comp_info else None

    def get_chunk_hash(self, shard: int) -> int:
        return self.cumulative_shard_hashes[shard]

    def get_total_chunk_size(self) -> int:
        return self.total_chunk_size

    def get_total_logical_size(self, sinfo: StripeInfo) -> int:
        base = self.comp_info["orig_chunk_size"] \
            if self.comp_info is not None else self.total_chunk_size
        return base * (sinfo.stripe_width // sinfo.chunk_size)

    def get_projected_total_logical_size(self, sinfo: StripeInfo) -> int:
        return self.projected_total_chunk_size * (sinfo.stripe_width //
                                                  sinfo.chunk_size)

    def set_projected_total_logical_size(self, sinfo: StripeInfo,
                                         logical_size: int) -> None:
        assert sinfo.logical_offset_is_stripe_aligned(logical_size)
        self.projected_total_chunk_size = \
            sinfo.aligned_logical_offset_to_chunk_offset(logical_size)

    def clear(self) -> None:
        self.total_chunk_size = 0
        self.cumulative_shard_hashes = [0] * len(
            self.cumulative_shard_hashes)
        self.comp_info = None

    def to_dict(self) -> dict:
        d = {"total_chunk_size": self.total_chunk_size,
             "cumulative_shard_hashes": list(
                 self.cumulative_shard_hashes)}
        if self.comp_info is not None:
            # only compressed objects carry the key: hinfo xattrs
            # written before the fused transform stay byte-identical
            d["comp_info"] = dict(self.comp_info)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "HashInfo":
        h = cls(len(d["cumulative_shard_hashes"]))
        h.total_chunk_size = d["total_chunk_size"]
        h.cumulative_shard_hashes = list(d["cumulative_shard_hashes"])
        h.comp_info = dict(d["comp_info"]) if d.get("comp_info") \
            else None
        # projections live in LOGICAL space: a compressed object's
        # projected size derives from the raw-equivalent chunk size
        h.projected_total_chunk_size = \
            h.comp_info["orig_chunk_size"] if h.comp_info is not None \
            else h.total_chunk_size
        return h
