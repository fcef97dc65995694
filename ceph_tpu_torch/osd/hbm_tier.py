"""Device-resident EC chunk tier: object data crosses the pipe once.

Port of ``ceph_tpu/osd/hbm_tier.py``. Once an object's chunks are in
device memory, every downstream consumer (deep-scrub digests, shard
reconstruction, repeat reads) reads the RESIDENT copy instead of crossing
PCIe again; the reference runs each of those as a separate CPU pass over
host memory (ECBackend::continue_recovery_op re-reads shards;
PGBackend::be_deep_scrub re-reads and re-digests). The host pays one h2d
per object lifetime and small d2h reads of the results (8 bytes a chunk
of digests; the rebuilt shard alone).

The dispatcher (``osd/gpu_dispatch.py``, ``resident=``) ADOPTS each
encode's staged data rows and computed parity on the device
(:meth:`HbmChunkTier.adopt_encode`: no chunk byte crosses from the host),
keyed by (pg, object); entries carry their codec, so one tier serves
every EC pool of an OSD. :meth:`drop` invalidates a mutated object and
:meth:`drop_prefix` a PG's entries on an interval change. Capacity is
bounded: an insert past ``capacity_objects`` evicts the least recently
used objects, and the device memory goes when the last object of its
upload batch is gone. Residency and utilisation ride the ``l_hbm_*``
counters.

The consumers run the port's kernels: :meth:`deep_scrub` the chunk digest
(``ops/digest_kernel.py``, one launch per chunk shape over the objects
where they lie), :meth:`reconstruct` the codec's decode (the GF bitmatrix
kernel) and :meth:`reconstruct_batch` the per-lane GF kernel
(``xor_mm.matrix_encode_multi_rows``, one launch for every object,
each lane given only its lost shard's w rows of its decode bitmatrix and
reading its survivors where they lie, through a table of their
addresses).

Where the port differs from the reference:

* The tier's ``device`` is explicit (``resolve_device``: CUDA unless the
  caller passes ``device="cpu"``), and a codec on another device is
  refused. A tensor on the tier's device is adopted as it is; a host
  array is uploaded once, and ``l_hbm_uploads`` / ``l_hbm_upload_bytes``
  count those uploads (a tensor elsewhere is refused, never copied
  through the host).
* ``stats()["device"]`` is the tier's torch device ("cuda:0", "cpu:0").
* The device-memory ledger (``common/profiler.PROFILER``) carries the
  resident bytes under ``hbm_tier`` when the caller passed no device,
  else ``hbm_tier[<label>]`` ("hbm_tier[cuda:0]"), as the reference keys
  it on its home device; every gauge refresh sets it. The digest counts
  as ``hbm_tier.digest`` in the profiler's kernel registry, the
  rebuild's per-lane product as ``xor_mm.matrix_encode_multi`` (the
  reference's rebuild calls that entry point).
* Streams: a batch written on one stream records an event, and every
  consumer's stream waits on it before reading; a consumer marks the
  arrays it reads with ``record_stream``, so an entry dropped while a
  consumer's kernel still reads it is not freed under that kernel.

Digest: a Fletcher-style pair (sum, index-weighted sum) over the chunk
bytes, both mod 2^32. Scrub only compares digests computed by this tier
or its numpy twin :func:`host_digest`, so it must be deterministic and
position-sensitive, not crc32c-compatible.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..common.perf_counters import PerfCountersBuilder
from ..common.profiler import PROFILER
from ..device import device_label, host_tensor, resolve_device
from ..ops import digest_kernel, xor_mm

__all__ = ["HbmChunkTier", "host_digest"]

# one registry entry however many tiers exist (ref hbm_tier.py:78)
_device_digest = PROFILER.wrap_kernel("hbm_tier.digest",
                                      digest_kernel.chunk_digest_many)


def host_digest(chunks: np.ndarray) -> np.ndarray:
    """Numpy twin of the device digest: chunks [..., n] uint8 ->
    uint64 digest per chunk ((weighted_sum << 32) | sum)."""
    x = np.asarray(chunks).astype(np.uint64)
    n = x.shape[-1]
    w = (np.arange(n, dtype=np.uint64) % 0xFFFF) + 1
    s = x.sum(axis=-1) & 0xFFFFFFFF
    ws = (x * w).sum(axis=-1) & 0xFFFFFFFF
    return (ws << np.uint64(32)) | s


def _u32_numpy(x) -> np.ndarray:
    """uint32 values of a tensor (read through int32: torch lacks uint32
    conversions) or of an array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int32).cpu().numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


class _Batch:
    """One resident array [B, k+m, n] shared by the B objects uploaded
    together. Batch granularity keeps a consumer's launches independent
    of the object count. `ready`, on CUDA, is the event recorded after
    the array was written, which every consumer's stream waits on."""

    __slots__ = ("arr", "live", "codec", "obj_bytes", "digests", "ready")

    def __init__(self, arr, live: int, codec=None, obj_bytes: int = 0,
                 digests=None, ready=None):
        self.arr = arr
        self.live = live
        self.codec = codec
        self.obj_bytes = obj_bytes
        # per-object per-shard crc32 (zlib poly) rows [B, k+m], computed
        # on the device by the fused write transform and adopted beside
        # the chunks: deep scrub of a resident object verifies against
        # these without hashing a byte on the host
        self.digests = digests
        self.ready = ready


class HbmChunkTier:
    """Keyed store of device-resident chunk arrays [k+m, chunk] with the
    consumers' device programs. `codec` is the default for put_encode;
    adopted entries carry their own codec."""

    def __init__(self, codec=None, capacity_objects: int = 64,
                 device=None):
        self.device = resolve_device(device)
        # residency is accounted under a per-device ledger category when
        # the caller pinned a device, so tiers on two devices never fight
        # over one gauge
        self._mem_category = "hbm_tier" if device is None \
            else "hbm_tier[%s]" % device_label(self.device)
        self.codec = codec
        if codec is not None:
            self._check_codec(codec)
        self.capacity = capacity_objects
        self._lock = threading.Lock()
        self._objs: dict = {}          # name -> (_Batch, row index)
        self._order: OrderedDict = OrderedDict()  # LRU, oldest first
        self._resident_bytes = 0
        self.perf = (PerfCountersBuilder("osd_hbm")
                     .add_u64("l_hbm_resident_objects",
                              "objects resident in device memory")
                     .add_u64("l_hbm_resident_bytes",
                              "device bytes held by resident chunks")
                     .add_u64_counter("l_hbm_hits",
                                      "consumer reads served resident")
                     .add_u64_counter("l_hbm_misses",
                                      "lookups that missed residency")
                     .add_u64_counter("l_hbm_evictions",
                                      "objects evicted over capacity")
                     .add_u64_counter("l_hbm_adopted",
                                      "encodes adopted device-side "
                                      "from the dispatcher pipeline")
                     .add_u64_counter("l_hbm_uploads",
                                      "host arrays the tier uploaded "
                                      "(put_encode, host adoptions)")
                     .add_u64_counter("l_hbm_upload_bytes",
                                      "chunk bytes the tier uploaded")
                     .create_perf_counters())

    # -- devices and streams -------------------------------------------

    def _check_codec(self, codec) -> None:
        dev = getattr(codec, "device", None)
        if dev is None or torch.device(dev) != self.device:
            raise ValueError(
                "codec on %s, tier on %s: the tier codes its objects on "
                "its own device" % (dev, self.device))

    def _upload(self, host) -> torch.Tensor:
        """The one h2d of host bytes (counted); a copy on a CPU tier."""
        arr = np.ascontiguousarray(np.asarray(host, dtype=np.uint8))
        t = host_tensor(arr)
        t = t.to(self.device) if self.device.type == "cuda" else t.clone()
        self.perf.inc("l_hbm_uploads")
        self.perf.inc("l_hbm_upload_bytes", int(arr.nbytes))
        return t

    def _operand(self, t: torch.Tensor) -> torch.Tensor:
        """A small host tensor of a consumer's operands (indices,
        bitmatrices) on the device, copied from pinned memory without
        blocking the host, in order on the current stream."""
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _on_device(self, a) -> torch.Tensor:
        """A tensor on the tier's device as it is; a host array uploaded.
        A tensor on another device is refused: it is never copied
        through the host."""
        if not isinstance(a, torch.Tensor):
            return self._upload(a)
        if a.device != self.device:
            raise ValueError("a tensor on %s offered to the tier on %s"
                             % (a.device, self.device))
        if a.dtype != torch.uint8:
            raise ValueError("chunks must be uint8, got %s" % a.dtype)
        return a

    def _written(self):
        """The event after the work queued so far on the current stream
        (None off CUDA)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _consume(self, uses) -> None:
        """Orders the current stream after the writes of the (array,
        ready event) pairs it is about to read, and keeps each array's
        memory from reuse until the stream's work so far is done."""
        if self.device.type != "cuda":
            return
        stream = torch.cuda.current_stream(self.device)
        seen = set()
        for arr, ready in uses:
            if id(arr) in seen:
                continue
            seen.add(id(arr))
            if ready is not None:
                stream.wait_event(ready)
            arr.record_stream(stream)

    # -- residency -----------------------------------------------------

    def _touch(self, name) -> None:
        self._order[name] = None
        self._order.move_to_end(name)

    def _drop_locked(self, name) -> None:
        ent = self._objs.pop(name, None)
        if ent is not None:
            ent[0].live -= 1
            self._resident_bytes -= ent[0].obj_bytes
            # device memory frees at batch granularity: the array goes
            # when its LAST object is evicted
            if ent[0].live <= 0:
                ent[0].arr = None
        self._order.pop(name, None)

    def _evict_over_capacity(self) -> None:
        while len(self._objs) > self.capacity and self._order:
            self._drop_locked(next(iter(self._order)))
            self.perf.inc("l_hbm_evictions")

    def _update_gauges_locked(self) -> None:
        self.perf.set("l_hbm_resident_objects", len(self._objs))
        self.perf.set("l_hbm_resident_bytes", self._resident_bytes)
        # device-memory ledger: tier residency is the dominant category,
        # so every gauge refresh updates the profiler too
        PROFILER.mem_set(self._mem_category, self._resident_bytes)

    def _insert_locked(self, name, batch: _Batch, row: int) -> None:
        if name in self._objs:
            self._drop_locked(name)
        self._objs[name] = (batch, row)
        self._resident_bytes += batch.obj_bytes
        self._touch(name)
        self._evict_over_capacity()

    def put_encode(self, names: list, data_host, codec=None):
        """THE one h2d: upload a batch of objects' data chunks
        [batch, k, n], encode parity on the device, and retain the full
        [batch, k+m, n] array resident. Returns the device parity
        [batch, m, n]. A tensor already on the tier's device is not
        uploaded again."""
        codec = codec if codec is not None else self.codec
        self._check_codec(codec)
        data = self._on_device(data_host)
        parity = codec.encode_batch(data)
        full = torch.cat([data, parity], dim=1)
        obj_bytes = int(full.shape[1]) * int(full.shape[2])
        batch = _Batch(full, len(names), codec, obj_bytes,
                       ready=self._written())
        with self._lock:
            for i, name in enumerate(names):
                self._insert_locked(name, batch, i)
            self._update_gauges_locked()
        return parity

    def adopt_encode(self, name, data_rows, parity_rows, codec,
                     digests=None) -> None:
        """Adopt one object's already-staged encode: data_rows
        [S, k, chunk] and parity_rows [S, m, chunk]. Tensors on the
        tier's device are copied on the device into the stored layout, on
        the current stream (the caller orders that stream after their
        producer): no chunk byte crosses from the host. Host arrays are
        accepted too; their one upload is then the object's crossing.

        Stored layout matches put_encode: [k+m, S*chunk], shard i's whole
        chunk stream in row i. `digests`, when given, is the fused
        transform's per-shard crc32 list (k+m entries, zlib poly over
        each shard's stored stream), kept for :meth:`shard_digests`."""
        self._check_codec(codec)
        if isinstance(data_rows, torch.Tensor) or \
                isinstance(parity_rows, torch.Tensor):
            data = self._on_device(data_rows)
            parity = self._on_device(parity_rows)
            S, k, chunk = data.shape
            m = parity.shape[1]
            full = torch.empty((k + m, S * chunk), dtype=torch.uint8,
                               device=self.device)
            rows = full.view(k + m, S, chunk)
            rows[:k].copy_(data.transpose(0, 1))
            rows[k:].copy_(parity.transpose(0, 1))
        else:
            # [S, k+m, chunk] -> [k+m, S, chunk] -> [k+m, S*chunk], in one
            # upload
            host = np.concatenate([np.asarray(data_rows, np.uint8),
                                   np.asarray(parity_rows, np.uint8)],
                                  axis=1)
            full = self._upload(host.transpose(1, 0, 2).reshape(
                host.shape[1], -1))
        obj_bytes = int(full.shape[0]) * int(full.shape[1])
        dig = None if digests is None else np.asarray(
            digests, dtype=np.uint32)[None]
        batch = _Batch(full[None], 1, codec, obj_bytes, dig,
                       ready=self._written())
        with self._lock:
            self._insert_locked(name, batch, 0)
            self._update_gauges_locked()
        self.perf.inc("l_hbm_adopted")

    def resident(self, name) -> bool:
        with self._lock:
            return name in self._objs

    def get(self, name):
        """The resident [k+m, n] chunks of `name` (a view of the tier's
        array, for reading), or None. The current stream is ordered after
        the entry's write."""
        with self._lock:
            ent = self._objs.get(name)
            if ent is None:
                self.perf.inc("l_hbm_misses")
                return None
            self._touch(name)
            self.perf.inc("l_hbm_hits")
            arr, ready = ent[0].arr, ent[0].ready
            obj = arr[ent[1]]
        self._consume([(arr, ready)])
        return obj

    def codec_of(self, name):
        """The codec an entry was encoded with (None when absent)."""
        with self._lock:
            ent = self._objs.get(name)
            return None if ent is None else (ent[0].codec or self.codec)

    def shard_digests(self, name):
        """Device-computed per-shard crc32 row of a resident object
        (uint32[k+m], zlib poly over each shard's stored stream), or None
        when the entry was adopted without digests: the scrub-from-digest
        surface, which verifies an object with no host hashing."""
        with self._lock:
            ent = self._objs.get(name)
            if ent is None or ent[0].digests is None:
                return None
            self._touch(name)
            self.perf.inc("l_hbm_hits")
            return np.asarray(ent[0].digests[ent[1]])

    def drop(self, name) -> None:
        with self._lock:
            self._drop_locked(name)
            self._update_gauges_locked()

    def drop_prefix(self, prefix) -> int:
        """Invalidate every entry whose tuple key starts with `prefix`
        (the PG interval-change hook: a primaryship hand-off must drop
        the PG's residency). Returns the number of entries dropped."""
        with self._lock:
            victims = [name for name in self._objs
                       if isinstance(name, tuple) and name
                       and name[0] == prefix]
            for name in victims:
                self._drop_locked(name)
            if victims:
                self._update_gauges_locked()
        return len(victims)

    # -- consumers (all read the RESIDENT copy) ------------------------

    def _runs(self, names: list) -> list:
        """The named objects as runs of one batch each: (array, ready
        event, [rows]), in name order. Called under the lock; the runs
        hold the arrays, so a later eviction frees none of them."""
        runs: list = []
        for name in names:
            batch, row = self._objs[name]
            if runs and runs[-1][0] is batch.arr:
                runs[-1][2].append(row)
            else:
                runs.append((batch.arr, batch.ready, [row]))
        return runs

    def _digests(self, runs: list):
        """(s, ws) uint32 [objects, k+m] of the runs' objects (one chunk
        shape), in one digest launch over the objects where they lie."""
        self._consume([(arr, ready) for arr, ready, _ in runs])
        s, ws = _device_digest(
            [arr for arr, _, _ in runs], [rows for _, _, rows in runs])
        shape = (sum(len(rows) for _, _, rows in runs), runs[0][0].shape[1])
        return s.view(shape), ws.view(shape)

    def deep_scrub(self, names: list, device_out: bool = False):
        """Per-chunk digests of every named resident object, computed on
        the device in one launch per chunk shape; only the digests (8
        bytes a chunk) cross back. Returns {name: uint64[k+m]}, or, with
        device_out, the device (s, ws) pair of uint32 [len, k+m], so a
        caller batching several consumers defers every host read to the
        end (finalize_digests turns the pair into the dict; device_out
        needs one chunk shape across names)."""
        with self._lock:
            by_shape: dict = {}
            for name in names:
                ent = self._objs[name]
                shape = tuple(ent[0].arr.shape[1:])
                by_shape.setdefault(shape, []).append(name)
            groups = [(group, self._runs(group))
                      for group in by_shape.values()]
        if device_out:
            if len(groups) != 1:
                raise ValueError("device_out needs one chunk shape, "
                                 "got %d" % len(groups))
            return self._digests(groups[0][1])
        out: dict = {}
        for group, runs in groups:
            s, ws = self._digests(runs)
            out.update(self.finalize_digests(group, s, ws))
        return out

    @staticmethod
    def finalize_digests(names: list, s, ws) -> dict:
        s = _u32_numpy(s).astype(np.uint64)
        ws = _u32_numpy(ws).astype(np.uint64)
        dig = (ws << np.uint64(32)) | s
        return {name: dig[i] for i, name in enumerate(names)}

    def reconstruct(self, name, lost_shards: tuple):
        """Rebuild the lost shard(s) from the RESIDENT survivors: no host
        read of chunk data. Returns the device rows [len(lost), n]."""
        with self._lock:
            ent = self._objs.get(name)
            if ent is None:
                self.perf.inc("l_hbm_misses")
                raise KeyError(name)
            self._touch(name)
            self.perf.inc("l_hbm_hits")
            arr, ready = ent[0].arr, ent[0].ready
            obj = arr[ent[1]]
            codec = ent[0].codec or self.codec
        self._consume([(arr, ready)])
        nn = codec.get_chunk_count()
        avail = tuple(i for i in range(nn) if i not in lost_shards)
        k = codec.get_data_chunk_count()
        survivors = obj[list(avail[:k])][None]
        # decode_batch maps k survivors -> all k+m rows; keep the lost
        all_rows = codec.decode_batch(avail[:k], survivors)
        return all_rows[0][list(lost_shards)]

    def _rebuild_operands(self, names: list, lost_per_name: list):
        """The per-lane kernel's operands of :meth:`reconstruct_batch`:
        (bitmats [P, w, k*w] on the device, each lane's lost shard's rows
        of its decode bitmatrix; the upload batches holding the named
        objects and, per batch, the rows of each object's first k shards
        but its lost one, as ``gf_kernel.matrix_encode_multi_rows`` reads
        them where they lie; w). The current stream is ordered after the
        batches' writes and keeps them from reuse until it has read them.
        Needs one codec and shape across names."""
        with self._lock:
            codec = self._objs[names[0]][0].codec or self.codec
            nn = codec.get_chunk_count()
            k = codec.get_data_chunk_count()
            w = codec.w
            avail = [tuple(i for i in range(nn) if i != lost)[:k]
                     for lost in lost_per_name]
            # only the lost shard's w rows of each decode bitmatrix
            bitmats = [codec._decode_entry(av)["bitmat"][lost * w:
                                                        (lost + 1) * w]
                       for av, lost in zip(avail, lost_per_name)]
            runs = self._runs(names)
        self._consume([(arr, ready) for arr, ready, _ in runs])
        parts, rows, at = [], [], 0
        for arr, _, objs in runs:
            shards = np.asarray(avail[at:at + len(objs)], dtype=np.int64)
            rows.append((np.asarray(objs, dtype=np.int64)[:, None] * nn +
                         shards).reshape(-1))
            parts.append(arr)
            at += len(objs)
        bm = host_tensor(np.ascontiguousarray(np.stack(bitmats)))
        return self._operand(bm), parts, rows, w

    def reconstruct_batch(self, names: list, lost_per_name: list):
        """One per-lane GF launch rebuilding one lost shard per named
        object from the RESIDENT survivors, read where they lie in their
        upload batches (no gathered copy), each lane with its own decode
        bitmatrix (the shape the OSD coalesces concurrent recovery ops
        into); a lane is given only its lost shard's w rows, which is the
        row the reference keeps of its full decode. Needs one codec and
        shape across names. Returns the device array [len(names), n]."""
        bm, parts, rows, w = self._rebuild_operands(names, lost_per_name)
        return xor_mm.matrix_encode_multi_rows(bm, parts, rows, w)[:, 0]

    def stats(self) -> dict:
        with self._lock:
            perf = self.perf.dump()
            hits, misses = perf["l_hbm_hits"], perf["l_hbm_misses"]
            return {"device": device_label(self.device),
                    "resident_objects": len(self._objs),
                    "resident_bytes": self._resident_bytes,
                    "capacity": self.capacity,
                    "occupancy": round(len(self._objs) / self.capacity,
                                       4) if self.capacity else 0.0,
                    "hits": hits,
                    "misses": misses,
                    "hit_rate": round(hits / (hits + misses), 3)
                    if hits + misses else 0.0,
                    "adopted": perf["l_hbm_adopted"],
                    "digested": sum(
                        1 for ent in self._objs.values()
                        if ent[0].digests is not None),
                    "evictions": perf["l_hbm_evictions"]}

    def uploads(self) -> tuple[int, int]:
        """(uploads, bytes) the tier made from host arrays."""
        perf = self.perf.dump()
        return perf["l_hbm_uploads"], perf["l_hbm_upload_bytes"]

    def occupancy(self) -> float:
        """Occupancy ratio for the DEVICE_MEM_NEARFULL feed (objects over
        capacity: eviction keys on the object count, so the pressure
        signal keys on the same axis)."""
        with self._lock:
            return len(self._objs) / self.capacity \
                if self.capacity else 0.0
