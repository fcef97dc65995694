"""EC write planning + per-shard transaction generation.

Port of ``ceph_tpu/osd/ec_transaction.py``. The planner is host code,
kept as the reference has it; its encodes are the port's
``ec_util.encode`` (the GF bitmatrix kernel) and ``ec_util.encode_fused``
(the write transform's K1-K3 and the GF kernel), through the
dispatcher where one is given.

Role of the reference's ECTransaction (src/osd/ECTransaction.{h,cc}):

  get_write_plan          walk the PGTransaction computing, per object,
                          the stripe-aligned extents that must be READ
                          (partial head/tail stripes of an overwrite —
                          RMW) and WRITTEN (ECTransaction.h:44-183);
                          tracks projected object sizes via HashInfo
  generate_transactions   with the readback data in hand, overlay the
                          logical writes, ENCODE (the hot loop,
                          ECTransaction.cc:45 -> ECUtil::encode), and
                          emit one ObjectStore Transaction per shard
                          with the chunk writes + hinfo xattr
                          (:645-653)

Each object's whole will_write region encodes in ONE batched device
call via ec_util.encode.
"""

from __future__ import annotations

import json

import numpy as np

from ..common.interval_set import IntervalSet
from ..store.object_store import Transaction
from . import ec_util

__all__ = ["WritePlan", "get_write_plan", "generate_transactions",
           "HINFO_KEY"]

HINFO_KEY = "hinfo_key"  # reference ECUtil::get_hinfo_key()


class WritePlan:
    def __init__(self):
        self.t = None                   # the PGTransaction
        self.invalidates_cache = False
        self.to_read: dict = {}         # oid -> IntervalSet (logical)
        self.will_write: dict = {}      # oid -> IntervalSet (superset)
        self.hash_infos: dict = {}      # oid -> HashInfo


def get_write_plan(sinfo: ec_util.StripeInfo, t, get_hinfo) -> WritePlan:
    """Mirror of the get_write_plan template (ECTransaction.h:44-183)."""
    plan = WritePlan()
    for oid, op in t.safe_create_traverse():
        hinfo = get_hinfo(oid)
        plan.hash_infos[oid] = hinfo
        projected_size = hinfo.get_projected_total_logical_size(sinfo)

        if op.deletes_first():
            projected_size = 0

        if op.has_source():
            plan.invalidates_cache = True
            shinfo = get_hinfo(op.source)
            projected_size = shinfo.get_projected_total_logical_size(sinfo)
            plan.hash_infos[op.source] = shinfo

        will_write = plan.will_write.setdefault(oid, IntervalSet())

        # a COMPRESSED object (fused write transform, hinfo.comp_info)
        # cannot be partially overwritten in place: logical offsets
        # don't map to stored chunk offsets.  Any mutation becomes a
        # full-object RMW — read the whole object back (the read path
        # decompresses), overlay, rewrite whole
        if getattr(hinfo, "comp_info", None) is not None \
                and not op.deletes_first() and projected_size > 0 \
                and (op.buffer_updates or op.truncate is not None):
            plan.to_read.setdefault(oid, IntervalSet()).union_insert(
                0, projected_size)
            will_write.union_insert(0, projected_size)

        # unaligned truncate-down: rewrite the boundary stripe
        if op.truncate is not None and op.truncate[0] < projected_size:
            trunc = op.truncate[0]
            if not sinfo.logical_offset_is_stripe_aligned(trunc):
                start = sinfo.logical_to_prev_stripe_offset(trunc)
                plan.to_read.setdefault(oid, IntervalSet()).union_insert(
                    start, sinfo.stripe_width)
                will_write.union_insert(start, sinfo.stripe_width)
            projected_size = sinfo.logical_to_next_stripe_offset(trunc)

        raw_write_set = IntervalSet()
        for upd in op.buffer_updates:
            off = upd[1]
            length = len(upd[2]) if upd[0] == "write" else upd[2]
            raw_write_set.union_insert(off, length)

        orig_size = projected_size
        for off, length in raw_write_set:
            head_start = sinfo.logical_to_prev_stripe_offset(off)
            head_finish = sinfo.logical_to_next_stripe_offset(off)
            if head_start > projected_size:
                head_start = projected_size
            if head_start != head_finish and head_start < orig_size:
                plan.to_read.setdefault(oid, IntervalSet()).union_insert(
                    head_start, sinfo.stripe_width)

            tail_start = sinfo.logical_to_prev_stripe_offset(off + length)
            tail_finish = sinfo.logical_to_next_stripe_offset(off + length)
            if tail_start != tail_finish and \
                    (head_start == head_finish or tail_start != head_start) \
                    and tail_start < orig_size:
                plan.to_read.setdefault(oid, IntervalSet()).union_insert(
                    tail_start, sinfo.stripe_width)

            if head_start != tail_finish:
                will_write.union_insert(head_start,
                                        tail_finish - head_start)
                if tail_finish > projected_size:
                    projected_size = tail_finish

        # truncate-up (or post-write final truncate) extends with zeros
        if op.truncate is not None and op.truncate[1] > projected_size:
            truncating_to = sinfo.logical_to_next_stripe_offset(
                op.truncate[1])
            will_write.union_insert(projected_size,
                                    truncating_to - projected_size)
            projected_size = truncating_to

        hinfo.set_projected_total_logical_size(sinfo, projected_size)
    plan.t = t
    return plan


def generate_transactions(plan: WritePlan, codec,
                          sinfo: ec_util.StripeInfo,
                          partial_extents: dict,
                          shards: list,
                          cid_of, dispatcher=None,
                          trace=None, tier=None,
                          tier_prefix=None,
                          fused_mode: str | None = None,
                          fused_required_ratio: float = 0.875,
                          fused_entropy_max: float = 7.0
                          ) -> tuple[dict, dict]:
    """Build {shard: Transaction} from the plan + readback data.

    partial_extents: oid -> ExtentMap with the to_read stripes filled
    (from cache or remote shard reads). cid_of(shard) names the target
    collection. Returns (transactions, written) where written maps
    oid -> ExtentMap of the logical bytes this op wrote (fed back into
    the ExtentCache, mirroring generate_transactions' `written` out-param).

    tier/tier_prefix wire the HbmChunkTier: EVERY mutation of an
    object first invalidates its resident entry (a stale resident copy
    must never serve a later scrub/recovery/read), and a whole-object
    write re-adopts the encode device-side through the dispatcher
    pipeline — partial RMWs stay host-planned and simply leave the
    object non-resident until its next full write.

    fused_mode routes whole-object writes through the fused write
    transform (ec_util.encode_fused: digests + compress decision + EC
    encode in one device program): "store" fuses digests+encode,
    "compress" additionally lets the device compress the stored
    stream; None/"off" keeps the classic encode.  Partial RMWs and
    ops carrying a truncate always take the classic path.
    """
    txns = {shard: Transaction() for shard in shards}
    written: dict = {}
    n = codec.get_chunk_count()
    fused_ok = (fused_mode not in (None, "", "off")
                and dispatcher is not None
                and dispatcher.fused_supported(codec))

    for oid, op in plan.t.safe_create_traverse():
        tier_key = None
        if tier is not None:
            tier_key = (tier_prefix, oid)
            tier.drop(tier_key)        # any mutation invalidates
        hinfo = plan.hash_infos[oid]

        if op.deletes_first():
            for shard, txn in txns.items():
                txn.remove(cid_of(shard), oid)
            hinfo.clear()

        if op.init_type == "clone":
            for shard, txn in txns.items():
                txn.clone(cid_of(shard), op.source, oid)
        elif op.init_type == "rename":
            for shard, txn in txns.items():
                txn.collection_move_rename(cid_of(shard), op.source,
                                           cid_of(shard), oid)
        elif op.init_type == "create":
            for shard, txn in txns.items():
                txn.touch(cid_of(shard), oid)

        will_write = plan.will_write.get(oid) or IntervalSet()
        if will_write:
            pex = partial_extents.get(oid)
            wmap = written.setdefault(oid, {})
            appends = {}
            extents = list(will_write)
            # residency: only a single extent covering the whole
            # (projected) object is adopted — its encode IS the full
            # chunk set, so the resident copy can serve any later
            # scrub digest, shard rebuild or whole-object read
            whole_object = (
                len(extents) == 1
                and extents[0][0] == 0 and extents[0][1] > 0
                and extents[0][1] ==
                hinfo.get_projected_total_logical_size(sinfo))
            # fused write transform: whole-object writes without a
            # truncate ride the single device program (a truncate's
            # chunk arithmetic runs in logical space and must not cut
            # a freshly compressed stream)
            use_fused = (fused_ok and whole_object
                         and op.truncate is None)
            fused_res = None
            for off, length in extents:
                # assemble the logical bytes for this extent: readback
                # stripes overlaid with the op's buffer updates,
                # zero-filled elsewhere
                buf = np.zeros(length, dtype=np.uint8)
                if pex is not None:
                    got = pex.get(off, length)
                    if got is None:
                        for s, d in pex:
                            e = s + d.size
                            lo, hi = max(s, off), min(e, off + length)
                            if lo < hi:
                                buf[lo - off:hi - off] = \
                                    d[lo - s:hi - s]
                    else:
                        buf[:] = got
                for upd in op.buffer_updates:
                    if upd[0] == "write":
                        uoff, data = upd[1], np.frombuffer(upd[2],
                                                           np.uint8)
                    else:
                        uoff, data = upd[1], np.zeros(upd[2], np.uint8)
                    lo = max(uoff, off)
                    hi = min(uoff + data.size, off + length)
                    if lo < hi:
                        buf[lo - off:hi - off] = data[lo - uoff:hi - uoff]

                res = (tier, tier_key) \
                    if whole_object and tier_key is not None else None
                if use_fused:
                    encoded, fused_res = ec_util.encode_fused(
                        sinfo, codec, buf, dispatcher=dispatcher,
                        trace=trace, resident=res,
                        mode="compress" if fused_mode == "compress"
                        else "store",
                        required_ratio=fused_required_ratio,
                        entropy_max_bits=fused_entropy_max)
                else:
                    encoded = ec_util.encode(
                        sinfo, codec, buf, dispatcher=dispatcher,
                        trace=trace, resident=res)
                chunk_off = sinfo.aligned_logical_offset_to_chunk_offset(off)
                for shard in range(n):
                    if shard in txns:
                        txns[shard].write(cid_of(shard), oid, chunk_off,
                                          encoded[shard].tobytes())
                wmap[off] = buf
                appends[chunk_off] = encoded

            # hinfo chains crcs only for pure appends (overwrites
            # invalidate the chunk hash, as in the reference's
            # overwrite path).  A fused write replaces the hinfo
            # wholesale with the DEVICE-computed shard crcs — zero
            # host hashing on the whole-object write path
            old_size = hinfo.get_total_chunk_size()
            if fused_res is not None:
                stored_chunk = fused_res.used_stripes * sinfo.chunk_size
                comp = None
                if fused_res.compressed:
                    from .fused_transform import COMP_ALG
                    comp = {"alg": COMP_ALG,
                            "orig_chunk_size":
                                sinfo.aligned_logical_offset_to_chunk_offset(
                                    extents[0][1]),
                            "comp_len": fused_res.comp_len,
                            "padded_len": fused_res.padded_len}
                hinfo.set_device_hashes(fused_res.shard_crcs,
                                        stored_chunk, comp_info=comp)
                # clamp every shard file to the stored stream: a
                # rewrite of a previously-longer (or previously-raw)
                # object must not leave a stale tail behind the
                # (possibly shorter) compressed container
                for shard, txn in txns.items():
                    txn.truncate(cid_of(shard), oid, stored_chunk)
            elif all(off >= old_size for off in appends):
                for chunk_off in sorted(appends):
                    hinfo.append(chunk_off, appends[chunk_off])
            else:
                hinfo.cumulative_shard_hashes = []
                hinfo.total_chunk_size = max(
                    hinfo.total_chunk_size,
                    hinfo.projected_total_chunk_size)
                hinfo.comp_info = None   # the object is raw again

        # shard truncate to the projected size
        if op.truncate is not None:
            target = hinfo.get_projected_total_logical_size(sinfo)
            chunk_target = sinfo.aligned_logical_offset_to_chunk_offset(
                target)
            for shard, txn in txns.items():
                txn.truncate(cid_of(shard), oid, chunk_target)
            hinfo.total_chunk_size = chunk_target
            if hinfo.cumulative_shard_hashes:
                hinfo.cumulative_shard_hashes = []

        # attrs/omap mirror to every shard; hinfo xattr carries the
        # integrity state (ECTransaction.cc:645-653). A pure delete
        # leaves nothing behind, so no hinfo either.
        leaves_object = (op.init_type != "none" or bool(will_write)
                         or op.truncate is not None
                         or not op.deletes_first())
        for shard, txn in txns.items():
            cid = cid_of(shard)
            for name, value in op.attr_updates.items():
                if value is None:
                    txn.rmattr(cid, oid, name)
                else:
                    txn.setattr(cid, oid, name, value)
            if op.omap_updates:
                txn.omap_setkeys(cid, oid, op.omap_updates)
            if op.omap_rmkeys:
                txn.omap_rmkeys(cid, oid, op.omap_rmkeys)
            if not op.is_none() and leaves_object:
                txn.setattr(cid, oid, HINFO_KEY,
                            json.dumps(hinfo.to_dict()).encode())

    # convert logical written maps to ExtentMaps
    from ..common.interval_set import ExtentMap
    out_written = {}
    for oid, wmap in written.items():
        em = ExtentMap()
        for off, buf in wmap.items():
            em.insert(off, buf)
        out_written[oid] = em
    return txns, out_written
