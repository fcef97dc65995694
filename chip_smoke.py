#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ceph_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path at the bench's real size — Reed-Solomon
reed_sol_van k=8, m=3, w=8 on batches of 16 objects of 1 MiB
([16, 8, 131072] uint8) — the OSD's fused write of a 4 MiB object, the
batched CRUSH placement of a 1024-OSD cluster, the device chunk tier
fed by the dispatcher's writes and the MSR code's regenerating repair,
reads the port's telemetry, stage profiler, span collector and
device-memory ledger, runs the multi-device paths (the device mesh,
the mesh-sharded CRUSH sweep, rateless dispatch) over one card repeated,
and the placement control plane (the full remap of a two-pool cluster,
churn, the upmap balancer, crushtool's and osdmaptool's CLIs) and the
native seam (the C++ runtime built from ``native/``, its host codec and
mapper beside the card's, native threads' encodes through the batching
bridge onto the card, the two erasure-code CLIs) and the OSD's
erasure-coded backend (ECBackend's write, read-modify-write, read,
degraded-read, recovery and regenerating-repair pipelines in a loopback
PG of in-process OSDs) and the PG above it (client ops, peering, log
recovery, remap, deep scrub and repair on loopback OSD daemons),
through the entry points a user calls,
and holds every kernel of the paths against its plain PyTorch version on
the card. Phases, each printing one JSON line:

  1. setup       build every ``ceph_tpu_torch/csrc/*.cu`` (one nvcc each,
                 all at once), report the card and, from ptxas' log, the
                 registers, spill bytes and static shared memory of every
                 kernel instantiation (a spill fails the phase); launch a
                 kernel with 48 KiB of dynamic shared memory beside its
                 static shared memory (``ops/launch_check.py``), which
                 must run.
  2. kernel      the GF bitmatrix kernel against ``matrix_encode_plain``
                 on CUDA tensors, on its three designs: bit-sliced
                 (w=8 k=8 encode and three decode bitmatrices, w=8 k=16
                 m=4 encode and decode, a ragged N, a data pointer one
                 byte off, a [448, 128] bitmatrix whose expansion just
                 fits in shared memory), popcount (the w=16 encode) and
                 mma, on the int8 tensor cores (w=8 k=40, w=32, w=8
                 bitmatrices of k = 4, 8, 16 whose expansion does not
                 fit, and a [1368, 720] one past 512 columns in eight row
                 groups), then the per-lane and row-table entry points on
                 the mma design past 512 columns: byte equality, the
                 design each case took and its one launch, as the entry
                 point counts them, kernel / plain times.
  3. main_path   ``registry.factory("torch_cuda", ...)``: encode_batch,
                 then decode_batch for all C(11,8)=165 erasure signatures
                 (reconstruction must equal the original rows; one object
                 also equals the numpy oracle ``gf_ref``).
  4. dispatcher  8 threads submit host batches of 1 MiB objects through
                 ``GpuDispatcher`` (encode_async and decode_async over
                 random signatures); every result is verified.
  5. packet      the packet-layout kernel against ``bitmatrix_encode_plain``
                 on CUDA tensors: w = 7, 8, 16, 32 at packetsizes 3, 8, 24,
                 2048, 8192 with B = 1 and 16, a data pointer one byte off, a
                 geometry past the staged design's budget, a partial last
                 tile, the Cauchy k=10, m=4 encode and a decode bitmatrix, a
                 random [32, 80] bitmatrix, the Cauchy encode at packetsize
                 8192, the liberation k=7, w=7 encode (sparse: must take the
                 vector design), and a bitmatrix past shared memory (must
                 raise); byte equality, the design each case took (staged,
                 vector, byte) and its one launch, the input bytes each design
                 reads per launch against the unique bytes (counted from the
                 design's loads, not measured), the kernel's time and bound,
                 and at the Cauchy shapes the plain version's time and the
                 selected packet bytes per second.
  6. codecs      the slice's path, the BASELINE's other codecs at 16
                 objects of 1 MiB: cauchy_good k=10, m=4 at packetsizes
                 512..8192 (encode, decode with chunks 0-3 erased, and
                 all 1001 signatures at 2048), lrc_cuda k=4, m=2, l=3
                 (encode, decode with chunks 0 and 5 erased), shec_cuda
                 k=8, m=4, c=3 (encode, every 1- and 2-erasure signature),
                 then the dispatcher fed cauchy_good at packetsizes 2048
                 and 8192 with equal batch shapes from 8 threads. Every
                 output equals the original bytes, one object of each
                 encode equals the numpy oracle, and no dispatch mixes
                 the two packetsizes.
  7. write_kernels  the write transform's kernels (csrc/write_transform.cu)
                 against their plain versions on CUDA tensors, byte for
                 byte: the CRC of rows (chunk crc32c and xxh32 at
                 [128, 8, 4096] and [16, 8, 65536], ragged chunks of 1,
                 15, 96 and 4097 bytes, a pointer one byte off, the shard
                 streams read in place, pads of 0, one stripe and most of
                 the compress capacity, one 8 MiB + 3 byte stream; xxh32
                 also at 3 and 33 rows, not multiples of a warp's 8) and
                 the bit-plane stage (low-entropy, random, all-zero and
                 all-one bytes, an N that is not a multiple of 64, 16 MiB
                 past the grid the card holds at once: its tiles loaded
                 twice are counted); CUDA launches per call (one each),
                 and no memset before a bit-plane call; kernel / plain /
                 bound times and, for the histogram, torch.bincount.
  8. write_path  the slice's path on RS k=8, m=3: ec_util.encode_fused in
                 store mode on one 4 MiB object at stripe_unit 4096
                 ([128, 8, 4096]; shards equal ec_util.encode, shard crcs
                 equal zlib, digests equal the host oracles and the plain
                 versions), compress mode at [16, 8, 65536] and
                 [128, 8, 4096] on low-entropy bytes and on random bytes,
                 GpuDispatcher.fused_write_async from 8 threads (8
                 objects of 4 MiB, one in four compressed), fused against
                 separate at [16, 8, 65536] (medians of interleaved
                 windows), device_crc32 against zlib; launches per fused
                 write (by kernel and in all: 5 a store write, 6 a
                 compress write) and the queued device time of each,
                 counted from 0 just before the phase.
  9. crush       the batched CRUSH sweep, ``batched_do_rule`` from host
                 seeds to host results, on the bench's map (bench.py:820:
                 8 hosts of 4 OSDs, chooseleaf indep 5, OSD 3 out) at
                 65,536 seeds, and on the 1024-OSD cluster that
                 ``crushtool --build --num-osds 1024 host straw2 16 rack
                 straw2 8 root straw2 0`` makes (73 buckets), under a
                 rebalance's reweights, with its EC rule (chooseleaf indep
                 over hosts, 12 slots) and its replicated one (chooseleaf
                 firstn, 3) at 8,192 PGs and 1,048,576 seeds, and the EC
                 rule with a two-position weight set at 65,536: every
                 sweep one launch of the CUDA kernel (none on the scalar
                 path, counted from 0 just before), every seed equal to
                 the plain version on the card, 256 sampled seeds equal
                 to the scalar mapper; the lanes a seed each sweep took
                 (G) and its clock split from a profiled launch (per warp
                 its cycles, the draw steps it issued and the lanes active
                 at them; the SM clock nvidia-smi reads during the 2^20 EC
                 sweep); kernel ms (CUDA events, seeds on the card, tables
                 cached), PGs per second, the plain version's ms at 65,536
                 seeds, the bound from the draws the kernel counts, and
                 the end-to-end split (compile_map, the tables' upload,
                 h2d, kernel, d2h). Then
                 ``crushtool --test --batched --show-utilization`` on the
                 cluster at 8,192 PGs, its report at 512 PGs equal to the
                 scalar run's.
  10. hbm_tier   the device chunk tier (``osd/hbm_tier.py``) and its two
                 kernels, the chunk digest (``csrc/hbm_digest.cu``) and
                 the per-lane GF product (``gf_bitmatrix_encode_multi``):
                 (a) the reference bench's resident pipeline
                 (bench.py:915-935): RS k=8, m=3, 3 rounds of 16 objects
                 of 1 MiB through ``put_encode`` (one upload each), then
                 ``deep_scrub(device_out=True)`` of all 48 x1, x3 and x9
                 and ``reconstruct_batch`` with lost shard (i + r) % 11,
                 every digest equal to ``host_digest`` and every rebuilt
                 shard to the original; (b) the OSD's write path: 64
                 writes of 4 MiB ([128, 8, 4096]) from 8 threads through
                 ``GpuDispatcher.fused_write_async(resident=)``, one in
                 four compress-mode on low-entropy bytes, into a tier of
                 the default 64 objects: every object resident with no
                 upload by the tier, the dispatcher staging the same bytes
                 as without ``resident=``, ``shard_digests`` equal to the
                 write's crcs and zlib, ``deep_scrub`` to ``host_digest``
                 of the shard streams, ``reconstruct`` of 1 and 2 shards
                 and ``reconstruct_batch`` per chunk shape to the shard
                 map, and a 65th write evicting the least recently used;
                 (c) 1024 objects of 4 MiB through ``put_encode`` in
                 batches of 16 ([16, 8, 524288]) into a tier of 1024 (5.5
                 GiB resident): one ``deep_scrub`` (one digest launch),
                 one ``reconstruct_batch`` of 1024 lost shards (one
                 per-lane launch reading the survivors where they lie,
                 through a table of their addresses; its peak memory
                 above what was allocated before it), every digest
                 against the plain version on the card, every rebuilt
                 shard against the resident original and 32 sampled
                 against the host bytes. Launches per call, counted from
                 before each call; then each kernel alone on each part's
                 inputs (CUDA events), its plain version, bound and
                 bound_by, a rebuild's operands (bitmatrices and the row
                 table) and the whole rebuild in device time and peak
                 memory, and the digest on one batch array beside
                 ``torch.sum`` of the same bytes.
  11. msr_repair the product-matrix MSR regenerating code through
                 ``registry.factory("msr_cuda", ...)``: (a) the reference
                 bench's repair leg at its own size (bench.py:1845-1920):
                 k=8, m=7 beside RS k=8, m=3, 8 stripes of 1 MiB, the
                 encode, 14 ``repair_fraction_batch`` of chunk 2 and one
                 ``repair_combine_batch``, every stripe equal to
                 ``repair_oracle`` and the original, ``traffic_ratio``
                 gated below 1, ``repair_MBps`` beside ``rs_decode_MBps``
                 (wall time ended by a synchronise); (b) a recovery batch
                 of 64 objects of 4 MiB (503 MB of chunks on the card):
                 the encode, ``decode_batch`` over 8 signatures (each one
                 mma launch of a [840, 448] bitmatrix in two row groups),
                 fractions and combines through
                 ``GpuDispatcher.repair_fraction_async`` /
                 ``repair_combine_async`` from 8 threads and through
                 ``ec_util.repair_fraction`` / ``repair_combine``, every
                 rebuilt chunk equal to the original; (c) msr k=10, m=9,
                 whose [648, 720] encode and [1368, 720] decode go past
                 512 columns: one mma launch each, byte-equal to the
                 plain version. Launches by design per call,
                 counted from 0 just before the phase; then each k=8
                 matrix (encode, decode, fraction, combine) alone at
                 (a)'s shapes: kernel ms, plain ms, bound.
  12. telemetry  the observability layer (``common/profiler.py``,
                 ``common/tracer.py``, the dispatcher's stage profiler)
                 with a SpanCollector, the profiler reset before the
                 phase and a PerfCountersCollection of the dispatcher's
                 and the tier's counters: (a) phase 4's streaming load (8
                 threads, 2 objects of 1 MiB an op, encode and decode over
                 6 signatures) with every op traced: each op's span has
                 gpu_queue and gpu_device with h2d, compute and d2h
                 nested in it, render_tree renders one trace (printed),
                 dispatch_profile()'s fractions lie in [0, 1] and its
                 verdict is printed, ``xor_mm.matrix_encode``'s calls
                 (compiles + cache hits) equal the GF kernel's launches
                 (counted from 0 just before the load), staging_ring reads
                 0 after the last op; the pinning copy of one op's batch
                 timed apart; (b) 16 fused 4 MiB store writes through
                 ``fused_write_async(resident=)``: fused_transform.program
                 counted once a write, the writes' stage profile, the
                 tier's ledger category equal to its resident bytes
                 (``torch.cuda.memory_allocated`` beside it), then one
                 deep_scrub and one reconstruct_batch of the 16 objects,
                 each one call of its kernel's entry point, and their wall
                 times; (c) load (a) with the profiler and the tracer on and
                 off in turns (on, off, off, on): MB/s of each, no gate.
  13. mesh       the multi-device paths on ``["cuda:0"] * 4``, the GF,
                 digest and CRUSH kernels counted from 0 just before: (a)
                 over a 2 x 2 mesh, ``encode_sharded`` and
                 ``decode_sharded`` of RS k=8, m=3 at [16, 8, 131072],
                 ``ec_util.recover_cross_chip`` of a 4 MiB object and
                 ``repair_cross_chip`` of MSR k=8, m=7 (8 stripes of 1
                 MiB, phase 11's size), each equal to the single-device
                 call and the lost bytes, one GF launch a block and one
                 digest launch a block for the checksum, and a survivor
                 corrupted by one byte raising MeshChecksumError; (b)
                 ``mesh_do_rule`` of the 1024-OSD cluster's EC rule at
                 2^20 seeds over a flat mesh of 4 (one launch a share)
                 and through the rateless queue, equal to
                 ``batched_do_rule`` and 64 seeds to the scalar mapper;
                 (c) a ``RatelessDispatcher`` of 4 workers: encode and
                 LT-coded decode of 64 objects of 1 MiB under random
                 stalls of 1-15 ms (stolen > 0), worker 0 killed
                 mid-batch and re-admitted on probation, every worker
                 killed (the caller's thread finishes), the
                 speculative-buffer ledger back to 0. The wall ms of each
                 leg beside the single-device call's, launches per leg,
                 per-worker completed and stolen counts, and the
                 checksum's digest against ``torch.sum`` (CUDA events);
                 the sharded encode and decode equal the plain version.
  14. placement  the placement control plane on phase 9's 1024-OSD
                 cluster under its reweights, with two pools: pool 1
                 replicated size 3 (chooseleaf firstn over hosts) at
                 32,768 PGs, pool 2 SHEC k=8, m=4 (chooseleaf indep over
                 hosts, 12 slots) at 8,192 PGs with a two-position weight
                 set under choose_args[2]: 40,960 PGs, 196,608 slots, the
                 straw2 kernel counted from 0 just before. (a)
                 ``OSDMapMapping.update``: one straw2 launch and one table
                 upload a pool, a second update one launch a pool and no
                 upload, each pool's raw result equal to the plain version
                 on the card, 256 sampled PGs a pool equal to
                 ``OSDMap.pg_to_up_acting_osds`` (the scalar path), the
                 update over ``make_batch_mesh(devices=["cuda:0"] * 4)``
                 four launches a pool and the same mapping; the wall ms of
                 each pool's seed build, sweep and host overlay loop. (b)
                 an overlay-only incremental (64 pg_temp, 8 primary_temp,
                 64 pg_upmap_items, 8 OSDs down) through
                 ``apply_incremental``: "incremental", no launch, equal to
                 a full update; a weight change then "full", one launch a
                 pool. (c) ``calc_pg_upmaps(max_changes=64,
                 changes_per_sweep=16)`` on the card: one launch a pool a
                 sweep and no upload, every changed PG keeping its replica
                 and failure-domain counts, the largest deviation not
                 rising, the mapping after ``apply_to`` and
                 ``apply_incremental`` equal to a full update; its sweeps,
                 changes, deviations, seconds and launches. (d)
                 ``crushtool -d`` then ``-c`` of the map with its weight
                 set: the same map; ``--test --batched`` over 65,536 seeds
                 of the compiled map equal to the built map's;
                 ``osdmaptool --test-map-pgs --batched``: per-OSD counts
                 summing to 196,608; ``compressor.available()`` of the
                 five algorithms. Then each pool's sweep in parts
                 (compile_map, h2d, kernel by CUDA events, d2h) and
                 its bound.
  15. native     the native seam: (a) the port's build of the C++
                 runtime in ``native/``, after every nvcc build (its
                 seconds where it built, symbols renamed, ``gf_isa()``); (b)
                 ``NativeCodec("jerasure")`` against ``torch_cuda`` on the
                 card at [16, 8, 131072]: the encode and three decode
                 signatures byte-equal, each side's MB/s; (c) 8 threads x
                 16 ``bridge_encode`` calls through
                 ``install_cuda_dispatcher(max_batch=16,
                 max_delay_us=2000)``: every parity equal to
                 NativeCodec's, fewer batches than requests, one GF launch
                 a batch (counted from 0 just before, after an untimed
                 round), each call's latency (mean, p50, p99), the inverse
                 throughput and MB/s, the callback's stages a batch and
                 the queue wait, beside ``GpuDispatcher.encode_async`` at
                 the same load, and a bridge encode raising after
                 ``uninstall_dispatcher``; (d) phase 14's cluster through
                 ``update(native=True)`` (no straw2 launch, both pools
                 "native") equal to ``update()`` on the card, each path's
                 sweep ms and the C mapper's call alone, and ``calc_pg_upmaps(max_changes=16,
                 use_native=True)`` proposing as ``use_device=True``; (e)
                 ``ceph_erasure_code --plugin_exists torch_cuda`` and
                 ``--all``, a ``non_regression --create`` with
                 ``torch_cuda`` on the card passing ``--check`` with the
                 host ``jerasure`` and the other way round, and a
                 corrupted chunk failing ``--check``.
  16. ec_backend the OSD's erasure-coded backend (``osd/ec_backend.py``)
                 in a loopback PG (``tests/torch_ec_loopback.py``: n
                 in-process OSDs, each with its own MemStore, backend and
                 delivery thread), every launch counter 0 just before:
                 (a) RS k=8, m=3 at stripe_unit 4096, 11 OSDs, the
                 primary with a ``GpuDispatcher`` and an ``HbmChunkTier``
                 of 64 objects in fused mode "store": 64 writes of 4 MiB
                 from 8 client threads, every object read from the tier
                 (no sub-read), one shard an object rebuilt from it (and
                 in one ``reconstruct_batch``), a bitrot mark caught by
                 the crc check and repaired, 256 overwrites of 4-64 KiB
                 (RMW through sub-reads and the extent cache), 64
                 appends of 64 KiB, every object and 256 ranges read
                 against a host model, degraded reads with 1, 2 and 3
                 shard OSDs down (2 and 3 checked to decode through the
                 dispatcher), rebuilds with the tier off, and a pool
                 in fused mode "compress" of 16 low-entropy 4 MiB
                 objects (stored compressed, read back); (b) MSR k=8,
                 m=7, 15 OSDs each with a dispatcher: 16 objects of 4
                 MiB, one shard an object rebuilt from the tier (the
                 striped decode on the card) and through 14 helpers'
                 fractions. Every read against the model, every rebuilt
                 shard against its store, every shard store against the
                 plain encode on the CPU; writes/s, RMW p50 and p99,
                 read and degraded-read MB/s, rebuild ms an object, MSR's
                 repair bytes against a full decode's, the dispatcher's
                 ops a dispatch; the GF kernel's bit-sliced and mma
                 designs, the per-lane kernel, K1-K3 and the tier's
                 rebuild must each launch.
  17. pg         the PG (``osd/pg.py``) on loopback daemons
                 (``tests/torch_pg_loopback.py``: each with its own
                 MemStore, FIFO thread and timer, ``home_device`` the card
                 with a ``GpuDispatcher`` and an ``HbmChunkTier`` there),
                 driven through ``do_op``, map epochs, ``scrub_pg`` and
                 ``repair_shard``, every launch counter 0 just before: (a)
                 RS k=8, m=3, 12 OSDs, 8 PGs, fused mode "store": 128
                 writes of 4 MiB from 8 client threads, 256 overwrites of
                 4-64 KiB, 8 snapshot writes, every object and clone and
                 256 ranges read; one OSD down (32 degraded writes, reads
                 on the XOR shortcut), a second down (8 writes, reads
                 decoded through the dispatcher), both up (log recovery),
                 one out (remap); a deep scrub, 32 new writes, bitrot on two
                 shards repaired by a deep scrub (K1 on the card for the
                 resident ones) and a second clean one, four shards
                 rebuilt by ``repair_shard`` from the tier (a GF launch
                 each), then again by the tiers' batched rebuild (the
                 per-lane kernel); a compress
                 pool of 8 low-entropy objects (K3). (b) MSR k=8, m=7, 16
                 OSDs, 2 PGs: 16 objects, a deep-scrub repair and one
                 through helper fractions. Every op 0 and every read
                 against the model, every acting shard store against the
                 plain encode; writes/s, RMW p50 / p99, ms from a map's
                 publication to every PG active, recovery ms an object,
                 backfill MB/s, deep-scrub GB/s and resident share,
                 repair ms a shard.
  18. kernels    one JSON line per the port's kernel table: the design
                 the main path takes, launches on the main path (phases
                 3-4 for the GF bitmatrix kernel, phase 6 for the packet
                 kernel, phase 8 for the write transform's kernels, phase
                 9 for the CRUSH kernel, phase 10 for the tier's two,
                 each counted from 0 just before its path), the GF
                 kernel's launches on phases 6, 8 and 11 as well, the
                 GF, CRUSH and digest kernels' on phase 13
                 (``mesh_launches``), the CRUSH kernel's on phase 14
                 (``remap_launches``) and the GF kernel's on phase 15's
                 bridge (``bridge_launches``), every kernel's on phase
                 16 (``ec_backend_launches``) and on phase 17
                 (``pg_launches``), max_abs_err, ms, plain_ms, bound_ms,
                 bound_by, library_ms.

Then the card's name and power limit as nvidia-smi prints them, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without that line. It needs one CUDA card and the checkout the
script sits in; without either it fails. Every phase line also goes to
``chiprun_out/chip_smoke.jsonl``.
"""

from __future__ import annotations

import itertools
import json
import random
import statistics
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent

BATCH, K, M, W, N = 16, 8, 3, 8, 131072
# phase 11's sizes: (stripes or objects, object bytes) of the reference
# bench's repair leg, the recovery batch and k=10 past 512 columns
MSR_BENCH, MSR_RECOVERY, MSR_SPLIT = (8, 1 << 20), (64, 4 << 20), (16, 1 << 20)
PROFILE = {"technique": "reed_sol_van", "k": str(K), "m": str(M), "w": str(W)}
# phase 14's pools: pg_num of pool 1 (replicated, size 3) and pool 2 (EC,
# 12 slots); 40,960 PGs and 196,608 slots
PLACEMENT_PGS = (32768, 8192)
# phase 16's sizes: the OSD's default 4 MiB object, whole writes (the
# tier's default 64), overwrites and their length range, appends, range
# reads, the compress pool's and the MSR pool's objects
EC_BACKEND = {"object_bytes": 4 << 20, "writes": 64, "overwrites": 256,
              "overwrite_bytes": (4096, 65536), "appends": 64,
              "append_bytes": 65536, "ranges": 256, "compress": 16,
              "msr": 16}

# phase 17's sizes: (a) 12 OSDs and 8 PGs of RS k=8, m=3 at the OSD's
# default 4 MiB object: whole writes, overwrites and their length range,
# snapshot writes, range reads, degraded writes, the OSDs marked down,
# down too and out, the post-remap writes, the compress pool's objects;
# (b) 16 OSDs and 2 PGs of MSR k=8, m=7, its objects
PG_PHASE = {"object_bytes": 4 << 20, "osds": 12, "pg_num": 8,
            "writes": 128, "overwrites": 256,
            "overwrite_bytes": (4096, 65536), "snaps": 8, "ranges": 256,
            "degraded_writes": 32, "down": 1, "down2": 2, "out": 5,
            "rewrites": 32, "compress": 8, "msr_osds": 16,
            "msr_pg_num": 2, "msr": 16}

_records: list[dict] = []


def emit(phase: str, **fields) -> None:
    rec = {"phase": phase, **fields}
    _records.append(rec)
    print(json.dumps(rec), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError("check failed: " + what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi answered")
    return out.stdout.strip().splitlines()[0]


def crush_phase(np, torch, dev, smi):
    """Phase 9: the batched CRUSH sweep (``crush.batched.batched_do_rule``
    and ``tools/crushtool.py --test --batched``) on the bench's map and on
    the 1024-OSD cluster. Returns the kernel's line."""
    from ceph_tpu_torch.crush import batched, mapper_ref
    from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE
    from ceph_tpu_torch.ops import crush_kernel
    from ceph_tpu_torch.tools import crushtool
    from ceph_tpu_torch.tools.crush_tier_turns import crush_cases, sm_clocks
    from ceph_tpu_torch.utils.cuda_timing import crush_bound, time_ms

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    map_path = out_dir / "crush_cluster_1024.json"
    layers = ["host", "straw2", "16", "rack", "straw2", "8",
              "root", "straw2", "0"]
    check(crushtool.main(["--build", "--num-osds", "1024", "-o",
                          str(map_path), *layers]) == 0, "crushtool --build")
    cluster = crushtool.map_from_json(json.loads(map_path.read_text()))
    check(len(cluster.buckets) == 73, "73 buckets")
    # the bench's map; the cluster's EC rule (indep 12) and replicated
    # rule (firstn 3) under a rebalance's reweights, and its copy with a
    # two-position weight set (the balancer's path)
    cases = crush_cases(np, cluster)
    ec = cases[1][2]
    map_path.write_text(json.dumps(crushtool.map_to_json(cluster)))
    seeds = {n: np.arange(n, dtype=np.int64) for n in (8192, 65536, 1 << 20)}

    # the main path: each case once, host seeds to host results, from
    # cold tables; the counts are zeroed just before and read just after
    crush_kernel.clear_tables()
    batched.reset_paths()
    crush_kernel.reset_launches()
    results, e2e_first = {}, {}
    for name, m, rule, rmax, rw, args, n in cases:
        t0 = time.perf_counter()
        results[name] = batched.batched_do_rule(m, rule, seeds[n], rmax, rw,
                                                choose_args=args)
        e2e_first[name] = (time.perf_counter() - t0) * 1e3
    paths = batched.paths()
    launches = crush_kernel.LAUNCHES
    by_design = crush_kernel.launches_by_design()
    emit("crush", case="main_path", paths=paths, launches=launches,
         launches_by_design=by_design, end_to_end_first_ms=e2e_first)
    check(paths == {"kernel": len(cases), "plain": 0, "scalar": 0},
          "every sweep took the kernel, none the scalar path")
    check(launches == len(cases) and by_design["shared"] == len(cases),
          "one launch a sweep, tables in shared memory")

    worst, records = 0, {}
    for name, m, rule, rmax, rw, args, n in cases:
        cargs = m.choose_args_get_with_fallback(args) \
            if args is not None else None
        xs = seeds[n]
        t0 = time.perf_counter()
        cm = batched.compile_map(m, cargs)
        compile_ms = (time.perf_counter() - t0) * 1e3
        plan = batched.plan_rule(m, rule, rmax)
        wvec = batched.reweight_vector(rw, cm.max_devices)
        wdev = torch.from_numpy(wvec).to(dev)
        # the split of one end-to-end call: upload (cold), h2d, kernel, d2h
        crush_kernel.clear_tables()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        crush_kernel.device_tables(cm, wvec, dev)
        torch.cuda.synchronize()
        upload_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        xs_dev = torch.from_numpy(xs).to(dev)
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t0) * 1e3
        out = crush_kernel.crush_sweep(cm, plan, xs_dev, wvec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = out.cpu().numpy()
        d2h_ms = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(host, results[name]),
              "%s: the main path's result is the kernel's" % name)
        e2e = []
        for _ in range(3):
            t0 = time.perf_counter()
            batched.batched_do_rule(m, rule, xs, rmax, rw, choose_args=args)
            e2e.append((time.perf_counter() - t0) * 1e3)
        reps = 20 if n <= 65536 else 5
        ms = time_ms(lambda x: crush_kernel.crush_sweep(cm, plan, x, wvec),
                     [xs_dev], reps)
        # every seed against the plain version on the card (chunked)
        t0 = time.perf_counter()
        plain = batched.map_plain(cm, plan, xs_dev, wdev)
        torch.cuda.synchronize()
        plain_all_s = time.perf_counter() - t0
        bad = int((plain != out).any(dim=1).sum())
        err = int((plain - out).abs().max()) if bad else 0
        worst = max(worst, err)
        check(bad == 0, "%s: kernel equals plain on every seed" % name)
        x65 = xs_dev[:65536]
        plain_ms = time_ms(lambda x: batched.map_plain(cm, plan, x, wdev),
                           [x65], 2)
        # 256 sampled seeds against the scalar mapper on the host
        sample = np.random.default_rng(n).choice(n, 256, replace=False)
        for i in sample:
            ref = mapper_ref.crush_do_rule(m, rule, int(xs[i]), rmax,
                                           list(rw), choose_args=cargs)
            ref = ref + [CRUSH_ITEM_NONE] * (rmax - len(ref))
            check(list(host[i]) == ref,
                  "%s: seed %d equals the scalar mapper" % (name, xs[i]))
        work = torch.zeros((n, 2), dtype=torch.int32, device=dev)
        crush_kernel.crush_sweep(cm, plan, xs_dev, wvec, work=work)
        bound_ms, bound_by = crush_bound(work, rmax)
        draws = work.to(torch.int64).sum(dim=0).tolist()
        placed = host != CRUSH_ITEM_NONE
        # the clock split of a profiled launch: per warp its cycles, the
        # draw steps it issued and the lanes active at them
        clk = torch.zeros((crush_kernel.clock_rows(cm, plan, wvec.size, n),
                           4), dtype=torch.int64, device=dev)
        check(torch.equal(crush_kernel.crush_sweep(cm, plan, xs_dev, wvec,
                                                   clocks=clk), out),
              "%s: a profiled sweep maps as a plain one" % name)
        c = clk[clk[:, 0] > 0].double()
        steps, lanes = float(c[:, 1].sum()), float(c[:, 2].sum())
        check(int(lanes) == draws[0], "%s: the lanes at draw steps are "
              "the draws counted" % name)
        split = dict(warps=int(c.shape[0]), draw_steps=steps,
                     cycles_per_draw_step=float(c[:, 0].sum()) / steps,
                     active_lane_share=lanes / (32 * steps),
                     warp_cycles_mean=float(c[:, 0].mean()),
                     warp_cycles_max=float(c[:, 0].max()),
                     sms_used=int(c[:, 3].unique().numel()))
        if name == "cluster_ec_1048576":
            mhz = sm_clocks(lambda: crush_kernel.crush_sweep(
                cm, plan, xs_dev, wvec), 2.0)
            check(bool(mhz), "nvidia-smi read the SM clock")
            split["sm_clock_mhz"] = [min(mhz), max(mhz)]
        records[name] = rec = dict(
            seeds=n, result_max=rmax, rule="indep" if not plan.firstn
            else "firstn", design=crush_kernel.kernel_design(
                cm, plan, wvec.size), group=crush_kernel.kernel_group(
                cm, plan, wvec.size, n), clock_split=split,
            ms=ms, pgs_per_s=n / ms * 1e3,
            plain_ms=plain_ms, plain_seeds=int(x65.shape[0]),
            plain_all_s=plain_all_s, bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms, draws=draws[0],
            is_out_hashes=draws[1], draws_per_seed=draws[0] / n,
            compile_map_ms=compile_ms, upload_ms=upload_ms, h2d_ms=h2d_ms,
            d2h_ms=d2h_ms, end_to_end_ms=e2e,
            end_to_end_first_ms=e2e_first[name],
            table_bytes=int(crush_kernel.pack_tables(cm, wvec).nbytes),
            mismatched_seeds=bad, max_abs_err=err, holes=int((~placed).sum()))
        emit("crush", case=name, **rec)

    # crushtool --test --batched on the cluster at 8,192 PGs, and its
    # per-device counts against the scalar run on a sample of 512
    import contextlib
    import io

    def tool(*extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = crushtool.main(["-i", str(map_path), "--test", "--rule",
                                 str(ec), "--num-rep", "12",
                                 "--show-utilization", *extra])
        check(rc == 0, "crushtool --test %s" % " ".join(extra))
        return buf.getvalue()

    t0 = time.perf_counter()
    report = tool("--batched", "--min-x", "0", "--max-x", "8191")
    tool_s = time.perf_counter() - t0
    sample_b = tool("--batched", "--min-x", "0", "--max-x", "511")
    sample_s = tool("--min-x", "0", "--max-x", "511")
    check(sample_b == sample_s, "crushtool: batched and scalar reports "
          "equal on 512 PGs")
    (out_dir / "crushtool_test_8192.txt").write_text(report)
    emit("crush", case="crushtool_test_batched", pgs=8192, seconds=tool_s,
         summary=report.strip().splitlines()[-2:],
         devices_listed=report.count("device "),
         scalar_sample_equal=sample_b == sample_s)

    head = records["bench_65536"]
    return {
        "name": "crush_straw2", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_straw2.cu",
        "replaces": "ceph_tpu/crush/batched.py:128",
        "design": head["design"], "group": head["group"],
        "launches": launches,
        "launches_by_design": by_design, "matched": worst == 0,
        "max_abs_err": worst, "ms": head["ms"], "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None,
        "share_of_bound": head["share_of_bound"], "case": "bench_65536",
        "gpu": smi,
        "other_cases": {n: {f: r[f] for f in (
            "seeds", "group", "ms", "pgs_per_s", "plain_ms", "bound_ms",
            "bound_by")}
            for n, r in records.items() if n != "bench_65536"}}


def hbm_tier_phase(np, torch, dev, smi):
    """Phase 10: the device chunk tier (``osd/hbm_tier.py``) fed by the
    dispatcher's writes, its deep scrub (the chunk digest kernel) and its
    batched rebuild (the per-lane GF kernel), at (a) the reference
    bench's resident pipeline, (b) the OSD's write path of 4 MiB objects
    and (c) a tier of 1024 objects of 4 MiB. Returns the two kernels'
    lines."""
    from ceph_tpu_torch import registry
    from ceph_tpu_torch.ops import digest_kernel as dk
    from ceph_tpu_torch.ops import gf_kernel, gf_ref
    from ceph_tpu_torch.ops.row_table import row_table
    from ceph_tpu_torch.osd import fused_transform as ft
    from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher
    from ceph_tpu_torch.osd.hbm_tier import HbmChunkTier, host_digest
    from ceph_tpu_torch.tools.crush_tier_turns import TIER_A, TIER_B, TIER_C
    from ceph_tpu_torch.utils.cuda_timing import (digest_bound,
                                                  gf_multi_bound, time_ms)

    codec = registry.factory("torch_cuda", dict(PROFILE))
    nn = K + M
    rng = np.random.default_rng(20261017)

    def n_launched():
        return {"chunk_digest": dk.cuda_launches(),
                "gf_bitmatrix_multi": sum(
                    gf_kernel.launches_by_design(multi=True).values()),
                "gf_bitmatrix": sum(gf_kernel.launches_by_design().values())}

    def per_call(fn):
        """fn()'s result, its wall seconds to a synchronise, and the CUDA
        launches of each kernel it made (counted from before the call)."""
        torch.cuda.synchronize()
        before = n_launched()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, wall, {k_: v - before[k_]
                           for k_, v in n_launched().items()}

    def u32(t):
        return t.view(torch.int32).cpu().numpy().view(np.uint32)

    def digest_err(s, ws, ps, pws):
        """The largest difference of two digest pairs, as uint32 values."""
        def val(t):
            return t.reshape(-1).view(torch.int32).long() & 0xFFFFFFFF
        return int(max((val(s) - val(ps)).abs().max(),
                       (val(ws) - val(pws)).abs().max()))

    # the main path, driven with every count at 0 just before and read
    # just after; timing and the plain versions come after it
    dk.reset_launches()
    gf_kernel.reset_launches()

    # (a) the reference bench's resident pipeline (bench.py:915-935): RS
    # k=8, m=3, 3 rounds of 16 objects of 1 MiB, each round one put_encode
    rounds, nobjs, obj_a = TIER_A
    n_a = codec.get_chunk_size(obj_a)
    batches = [rng.integers(0, 256, (nobjs, K, n_a), dtype=np.uint8)
               for _ in range(rounds)]
    names_a = [["o%d-%d" % (r, i) for i in range(nobjs)]
               for r in range(rounds)]
    all_a = [nm for row in names_a for nm in row]
    lost_a = [(i + r) % nn for r in range(rounds) for i in range(nobjs)]
    runs_a = {}
    for scrubs in (0, 1, 3, 9):     # 0: the warm-up, as bench.py runs one
        def pipeline():
            tier = HbmChunkTier(codec, capacity_objects=rounds * nobjs + 1)
            for r in range(rounds):
                tier.put_encode(names_a[r], batches[r])   # the one h2d
            for _ in range(max(scrubs, 1)):
                s, ws = tier.deep_scrub(all_a, device_out=True)
            shards = tier.reconstruct_batch(all_a, lost_a)
            return (tier, tier.finalize_digests(all_a, s, ws),
                    shards.cpu().numpy())
        (tier_a, digs, shards), wall, calls = per_call(pipeline)
        runs_a[scrubs or "warm-up"] = dict(
            seconds=wall, launches=calls,
            MBps=rounds * nobjs * obj_a / wall / 1e6)
        check(calls["chunk_digest"] == max(scrubs, 1) and
              calls["gf_bitmatrix_multi"] == 1,
              "(a): one digest launch a scrub, one rebuild launch")
        check(tier_a.uploads() == (rounds, sum(b.nbytes for b in batches)),
              "(a): one upload per put_encode")
        if scrubs == 0:
            full_a = {nm: tier_a.get(nm).cpu().numpy() for nm in all_a}
            digs_a = digs
            for r in range(rounds):
                for i, nm in enumerate(names_a[r]):
                    check(np.array_equal(full_a[nm][:K], batches[r][i]),
                          "(a): resident data rows equal the host bytes")
            ref0 = gf_ref.matrix_encode_ref(codec.coding, batches[0][0], W)
            check(np.array_equal(full_a[all_a[0]][K:], ref0),
                  "(a): parity equals gf_ref")
        for nm in all_a:
            check(np.array_equal(digs[nm], host_digest(full_a[nm]))
                  if scrubs == 0 else np.array_equal(digs[nm], digs_a[nm]),
                  "(a): digest of %s equals host_digest" % nm)
        for i, nm in enumerate(all_a):
            check(np.array_equal(shards[i], full_a[nm][lost_a[i]]),
                  "(a): rebuilt shard of %s equals the original" % nm)
    emit("hbm_tier", case="a_bench_resident_pipeline",
         objects=[rounds, nobjs, K, n_a], pipelines=runs_a)

    # (b) the OSD's write path into the tier: 4 MiB objects at stripe_unit
    # 4096 ([128, 8, 4096]), 64 writes from 8 threads through
    # fused_write_async(resident=), one in four compress-mode on
    # low-entropy bytes, into a tier of the default 64 objects
    WS, WC, threads, per_thread = TIER_B
    nw = threads * per_thread
    objs = [rng.integers(0, 4 if i % 4 == 0 else 256, (WS, K, WC),
                         dtype=np.uint8) for i in range(nw + 1)]
    modes = ["compress" if i % 4 == 0 else "store" for i in range(nw + 1)]
    keys = [("pg%d" % (i % 8), "obj%d" % i) for i in range(nw + 1)]
    tier_b = HbmChunkTier(codec)
    check(tier_b.capacity == 64, "(b): the default capacity")
    results: list = [None] * (nw + 1)
    errors: list = []

    def write_all(disp, resident):
        def writer(t):
            try:
                for j in range(per_thread):
                    i = t * per_thread + j
                    fut = disp.fused_write_async(
                        codec, objs[i], mode=modes[i],
                        resident=(tier_b, keys[i]) if resident else None)
                    results[i] = ft.result_from_host(fut.result(300), WS, K,
                                                     WC, modes[i])
            except Exception as e:  # reported below; the run then fails
                errors.append(repr(e))
        pool = [threading.Thread(target=writer, args=(t,))
                for t in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(600)
        check(not any(t.is_alive() for t in pool) and not errors,
              "(b): every write returned: %s" % errors[:3])

    disp = GpuDispatcher()
    (_, wall_b, calls_b) = per_call(lambda: write_all(disp, True))
    staged = disp.perf.dump()
    disp.shutdown()
    check(tier_b.uploads() == (0, 0),
          "(b): adoption moved no chunk byte from the host")
    check(staged["l_gpu_adopted"] == nw and
          all(tier_b.resident(k_) for k_ in keys[:nw]),
          "(b): every object resident")
    want_b, shard_maps = {}, {}
    for i in range(nw):
        r = results[i]
        check(r.compressed == (modes[i] == "compress"),
              "(b): one write in four stored compressed")
        rows = r.stored if r.stored is not None else objs[i]
        want = np.concatenate([rows, r.parity], 1).transpose(1, 0, 2) \
            .reshape(nn, -1)
        want_b[keys[i]] = want
        check(np.array_equal(tier_b.get(keys[i]).cpu().numpy(), want),
              "(b): the resident copy is what landed on disk")
        crcs = [zlib.crc32(want[j].tobytes()) for j in range(nn)]
        check(list(tier_b.shard_digests(keys[i])) == r.shard_crcs == crcs,
              "(b): shard_digests equal the write's crcs and zlib")
    scrub_b, _, scrub_calls = per_call(lambda: tier_b.deep_scrub(keys[:nw]))
    check(scrub_calls["chunk_digest"] == 2,
          "(b): one digest launch per chunk shape (store, compressed)")
    for k_ in keys[:nw]:
        check(np.array_equal(scrub_b[k_], host_digest(want_b[k_])),
              "(b): deep_scrub equals host_digest of the shard streams")
    for i in (1, 2, 4, 8):
        for lost in ((i % nn,), (1, 9)):
            got = tier_b.reconstruct(keys[i], lost).cpu().numpy()
            check(np.array_equal(got, want_b[keys[i]][list(lost)]),
                  "(b): reconstruct %s of %s" % (lost, keys[i]))
    groups = {"store": [i for i in range(nw) if modes[i] == "store"],
              "compress": [i for i in range(nw) if modes[i] == "compress"]}
    rebuild_calls = {}
    for g, idx in groups.items():
        lost = [i % nn for i in idx]
        got, _, rebuild_calls[g] = per_call(lambda: tier_b.reconstruct_batch(
            [keys[i] for i in idx], lost))
        check(rebuild_calls[g]["gf_bitmatrix_multi"] == 1,
              "(b): one rebuild launch for the %s objects" % g)
        for j, i in enumerate(idx):
            check(np.array_equal(got[j].cpu().numpy(),
                                 want_b[keys[i]][lost[j]]),
                  "(b): reconstruct_batch of %s" % (keys[i],))
    for k_ in keys[:nw]:               # key 0 becomes the least recent
        tier_b.get(k_)
    disp = GpuDispatcher()
    results[nw] = ft.result_from_host(disp.fused_write_async(
        codec, objs[nw], mode=modes[nw],
        resident=(tier_b, keys[nw])).result(300), WS, K, WC, modes[nw])
    disp.shutdown()
    st = tier_b.stats()
    check(not tier_b.resident(keys[0]) and tier_b.resident(keys[nw]) and
          st["evictions"] == 1 and st["resident_objects"] == 64,
          "(b): the 65th write evicts the least recently used object")
    # the same 64 writes without resident=: the dispatcher stages the
    # same bytes
    disp = GpuDispatcher()
    write_all(disp, False)
    plain_staged = disp.perf.dump()["l_gpu_h2d_bytes"]
    disp.shutdown()
    check(staged["l_gpu_h2d_bytes"] == plain_staged == nw * WS * K * WC,
          "(b): the dispatcher stages the same bytes with resident=")
    emit("hbm_tier", case="b_osd_write_path", objects=nw + 1,
         shape=[WS, K, WC], threads=threads, wall_s=wall_b,
         writes_per_s=nw / wall_b, launches=calls_b,
         staged_bytes=staged["l_gpu_h2d_bytes"],
         staged_bytes_without_resident=plain_staged,
         tier_uploads=tier_b.uploads(), stats=st,
         deep_scrub_launches=scrub_calls,
         reconstruct_batch_launches=rebuild_calls,
         compressed_chunk=int(tier_b.get(keys[4]).shape[1]))
    del objs, results

    # (c) a tier at an OSD's size: 1024 objects of 4 MiB through
    # put_encode in batches of 16 ([16, 8, 524288]), capacity 1024
    nc, per, obj_c = TIER_C
    n_c = codec.get_chunk_size(obj_c)
    tier_c = HbmChunkTier(codec, capacity_objects=nc)
    names_c = ["c%d" % i for i in range(nc)]
    sampled = {b * per + (b * 5) % per: None for b in range(0, nc // per, 2)}
    t0 = time.perf_counter()
    for b in range(nc // per):
        data = np.frombuffer(rng.bytes(per * K * n_c), np.uint8).reshape(
            per, K, n_c)
        for i in range(b * per, (b + 1) * per):
            if i in sampled:
                sampled[i] = data[i - b * per].copy()
        tier_c.put_encode(names_c[b * per:(b + 1) * per], data)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    st_c = tier_c.stats()
    check(st_c["resident_objects"] == nc and
          st_c["resident_bytes"] == nc * nn * n_c,
          "(c): 1024 objects resident")
    (s_c, ws_c), scrub_wall_c, scrub_calls_c = per_call(
        lambda: tier_c.deep_scrub(names_c, device_out=True))
    check(scrub_calls_c["chunk_digest"] == 1,
          "(c): one digest launch for the whole tier")
    lost_c = [(i * 7) % nn for i in range(nc)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_c = torch.cuda.memory_allocated()
    out_c, rebuild_wall_c, rebuild_calls_c = per_call(
        lambda: tier_c.reconstruct_batch(names_c, lost_c))
    rebuild_peak_c = torch.cuda.max_memory_allocated() - before_c
    check(rebuild_calls_c["gf_bitmatrix_multi"] == 1,
          "(c): one rebuild launch for 1024 lost shards")
    check(rebuild_peak_c < 2 * out_c.numel(),
          "(c): the rebuild allocates its result and no survivors' copy")
    main = n_launched()
    check(main["chunk_digest"] > 0 and main["gf_bitmatrix_multi"] > 0,
          "the tier's path launched both kernels")

    # (c), checked: every digest against the plain version on the card,
    # every rebuilt shard against the resident original, 32 sampled
    # against the original host bytes
    worst_digest = worst_multi = 0
    for b in range(nc // per):
        stack = torch.stack([tier_c.get(nm) for nm in
                             names_c[b * per:(b + 1) * per]])
        ps, pws = dk.chunk_digest_plain(stack)
        worst_digest = max(worst_digest, digest_err(
            s_c[b * per:(b + 1) * per], ws_c[b * per:(b + 1) * per], ps, pws))
        for j in range(per):
            i = b * per + j
            check(torch.equal(out_c[i], stack[j, lost_c[i]]),
                  "(c): rebuilt shard of %s equals the resident original"
                  % names_c[i])
        del stack
    check(worst_digest == 0, "(c): every digest equals the plain version")
    for i, data in sampled.items():
        want = data[lost_c[i]] if lost_c[i] < K else \
            tier_c.get(names_c[i])[lost_c[i]].cpu().numpy()
        check(np.array_equal(out_c[i].cpu().numpy(), want),
              "(c): sampled %s equals the original bytes" % names_c[i])
    emit("hbm_tier", case="c_osd_tier", objects=nc, chunk=n_c,
         resident_bytes=st_c["resident_bytes"], fill_s=fill_s,
         fill_MBps=nc * K * n_c / fill_s / 1e6,
         deep_scrub_wall_ms=scrub_wall_c * 1e3,
         deep_scrub_launches=scrub_calls_c,
         reconstruct_batch_wall_ms=rebuild_wall_c * 1e3,
         reconstruct_batch_launches=rebuild_calls_c,
         reconstruct_batch_peak_bytes_above=rebuild_peak_c,
         memory_allocated=torch.cuda.memory_allocated(),
         sampled=len(sampled))

    # the kernels alone on each part's inputs: CUDA events, inputs past
    # or rotated out of L2, the plain versions on the same inputs
    parts = {}

    def digest_case(name, tier, names, n):
        # the launch alone, over the row table deep_scrub builds (an
        # internal of the wrapper, reached here to time it apart)
        objs_ = [tier.get(nm) for nm in names]
        table = row_table(objs_)
        (s, ws), _, calls = per_call(lambda: dk._rows_digest(*table))
        check(calls["chunk_digest"] == 1,
              "digest %s: one launch a call" % name)
        stack = torch.stack(objs_)
        ps, pws = dk.chunk_digest_plain(stack)
        err = digest_err(s, ws, ps, pws)
        ms = time_ms(lambda _: dk._rows_digest(*table), [None], 20)
        plain_ms = time_ms(lambda x: dk.chunk_digest_plain(x), [stack], 2)
        bound_ms, bound_by = digest_bound(stack.numel(), len(names) * nn)
        parts["digest_" + name] = rec = dict(
            rows=len(names) * nn, n=n, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
            share_of_bound=bound_ms / ms,
            launches_per_call=calls["chunk_digest"])
        emit("hbm_tier", case="digest_" + name, **rec)
        return err

    def multi_case(name, tier, names, lost, lanes_per_plain=None):
        # reconstruct_batch in its two parts: the operands (the lanes'
        # bitmatrices and the table of the survivors' addresses, internals
        # of the tier and the wrapper reached here to time them apart),
        # then the kernel alone over the table
        def operands():
            bm_, parts_, rows_, w_ = tier._rebuild_operands(names, lost)
            return bm_, parts_, rows_, w_, row_table(parts_, rows_)
        (bm, parts_, rows_, w, (table, n, bad)), operands_wall, _ = \
            per_call(operands)
        check(bad is None, "per-lane product %s: rows on 16 bytes" % name)
        operands_ms = time_ms(lambda _: operands(), [None], 3)
        out, _, calls = per_call(
            lambda: gf_kernel._multi_rows(bm, table, n, w))
        check(calls["gf_bitmatrix_multi"] == 1,
              "per-lane product %s: one launch a call" % name)
        lanes, k_ = len(names), bm.shape[2] // w
        flat = [(t, int(r)) for t, rs in zip(parts_, rows_) for r in rs]
        step = lanes_per_plain or lanes

        def plain(_):
            outs = []
            for p in range(0, lanes, step):
                rows_p = flat[p * k_:(p + step) * k_]
                data_p = torch.stack([t.reshape(-1, n)[r]
                                      for t, r in rows_p])
                outs.append(gf_kernel.matrix_encode_multi_plain(
                    bm[p:p + step], data_p.view(-1, 1, k_, n), w)[:, 0])
            return torch.cat(outs)
        ref = plain(None)
        err = int((out.to(torch.int16) - ref.to(torch.int16)).abs().max())
        del ref
        # small parts: tables over copies of the batches as well, rotated
        # so that a launch's rows are out of L2 when it reads them again
        tables, copies = [table], []      # copies: kept alive while timed
        if sum(t.numel() for t in {id(t): t for t in parts_}.values()) \
                <= (64 << 20):
            for _ in range(2):
                copies.append({id(t): t.clone() for t in parts_})
                tables.append(row_table([copies[-1][id(t)] for t in parts_],
                                        rows_)[0])
        ms = time_ms(lambda tb: gf_kernel._multi_rows(bm, tb, n, w), tables,
                     20)
        plain_ms = time_ms(plain, [None], 1)
        bound_ms, bound_by = gf_multi_bound(
            bm, torch.empty((lanes, 1, k_, n), device="meta"), out, w)
        # the whole rebuild: device time, and its peak memory above what
        # was allocated before it
        rebuild_ms = time_ms(lambda _: tier.reconstruct_batch(names, lost),
                             [None], 3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        again = tier.reconstruct_batch(names, lost)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        check(torch.equal(again, out.view(lanes, -1)),
              "per-lane product %s: reconstruct_batch is the kernel's"
              % name)
        del again
        parts[name] = rec = dict(lanes=lanes, n=n, bitmats=list(bm.shape),
                                 ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 max_abs_err=err,
                                 share_of_bound=bound_ms / ms,
                                 design=gf_kernel.kernel_design(
                                     bm.shape[1], K, w, dev),
                                 launches_per_call=calls[
                                     "gf_bitmatrix_multi"],
                                 operands_ms=operands_ms,
                                 operands_wall_ms=operands_wall * 1e3,
                                 upload_batches=len({id(t) for t in parts_}),
                                 rebuild_ms=rebuild_ms,
                                 rebuild_peak_bytes_above=peak)
        emit("hbm_tier", case="multi_" + name, **rec)
        return err

    worst_digest = max(worst_digest,
                       digest_case("a_bench", tier_a, all_a, n_a),
                       digest_case("b_store", tier_b,
                                   [keys[i] for i in groups["store"]],
                                   WS * WC),
                       digest_case("c_osd_tier", tier_c, names_c, n_c))
    worst_multi = max(worst_multi,
                      multi_case("a_bench", tier_a, all_a, lost_a),
                      multi_case("b_store", tier_b,
                                 [keys[i] for i in groups["store"]],
                                 [i % nn for i in groups["store"]]),
                      multi_case("c_osd_tier", tier_c, names_c, lost_c, 32))
    check(worst_digest == 0 and worst_multi == 0,
          "both kernels equal their plain versions on the card")
    # the digest on one contiguous batch array beside torch.sum, the sum
    # half's library yardstick, on the same bytes
    arrays = [torch.stack([tier_c.get(nm) for nm in
                           names_c[b * per:(b + 1) * per]]) for b in range(3)]
    one = dict(shape=list(arrays[0].shape),
               ms=time_ms(dk.chunk_digest, arrays, 20),
               plain_ms=time_ms(dk.chunk_digest_plain, arrays[:1], 2),
               library_ms=time_ms(lambda x: torch.sum(
                   x, dim=-1, dtype=torch.int64), arrays, 20))
    one["bound_ms"], one["bound_by"] = digest_bound(arrays[0].numel(),
                                                    per * nn)
    ps, pws = dk.chunk_digest_plain(arrays[0])
    s1, ws1 = dk.chunk_digest(arrays[0])
    one["max_abs_err"] = digest_err(s1, ws1, ps, pws)
    check(one["max_abs_err"] == 0, "the digest of one batch array")
    emit("hbm_tier", case="digest_one_batch_array", **one)
    del arrays, tier_c, out_c, s_c, ws_c
    torch.cuda.empty_cache()

    multi = parts["c_osd_tier"]
    lines = [{
        "name": "gf_bitmatrix_multi", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_bitmatrix.cu",
        "replaces": "ceph_tpu/ops/xor_mm.py:91",
        "design": multi["design"], "launches": main["gf_bitmatrix_multi"],
        "matched": worst_multi == 0, "max_abs_err": worst_multi,
        "ms": multi["ms"], "kernel_ms": multi["ms"],
        "plain_ms": multi["plain_ms"], "bound_ms": multi["bound_ms"],
        "bound_by": multi["bound_by"], "library_ms": None,
        "share_of_bound": multi["share_of_bound"],
        "case": "c_osd_tier_%d_lanes" % nc, "gpu": smi,
        "other_cases": {n_: parts[n_] for n_ in ("a_bench", "b_store")}}, {
        "name": "chunk_digest", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/hbm_digest.cu",
        "replaces": "ceph_tpu/osd/hbm_tier.py:60",
        "launches": main["chunk_digest"],
        "matched": worst_digest == 0 and one["max_abs_err"] == 0,
        "max_abs_err": max(worst_digest, one["max_abs_err"]),
        "ms": one["ms"], "kernel_ms": one["ms"],
        "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"],
        "bound_by": one["bound_by"], "library_ms": one["library_ms"],
        "library_call": "torch.sum(x, dim=-1, dtype=torch.int64)",
        "share_of_bound": one["bound_ms"] / one["ms"],
        "case": "one_batch_array_%s" % "x".join(map(str, one["shape"])),
        "gpu": smi,
        "other_cases": {n_: parts["digest_" + n_] for n_ in (
            "a_bench", "b_store", "c_osd_tier")}}]
    return lines

def msr_repair_phase(np, torch, dev, smi):
    """Phase 11: the product-matrix MSR code (``models/msr.py``) on the
    card, through ``registry.factory("msr_cuda", ...)``: (a) the reference
    bench's repair leg at its own size (bench.py:1845-1920), (b) a
    recovery batch of 64 objects of 4 MiB through the dispatcher, ec_util
    and decode_batch, (c) k=10, m=9 past 512 columns; then each of the
    four k=8 matrices alone. Every GF kernel launch of the phase is
    counted by design, from 0 just before it. Returns the phase's part of
    the GF kernel's line."""
    from ceph_tpu_torch import registry
    from ceph_tpu_torch.ops import gf_kernel, xor_mm
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher
    from ceph_tpu_torch.utils.cuda_timing import gf_bound, time_ms

    rng = np.random.default_rng(20261018)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def per_call(fn):
        """fn()'s result, its wall seconds to a synchronise and the GF
        kernel's launches by design it made."""
        torch.cuda.synchronize()
        before = gf_kernel.launches_by_design()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = gf_kernel.launches_by_design()
        return out, wall, {d: after[d] - before[d] for d in after}

    def one_launch(calls, design, what):
        check(calls[design] == 1 and sum(calls.values()) == 1,
              "%s is one %s launch (%s)" % (what, design, calls))

    gf_kernel.reset_launches()
    msr = registry.factory("msr_cuda", {"technique": "msr", "k": "8",
                                        "m": "7", "w": "8"})
    rs = registry.factory("torch_cuda", dict(PROFILE))
    check(msr.device.type == "cuda" and msr.supports_repair(),
          "msr_cuda on the card by default, with fraction repair")
    k, m, alpha, d = msr.k, msr.m, msr.alpha, msr.repair_helper_count()
    n = k + m
    calls_by = {}

    # (a) the reference bench's repair leg: 8 stripes of 1 MiB objects
    stripes, obj = MSR_BENCH
    chunk = msr.get_chunk_size(obj)
    chunk_rs = rs.get_chunk_size(obj)
    sub = msr.repair_sub_size(chunk)
    ratio = (d * sub / obj) / (rs.k * chunk_rs / obj)
    data = rng.integers(0, 256, (stripes, k, chunk), dtype=np.uint8)
    parity, _, calls = per_call(lambda: msr.encode_batch(on_dev(data)))
    one_launch(calls, "mma", "the k=8 encode")
    calls_by["encode"] = calls
    full_a = np.concatenate([data, parity.cpu().numpy()], axis=1)
    rows = {msr.chunk_index(i): full_a[:, i] for i in range(n)}
    target = msr.chunk_index(2)
    helpers = tuple(sorted(msr.minimum_to_repair(target,
                                                 set(rows) - {target})))

    def repair_leg():
        fr = [msr.repair_fraction_batch(target, on_dev(rows[h]))
              for h in helpers]
        return msr.repair_combine_batch(target, helpers,
                                        torch.stack(fr, dim=1))

    rebuilt, _, calls = per_call(repair_leg)
    check(calls == {"bitsliced": d + 1, "mma": 0, "popcount": 0},
          "a repair is d fraction launches and one combine (%s)" % calls)
    calls_by["repair_leg"] = calls
    rebuilt = rebuilt.cpu().numpy()
    for st in range(stripes):
        check(np.array_equal(rebuilt[st], msr.repair_oracle(
            target, helpers, {h: rows[h][st] for h in helpers})),
            "(a): stripe %d equals repair_oracle" % st)
    check(np.array_equal(rebuilt, rows[target]),
          "(a): the rebuilt chunk equals the original")
    check(ratio < 1.0, "traffic ratio %.4f < 1" % ratio)
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        repair_leg()
    torch.cuda.synchronize()
    repair_s = time.perf_counter() - t0
    rs_data = rng.integers(0, 256, (stripes, rs.k, chunk_rs), dtype=np.uint8)
    avail = tuple(range(rs.k))
    rs.decode_batch(avail, on_dev(rs_data))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        rs.decode_batch(avail, on_dev(rs_data))
    torch.cuda.synchronize()
    rs_s = time.perf_counter() - t0
    emit("msr_repair", case="a_bench_repair_leg",
         msr={"k": k, "m": m, "alpha": alpha, "d": d, "chunk_bytes": chunk,
              "fraction_bytes": sub, "moved_per_logical": d * sub / obj},
         rs={"k": rs.k, "m": rs.m, "chunk_bytes": chunk_rs,
             "moved_per_logical": rs.k * chunk_rs / obj},
         traffic_ratio=ratio, stripes=stripes, target=target,
         helpers=list(helpers), oracle_bit_identical=True,
         repair_MBps=reps * stripes * chunk / repair_s / 1e6,
         rs_decode_MBps=reps * stripes * chunk_rs / rs_s / 1e6,
         launches=calls_by)
    # (a)'s encode and decode inputs for timing, 67 MB: past the L2
    sub_rows = [on_dev(rng.integers(0, 256, (stripes, k * alpha, sub),
                                    dtype=np.uint8)) for _ in range(8)]

    # (b) a recovery batch of Ceph's default 4 MiB objects: 64 (the tier's
    # default capacity, osd_hbm_tier_capacity), every chunk on the card
    nobj, obj_b = MSR_RECOVERY
    chunk_b = msr.get_chunk_size(obj_b)
    sub_b = msr.repair_sub_size(chunk_b)
    data_b = on_dev(rng.integers(0, 256, (nobj, k, chunk_b),
                                 dtype=np.uint8))
    parity_b, enc_s, calls = per_call(lambda: msr.encode_batch(data_b))
    one_launch(calls, "mma", "(b)'s encode")
    full_b = torch.cat([data_b, parity_b], dim=1)
    del data_b, parity_b
    host_b = full_b.cpu().numpy()
    dec_runs = []
    for sig in range(8):
        avail = tuple(sorted(rng.choice(n, k, replace=False).tolist()))
        surv = full_b[:, list(avail)].contiguous()
        out, wall, calls = per_call(lambda: msr.decode_batch(avail, surv))
        one_launch(calls, "mma", "decode %s" % (avail,))
        check(torch.equal(out, full_b), "(b): decode %s rebuilds every "
              "chunk" % (avail,))
        dec_runs.append({"avail": list(avail), "seconds": wall,
                         "launches": calls})
        del out, surv
    calls_by["decode_b"] = [r["launches"] for r in dec_runs]
    decode_bitmat = list(msr._decode_entry(
        tuple(dec_runs[0]["avail"]))["bitmat"].shape)
    decode_groups = gf_kernel.row_groups(840, 56, 8, dev)
    check(decode_bitmat == [840, 448] and len(decode_groups) == 2,
          "a k=8 decode is [840, 448], in two row groups")

    disp = GpuDispatcher()
    threads, per = 8, nobj // 8
    errors: list[str] = []

    def repairer(tid):
        try:
            tgt = tid % n
            hl = tuple(sorted(msr.minimum_to_repair(tgt, set(range(n)))))
            sl = slice(tid * per, (tid + 1) * per)
            futs = [disp.repair_fraction_async(
                msr, tgt, np.ascontiguousarray(host_b[sl, h]))
                for h in hl]
            fracs = np.stack([f.result(300) for f in futs], axis=1)
            got = disp.repair_combine_async(msr, tgt, hl, fracs).result(300)
            if not np.array_equal(got, host_b[sl, tgt]):
                errors.append("thread %d's rebuild" % tid)
        except Exception as e:  # reported below; the run then fails
            errors.append(repr(e))

    def run_repairers():
        pool = [threading.Thread(target=repairer, args=(t,))
                for t in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(600)
        return any(t.is_alive() for t in pool)

    _, disp_s, calls = per_call(run_repairers)
    perf = disp.perf.dump()
    ops, dispatches = disp.stats["ops"], disp.stats["dispatches"]
    disp.shutdown()
    check(not errors, "(b): every dispatcher rebuild equals the original "
          "(%s)" % errors[:3])
    check(calls["bitsliced"] == dispatches and
          sum(calls.values()) == dispatches,
          "(b): one bit-sliced launch a dispatch (%s)" % calls)
    calls_by["dispatcher_b"] = calls
    sinfo = ec_util.StripeInfo(k, k * chunk_b)
    ec_calls = []
    for i in range(4):
        tgt = (5 * i + 3) % n
        hl = msr.minimum_to_repair(tgt, set(range(n)) - {tgt})
        fr, _, c1 = per_call(lambda: {h: ec_util.repair_fraction(
            sinfo, msr, tgt, host_b[i, h]) for h in hl})
        check(all(len(v) == sub_b for v in fr.values()) and
              c1 == {"bitsliced": d, "mma": 0, "popcount": 0},
              "(b): d fractions of chunk/alpha bytes, one launch each")
        out, _, c2 = per_call(lambda: ec_util.repair_combine(
            sinfo, msr, tgt, fr))
        one_launch(c2, "bitsliced", "ec_util's combine")
        check(out == host_b[i, tgt].tobytes(),
              "(b): ec_util rebuilds object %d's chunk %d" % (i, tgt))
        ec_calls.append({"fractions": c1, "combine": c2})
    calls_by["ec_util_b"] = ec_calls
    emit("msr_repair", case="b_recovery_64x4MiB", objects=nobj,
         chunk_bytes=chunk_b, fraction_bytes=sub_b,
         resident_bytes=int(full_b.numel()), encode_s=enc_s,
         decode_bitmat=decode_bitmat,
         decode_row_groups=decode_groups,
         decode_runs=dec_runs,
         decode_MBps=[nobj * n * chunk_b / r["seconds"] / 1e6
                      for r in dec_runs],
         dispatcher={"threads": threads, "objects": nobj, "seconds": disp_s,
                     "rebuilt_MBps": nobj * chunk_b / disp_s / 1e6,
                     "ops": ops, "dispatches": dispatches,
                     "dec_bytes": perf["l_gpu_dec_bytes"],
                     "launches": calls},
         ec_util=ec_calls)
    del full_b, host_b
    torch.cuda.empty_cache()

    # (c) past 512 columns: msr k=10, m=9 ([648, 720] and [1368, 720])
    msr10 = registry.factory("msr_cuda", {"k": "10", "m": "9"})
    n10, obj10 = MSR_SPLIT
    chunk10 = msr10.get_chunk_size(obj10)
    data10 = on_dev(rng.integers(0, 256, (n10, 10, chunk10),
                                 dtype=np.uint8))
    split = {}
    par10, _, calls = per_call(lambda: msr10.encode_batch(data10))
    full10 = torch.cat([data10, par10], dim=1)
    avail10 = (0, 2, 4, 6, 8, 10, 12, 14, 16, 18)
    out10, _, calls_d = per_call(lambda: msr10.decode_batch(
        avail10, full10[:, list(avail10)].contiguous()))
    check(torch.equal(out10, full10), "(c): the k=10 decode rebuilds")
    # the phase's path ends here; the comparisons and timings follow
    phase_launches = gf_kernel.launches_by_design()
    for name, bm_np, x, launched in (
            ("encode", msr10._bitmat, msr10._split(data10, 10), calls),
            ("decode", msr10._decode_entry(avail10)["bitmat"],
             msr10._split(full10[:, list(avail10)].contiguous(), 10),
             calls_d)):
        bm = on_dev(bm_np)
        got = xor_mm.matrix_encode(bm, x, 8)
        ref = gf_kernel.matrix_encode_plain(bm, x, 8)
        err = int((got.to(torch.int16) - ref.to(torch.int16)).abs().max())
        split[name] = {"bitmat": list(bm.shape), "data": list(x.shape),
                       "row_groups": gf_kernel.row_groups(
                           bm.shape[0], bm.shape[1] // 8, 8, dev),
                       "launches": launched, "max_abs_err": err}
        check(err == 0, "(c): the k=10 %s equals the plain version" % name)
        check(launched == {"bitsliced": 0, "mma": 1, "popcount": 0},
              "(c): the k=10 %s is one mma launch" % name)
    emit("msr_repair", case="c_k10_one_launch", k10=split)
    calls_by["k10"] = {n_: split[n_]["launches"] for n_ in split}
    del data10, par10, full10, out10
    torch.cuda.empty_cache()

    # each k=8 matrix alone at (a)'s shapes, inputs rotated out of L2
    frac_e = msr._fraction_entry(target)
    comb_e = msr._combine_entry(target, helpers)
    dec_bm = msr._decode_entry(tuple(range(1, 9)))["bitmat"]
    mats = {"encode": (msr._bitmat, sub_rows),
            "decode": (dec_bm, sub_rows),
            "fraction": (frac_e["bitmat"], [on_dev(rng.integers(
                0, 256, (stripes, alpha, sub), dtype=np.uint8))
                for _ in range(64)]),
            "combine": (comb_e["bitmat"], [on_dev(rng.integers(
                0, 256, (stripes, d, sub), dtype=np.uint8))
                for _ in range(32)])}
    timed, worst = {}, 0
    for name, (bm_np, inputs) in mats.items():
        bm = on_dev(bm_np)
        design = gf_kernel.kernel_design(bm.shape[0], inputs[0].shape[-2],
                                         8, dev)
        out = gf_kernel.matrix_encode(bm, inputs[0], 8)
        ref = gf_kernel.matrix_encode_plain(bm, inputs[0], 8)
        err = int((out.to(torch.int16) - ref.to(torch.int16)).abs().max())
        worst = max(worst, err)
        rec = {"bitmat": list(bm.shape), "data": list(inputs[0].shape),
               "design": design, "max_abs_err": err,
               "ms": time_ms(lambda x: gf_kernel.matrix_encode(bm, x, 8),
                             inputs, 40),
               "plain_ms": time_ms(
                   lambda x: gf_kernel.matrix_encode_plain(bm, x, 8),
                   inputs, 8)}
        rec["bound_ms"], rec["bound_by"] = gf_bound(bm, inputs[0], out, 8)
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        timed[name] = rec
        emit("msr_repair", case="kernel_" + name, gpu=smi, **rec)
        check(err == 0, "the %s matrix equals the plain version" % name)
    check([timed[x]["design"] for x in mats] ==
          ["mma", "mma", "bitsliced", "bitsliced"],
          "encode and decode mma, fraction and combine bit-sliced")
    return {"launches_by_design": phase_launches,
            "launches_by_call": calls_by, "matrices": timed,
            "max_abs_err": worst, "traffic_ratio": ratio}


def telemetry_phase(np, torch, dev, host_data, host_full, sig_pool):
    """Phase 12: the observability layer on the card. A SpanCollector, the
    profiler reset before the phase, and a PerfCountersCollection holding
    the dispatcher's and the tier's counters; (a) phase 4's streaming load
    with every op traced, (b) 16 fused 4 MiB store writes adopted into a
    tier, (c) load (a) with the profiler and the tracer on and off in
    turns. Returns the phase's summary."""
    from ceph_tpu_torch import registry
    from ceph_tpu_torch.common.perf_counters import PerfCountersCollection
    from ceph_tpu_torch.common.profiler import PROFILER
    from ceph_tpu_torch.common.tracer import SpanCollector, render_tree
    from ceph_tpu_torch.device import host_tensor
    from ceph_tpu_torch.ops import gf_kernel
    from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher
    from ceph_tpu_torch.osd.hbm_tier import HbmChunkTier

    t_phase = time.perf_counter()
    threads, iters, per_op = 8, 8, 2
    tracer = SpanCollector(capacity=1 << 16)
    tracer.enabled = True
    PROFILER.enabled = True
    PROFILER.reset()
    codec = registry.factory("torch_cuda", dict(PROFILE))
    disp = GpuDispatcher(tracer=tracer)
    tier = HbmChunkTier(codec)
    coll = PerfCountersCollection()
    coll.add(disp.perf)
    coll.add(tier.perf)
    errors: list[str] = []
    roots: list = []
    lock = threading.Lock()

    def submitter(tid: int) -> None:
        r = random.Random(100 + tid)
        try:
            for _ in range(iters):
                i = r.randrange(BATCH - per_op + 1)
                sl = slice(i, i + per_op)
                avail = sig_pool[r.randrange(len(sig_pool))]
                enc = tracer.start_trace("encode")
                dec = tracer.start_trace("decode")
                f_enc = disp.encode_async(codec, host_data[sl], trace=enc)
                f_dec = disp.decode_async(
                    codec, avail, host_full[sl][:, list(avail)], trace=dec)
                if not np.array_equal(f_enc.result(300), host_full[sl, K:]):
                    errors.append("encode mismatch")
                if not np.array_equal(f_dec.result(300), host_full[sl]):
                    errors.append("decode mismatch %s" % (avail,))
                enc.finish()
                dec.finish()
                if enc.valid():
                    with lock:
                        roots.extend([enc.trace_id, dec.trace_id])
        except Exception as e:  # reported below; the run then fails
            errors.append(repr(e))

    def load() -> float:
        """Load (a) once; its MB/s of input bytes over the wall time."""
        pool = [threading.Thread(target=submitter, args=(t,))
                for t in range(threads)]
        t0 = time.perf_counter()
        for t in pool:
            t.start()
        for t in pool:
            t.join(600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in pool), "submitters finished")
        return threads * iters * 2 * per_op * K * N / wall / 1e6

    # (a) the main path's streaming load, every op traced
    gf_kernel.reset_launches()
    disp.profile_reset()
    mbps = load()
    check(not errors, "telemetry load's results verified: %s" % errors[:3])
    gf_launches = sum(gf_kernel.launches_by_design().values())
    profile = disp.dispatch_profile()
    status = disp.dispatch_status()
    kernels = PROFILER.dump()["kernels"]
    enc = kernels.get("xor_mm.matrix_encode", {})
    enc_calls = enc.get("compiles", 0) + enc.get("cache_hits", 0)
    staging = PROFILER.mem_dump().get("staging_ring", {"bytes": 0})
    spans = tracer.dump()
    by_trace: dict = {}
    for sp in spans:
        by_trace.setdefault(sp["trace_id"], []).append(sp)
    nested = 0
    for tid in roots:
        names = {sp["name"]: sp for sp in by_trace.get(tid, [])}
        devs = names.get("gpu_device")
        if "gpu_queue" in names and devs is not None and all(
                names.get(leg, {}).get("parent_id") == devs["span_id"]
                for leg in ("h2d", "compute", "d2h")):
            nested += 1
    tree = render_tree(spans, roots[0]) if roots else ""
    fracs = [row[st + "_frac"] for row in profile["stages"].values()
             for st in ("busy", "idle", "blocked")]
    # the h2d leg's host work apart: the pinning copy of one op's batch
    one = host_tensor(host_data[:per_op])
    pin_s = []
    for _ in range(20):
        t0 = time.perf_counter()
        one.pin_memory()
        pin_s.append(time.perf_counter() - t0)
    emit("telemetry", case="streaming", threads=threads,
         ops=len(roots), streaming_MBps=mbps, verdict=profile["verdict"],
         window_s=profile["window_s"], stages=profile["stages"],
         queue_occupancy_avg=profile["queue_occupancy_avg"],
         segments_s=status["segments_s"],
         traced_ops=len(roots), nested_ops=nested,
         xor_mm_matrix_encode_calls=enc_calls,
         gf_bitmatrix_launches=gf_launches,
         staging_ring=staging, pin_2MiB_ms=statistics.median(pin_s) * 1e3,
         memory=PROFILER.mem_dump(), errors=errors[:5])
    print(tree, flush=True)
    check(len(roots) == threads * iters * 2 and nested == len(roots),
          "every op's span has gpu_queue and gpu_device with h2d, compute "
          "and d2h nested in it")
    check("gpu_device" in tree and tree.startswith("trace "),
          "render_tree renders one trace")
    check(all(0.0 <= f <= 1.0 for f in fracs) and
          0.0 <= profile["attribution"] <= 1.0,
          "dispatch_profile's fractions lie in [0, 1]")
    check(enc_calls == gf_launches > 0,
          "xor_mm.matrix_encode's calls equal the GF kernel's launches")
    check(staging["bytes"] == 0, "staging_ring reads 0 after the last op")

    # (b) 16 fused 4 MiB store writes adopted into the tier
    wstripes, wchunk, nwrites = 128, 4096, 16
    rng = np.random.default_rng(20261018)
    objects = [rng.integers(0, 256, (wstripes, K, wchunk), dtype=np.uint8)
               for _ in range(nwrites)]
    def calls(name):
        k = PROFILER.dump()["kernels"].get(name, {})
        return k.get("compiles", 0) + k.get("cache_hits", 0)

    prog0 = calls("fused_transform.program")
    disp.profile_reset()
    disp.perf.reset()
    futs = [disp.fused_write_async(codec, o, resident=(tier, "w%d" % i))
            for i, o in enumerate(objects)]
    for f in futs:
        f.result(300)
    torch.cuda.synchronize()
    wprofile = disp.dispatch_profile()
    wsegments = disp.dispatch_status()["segments_s"]
    programs = calls("fused_transform.program") - prog0
    ledger = PROFILER.mem_dump()["hbm_tier"]
    resident = tier.stats()["resident_bytes"]
    dump = coll.perf_dump()
    # the tier's consumers on the adopted writes: one scrub and one rebuild
    # of a lost shard each, their wall time to a synchronise beside the
    # kernels' entry points they call
    names = ["w%d" % i for i in range(nwrites)]
    before = (calls("hbm_tier.digest"), calls("xor_mm.matrix_encode_multi"))
    t0 = time.perf_counter()
    tier.deep_scrub(names)
    scrub_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tier.reconstruct_batch(names, [i % (K + M) for i in range(nwrites)])
    torch.cuda.synchronize()
    rebuild_ms = (time.perf_counter() - t0) * 1e3
    consumer_calls = (calls("hbm_tier.digest") - before[0],
                      calls("xor_mm.matrix_encode_multi") - before[1])
    emit("telemetry", case="fused_writes", writes=nwrites,
         programs=programs, verdict=wprofile["verdict"],
         stages=wprofile["stages"], window_s=wprofile["window_s"],
         segments_s=wsegments, hbm_tier_ledger=ledger,
         resident_bytes=resident, resident_objects=tier.stats()[
             "resident_objects"],
         memory_allocated=torch.cuda.memory_allocated(dev),
         adopted=dump["osd_gpu"]["l_gpu_adopted"],
         fused=disp.telemetry()["fused"], scrub_ms=scrub_ms,
         rebuild_ms=rebuild_ms, digest_calls=consumer_calls[0],
         multi_calls=consumer_calls[1])
    check(programs == nwrites,
          "fused_transform.program counted once per write")
    check(ledger["bytes"] == resident > 0 and
          dump["osd_hbm"]["l_hbm_resident_bytes"] == resident,
          "the tier's ledger category equals its resident bytes")
    check(consumer_calls == (1, 1),
          "a scrub is one digest call and a rebuild one per-lane call")
    del objects, futs

    # (c) the profiler's and the tracer's cost, in turns: on/off/off/on
    rates = {"on": [], "off": []}
    for mode in ("on", "off", "off", "on"):
        PROFILER.enabled = tracer.enabled = mode == "on"
        rates[mode].append(load())
    PROFILER.enabled = True
    tracer.enabled = True
    disp.shutdown()
    check(not errors, "on/off loads' results verified")
    emit("telemetry", case="overhead", on_MBps=rates["on"],
         off_MBps=rates["off"],
         on_over_off=statistics.mean(rates["on"]) /
         statistics.mean(rates["off"]),
         phase_s=time.perf_counter() - t_phase)
    return {"verdict": profile["verdict"], "rates": rates}


def mesh_phase(np, torch, dev, smi):
    """Phase 13: multi-device placement on one card: (a) the mesh legs
    over a 2 x 2 mesh of ``["cuda:0"] * 4`` (RS k=8, m=3 encode and
    decode at [16, 8, 131072], ``ec_util.recover_cross_chip`` of a 4 MiB
    object, ``repair_cross_chip`` of MSR k=8, m=7 on phase 11's sizes,
    a corrupted survivor raising MeshChecksumError), (b) ``mesh_do_rule``
    of the 1024-OSD cluster's EC rule at 2^20 seeds over a flat mesh of 4
    and through the rateless queue, (c) a ``RatelessDispatcher`` of 4
    workers on the card: encode and LT-coded decode of 64 objects of
    1 MiB under random stalls, with one worker killed mid-batch and with
    every worker killed. The GF, digest and CRUSH kernels' counts are set
    to 0 just before the path and read just after it. Returns the
    phase's launches per kernel."""
    from ceph_tpu_torch import registry
    from ceph_tpu_torch.common.profiler import PROFILER
    from ceph_tpu_torch.crush import batched, mapper_ref
    from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE
    from ceph_tpu_torch.ops import crush_kernel, digest_kernel, gf_kernel
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.parallel import mesh as pmesh, rateless
    from ceph_tpu_torch.tools.crush_tier_turns import crush_cases
    from ceph_tpu_torch.utils.cuda_timing import (crush_bound, digest_bound,
                                                  gf_bound, time_ms)

    t_phase = time.perf_counter()
    sections = {}
    rng = np.random.default_rng(20261018 + 13)
    devices = [str(dev)] * 4
    mesh = pmesh.make_mesh(devices=devices)
    check(mesh.shape == {"stripe": 2, "block": 2}, "a 2 x 2 mesh")
    codec = registry.factory("torch_cuda", dict(PROFILE))
    msr = registry.factory("msr_cuda", {"technique": "msr", "k": "8",
                                        "m": "7", "w": "8"})
    data = rng.integers(0, 256, (BATCH, K, N), dtype=np.uint8)
    avail = (0, 2, 3, 4, 6, 7, 8, 10)

    def counts():
        torch.cuda.synchronize()
        return {"gf": gf_kernel.LAUNCHES, "digest": digest_kernel.LAUNCHES,
                "crush": crush_kernel.LAUNCHES}

    def timed(fn, reps=3):
        """fn()'s result, the launches its first call made, and the
        median wall ms of `reps` more calls, each to a synchronise."""
        before = counts()
        out = fn()
        after = counts()
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return out, {k_: after[k_] - before[k_] for k_ in after}, \
            statistics.median(walls) if walls else None

    # -- the path: counts from 0 just before ---------------------------
    gf_kernel.reset_launches()
    digest_kernel.reset_launches()
    crush_kernel.reset_launches()
    batched.reset_paths()
    legs = {}
    # (a) the mesh legs against the single-device calls
    parity, launched, ms = timed(
        lambda: pmesh.encode_sharded(codec, data, mesh))
    single, _, single_ms = timed(lambda: codec.encode_batch(data))
    check(np.array_equal(parity, single), "(a): encode_sharded equals the "
          "single-device encode")
    check(launched == {"gf": 4, "digest": 0, "crush": 0},
          "(a): one GF launch a block (%s)" % launched)
    legs["encode_sharded"] = {"ms": ms, "single_ms": single_ms,
                              "launches": launched}
    full = np.concatenate([data, parity], axis=1)
    chunks = np.ascontiguousarray(full[:, list(avail)])
    dec, launched, ms = timed(
        lambda: pmesh.decode_sharded(codec, avail, chunks, mesh))
    _, _, single_ms = timed(lambda: codec.decode_batch(avail, chunks))
    check(np.array_equal(dec, full), "(a): decode_sharded rebuilds rows "
          "1, 5 and 9")
    check(launched["gf"] == 4, "(a): one GF launch a block of the decode")
    legs["decode_sharded"] = {"ms": ms, "single_ms": single_ms,
                              "launches": launched}

    chunk = 4096
    sinfo = ec_util.StripeInfo(K, K * chunk)
    obj = rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes()
    shards = ec_util.encode(sinfo, codec, obj)
    target = 5
    # shard 8, the XOR parity, lost too: the decode takes the GF product
    surv = {s: shards[s] for s in sorted(shards) if s not in (target, 8,
                                                               10)}
    host_sum = sum(int(np.asarray(v, dtype=np.uint64).sum())
                   for v in surv.values()) % (1 << 32)
    got, launched, ms = timed(lambda: ec_util.recover_cross_chip(
        sinfo, codec, surv, target, mesh=mesh, expected_sum=host_sum))
    want, _, single_ms = timed(lambda: ec_util.decode(
        sinfo, codec, surv, want={target})[target])
    check(got == np.asarray(want).tobytes() == shards[target].tobytes(),
          "(a): recover_cross_chip of a 4 MiB object equals the "
          "single-device decode and the lost shard")
    check(launched["gf"] == 4 and launched["digest"] == 4,
          "(a): recovery is 4 GF and 4 digest launches (%s)" % launched)
    legs["recover_cross_chip"] = {"ms": ms, "single_ms": single_ms,
                                  "launches": launched,
                                  "survivors": [128, K, chunk]}
    bad = dict(surv)
    bad[0] = np.asarray(surv[0]).copy()
    bad[0][12345] ^= 0x10
    try:
        ec_util.recover_cross_chip(sinfo, codec, bad, target, mesh=mesh,
                                   expected_sum=host_sum)
        tripped = False
    except pmesh.MeshChecksumError:
        tripped = True
    check(tripped, "(a): a survivor corrupted by one byte raises "
          "MeshChecksumError")

    m_stripes, m_obj = MSR_BENCH
    m_chunk = msr.get_chunk_size(m_obj)
    m_sinfo = ec_util.StripeInfo(msr.k, msr.k * m_chunk)
    m_payload = rng.integers(0, 256, m_stripes * msr.k * m_chunk,
                             dtype=np.uint8).tobytes()
    m_shards = ec_util.encode(m_sinfo, msr, m_payload)
    m_target = msr.chunk_index(2)
    helpers = sorted(msr.minimum_to_repair(m_target,
                                           set(m_shards) - {m_target}))
    fractions = {h: ec_util.repair_fraction(m_sinfo, msr, m_target,
                                            m_shards[h]) for h in helpers}
    rebuilt, launched, ms = timed(lambda: ec_util.repair_cross_chip(
        m_sinfo, msr, m_target, fractions, mesh=mesh))
    single, _, single_ms = timed(lambda: ec_util.repair_combine(
        m_sinfo, msr, m_target, fractions))
    check(rebuilt == single == m_shards[m_target].tobytes(),
          "(a): repair_cross_chip equals the single-device combine and "
          "the lost chunk")
    check(launched["gf"] == 4 and launched["digest"] == 4,
          "(a): the combine is 4 GF and 4 digest launches (%s)" % launched)
    legs["repair_cross_chip"] = {"ms": ms, "single_ms": single_ms,
                                 "launches": launched,
                                 "fractions": [m_stripes, len(helpers),
                                               msr.repair_sub_size(m_chunk)]}

    sections["a_mesh_legs"] = time.perf_counter() - t_phase
    # (b) the mesh-sharded CRUSH sweep and the queue's
    case = {c[0]: c for c in crush_cases(np)}["cluster_ec_1048576"]
    _, cluster, ec_rule, rmax, c_rw, _, n_seeds = case
    xs = np.arange(n_seeds, dtype=np.int64)
    one, launched_one, one_ms = timed(lambda: batched.batched_do_rule(
        cluster, ec_rule, xs, rmax, c_rw))
    flat = batched.make_batch_mesh(devices=devices)
    swept, launched, ms = timed(lambda: batched.mesh_do_rule(
        cluster, ec_rule, xs, rmax, c_rw, mesh=flat))
    check(np.array_equal(swept, one), "(b): mesh_do_rule equals "
          "batched_do_rule at 2^20 seeds")
    check(launched["crush"] == 4, "(b): one CRUSH launch a share")
    legs["mesh_do_rule"] = {"ms": ms, "single_ms": one_ms,
                            "launches": launched, "seeds": n_seeds}
    crush_rl = rateless.RatelessDispatcher(devices=devices,
                                           name="smoke-crush")
    rateless.set_dispatcher(crush_rl)
    try:
        queued, launched, ms = timed(lambda: batched.mesh_do_rule(
            cluster, ec_rule, xs, rmax, c_rw))
        check(np.array_equal(queued, one), "(b): the queue's sweep equals "
              "batched_do_rule")
        check(launched["crush"] >= 16, "(b): one CRUSH launch a seed "
              "micro-batch (%s)" % launched)
        legs["mesh_do_rule_rateless"] = {
            "ms": ms, "single_ms": one_ms, "launches": launched,
            "workers": crush_rl.device_status()}
    finally:
        rateless.reset_dispatcher()
    for x in rng.choice(n_seeds, 64, replace=False):
        res = mapper_ref.crush_do_rule(cluster, ec_rule, int(x), rmax,
                                       list(c_rw))
        check(list(swept[x]) == res + [CRUSH_ITEM_NONE] * (rmax - len(res)),
              "(b): seed %d equals the scalar mapper" % x)

    sections["b_crush"] = time.perf_counter() - t_phase
    # (c) the rateless dispatcher: 64 objects of 1 MiB
    r_data = rng.integers(0, 256, (64, K, N), dtype=np.uint8)
    r_want = codec.encode_batch(r_data)
    r_full = np.concatenate([r_data, r_want], axis=1)
    r_chunks = np.ascontiguousarray(r_full[:, list(avail)])
    PROFILER.enabled = True
    PROFILER.mem_set("speculative_buffers", 0)
    inj = rateless.DeviceFaultSet(seed=13)
    rl = rateless.RatelessDispatcher(devices=devices, injector=inj,
                                     name="smoke-rl")

    def idle():
        end = time.monotonic() + 30
        while time.monotonic() < end:
            if rl.status()["queue_depth"] == 0 and all(
                    d["inflight"] == 0 for d in rl.device_status()):
                return True
            time.sleep(0.005)
        return False

    rl_cases = {}
    try:
        for idx in range(4):
            inj.stall_ms(idx, float(rng.integers(1, 16)))
        got, launched, ms = timed(lambda: rl.encode(codec, r_data), 1)
        check(np.array_equal(got, r_want), "(c): encode under stalls")
        check(rl.status()["stolen_total"] > 0, "(c): idle workers stole")
        rl_cases["stalls_encode"] = {"ms": ms, "launches": launched}
        got, launched, ms = timed(lambda: rl.decode(
            codec, avail, r_chunks, lt=True, seed=1), 1)
        check(np.array_equal(got, r_full), "(c): LT-coded decode")
        rl_cases["stalls_lt_decode"] = {"ms": ms, "launches": launched}
        inj.clear_all()
        _, _, single_ms = timed(lambda: codec.encode_batch(r_data), 1)
        _, _, plain_ms = timed(lambda: rl.encode(codec, r_data), 1)
        rl_cases["encode_no_faults"] = {"ms": plain_ms,
                                        "single_ms": single_ms}
        # one worker killed mid-batch, then re-admitted on probation; it
        # stalls inside its micro-batch so that it holds one at the kill,
        # and an encode the others finish before it pulls is run again
        check(rl.degraded() == 0, "(c): every worker healthy before the kill")
        inj.stall_ms(0, 200.0)
        for _ in range(5):
            box = {}
            t = threading.Thread(target=lambda: box.update(
                out=rl.encode(codec, r_data)), daemon=True)
            t.start()
            end = time.monotonic() + 30
            while rl.health[0].inflight < 1 and t.is_alive() and \
                    time.monotonic() < end:
                time.sleep(0.001)
            held = rl.health[0].inflight >= 1
            if held:
                inj.kill(0)
            t.join(timeout=60)
            check(not t.is_alive(), "(c): the encode ended")
            check(np.array_equal(box.get("out"), r_want), "(c): encode with "
                  "worker 0 killed mid-batch")
            if held:
                break
        # the job may seal on a speculative copy while worker 0 still
        # sleeps in its stall; it drains when it wakes
        end = time.monotonic() + 10
        while rl.health[0].state != "blacklisted" and \
                time.monotonic() < end:
            time.sleep(0.005)
        degraded = rl.degraded()
        check(held and rl.health[0].state == "blacklisted",
              "(c): the killed worker held work and is blacklisted")
        inj.clear_all()
        time.sleep(2 * rl.probation_base_s)
        for _ in range(20):
            check(np.array_equal(rl.encode(codec, r_data), r_want),
                  "(c): encode during probation")
            if rl.health[0].state == "healthy":
                break
        check(rl.health[0].state == "healthy" and rl.degraded() == 0,
              "(c): probation re-admitted worker 0")
        rl_cases["kill_one"] = {"degraded": degraded, "readmitted": True}
        for idx in range(4):
            inj.kill(idx)
        got, launched, ms = timed(lambda: rl.encode(codec, r_data), 0)
        check(np.array_equal(got, r_want), "(c): every worker killed, the "
              "caller's thread finished")
        rl_cases["kill_all"] = {"launches": launched}
        inj.clear_all()
        check(idle(), "(c): the workers went idle")
        spec = PROFILER.mem_dump().get("speculative_buffers",
                                       {"bytes": 0, "high_watermark": 0})
        check(spec["bytes"] == 0 and rl._spec_bytes == 0,
              "(c): speculative_buffers is back to 0")
        status = rl.status()
    finally:
        inj.clear_all()
        rl.shutdown()
    phase = counts()
    sections["c_rateless"] = time.perf_counter() - t_phase
    # the phase's path ends here; the comparisons and timings follow
    check(all(phase.values()), "the phase launched the GF, digest and "
          "CRUSH kernels (%s)" % phase)

    # each leg's kernels against their plain versions on the card
    x = torch.from_numpy(data).to(dev)
    bm = codec._device_bitmat(dev)
    check(np.array_equal(parity, gf_kernel.matrix_encode_plain(
        bm, x, W).cpu().numpy()), "(a): the sharded encode equals the plain "
        "version")
    dec_bm = torch.from_numpy(codec._decode_entry(avail)["bitmat"]).to(dev)
    check(np.array_equal(dec, gf_kernel.matrix_encode_plain(
        dec_bm, torch.from_numpy(chunks).to(dev), W).cpu().numpy()),
        "(a): the sharded decode equals the plain version")
    del x
    blocks = pmesh._place(chunks, mesh, 1)
    sums = [digest_kernel.chunk_digest(b.data.reshape(-1, N // 2))[0]
            for b in blocks]
    plain = [int(torch.sum(b.data, dtype=torch.int64)) % (1 << 32)
             for b in blocks]
    got = [int((s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF).sum())
           % (1 << 32) for s in sums]
    check(got == plain, "the checksum's digest sums equal torch.sum")
    # one block's kernels alone at the phase's block shape, 16 inputs
    # rotated out of the 50 MB L2 (CUDA events)
    g = torch.Generator(device=dev).manual_seed(13)
    ins = list(torch.randint(0, 256, (16,) + tuple(blocks[0].data.shape),
                             generator=g, dtype=torch.uint8, device=dev))
    rows = [x_.reshape(-1, N // 2) for x_ in ins]
    checksum = {"block": list(blocks[0].data.shape),
                "ms": time_ms(lambda r: digest_kernel.chunk_digest(r), rows,
                              40),
                "plain_ms": time_ms(lambda r: digest_kernel.chunk_digest_plain(
                    r), rows, 8),
                "library_ms": time_ms(lambda r: torch.sum(
                    r, dim=-1, dtype=torch.int64), rows, 40)}
    checksum["bound_ms"], checksum["bound_by"] = digest_bound(
        rows[0].numel(), rows[0].shape[0])
    out0 = gf_kernel.matrix_encode(bm, ins[0], W)
    block_gf = {"block": list(ins[0].shape), "bitmat": list(bm.shape),
                "ms": time_ms(lambda x_: gf_kernel.matrix_encode(bm, x_, W),
                              ins, 40),
                "plain_ms": time_ms(lambda x_: gf_kernel.matrix_encode_plain(
                    bm, x_, W), ins, 8)}
    block_gf["bound_ms"], block_gf["bound_by"] = gf_bound(bm, ins[0], out0, W)
    cm = batched.compile_map(cluster, None)
    plan = batched.plan_rule(cluster, ec_rule, rmax)
    wvec = batched.reweight_vector(c_rw, cm.max_devices)
    share = torch.arange(n_seeds // 4, dtype=torch.int64, device=dev)
    work = torch.zeros((share.shape[0], 2), dtype=torch.int32, device=dev)
    crush_kernel.crush_sweep(cm, plan, share, wvec, work=work)
    wdev = torch.from_numpy(wvec).to(dev)
    crush_share = {"seeds": int(share.shape[0]),
                   "ms": time_ms(lambda x_: crush_kernel.crush_sweep(
                       cm, plan, x_, wvec), [share], 10),
                   "plain_ms": time_ms(lambda x_: batched.map_plain(
                       cm, plan, x_, wdev), [share], 2)}
    crush_share["bound_ms"], crush_share["bound_by"] = crush_bound(work, rmax)
    del blocks, sums, rows, ins, out0, share, work, wdev
    torch.cuda.empty_cache()
    sections["timings"] = time.perf_counter() - t_phase
    emit("mesh", case="legs", gpu=smi, mesh=dict(mesh.shape), legs=legs,
         checksum=checksum, block_gf=block_gf, crush_share=crush_share,
         sections_s=sections)
    emit("mesh", case="rateless", gpu=smi, cases=rl_cases,
         workers=[{f: d[f] for f in ("device", "state", "completed",
                                     "stolen", "redispatched", "timeouts",
                                     "errors", "blacklist_total")}
                  for d in status["devices"]],
         stolen_total=status["stolen_total"],
         redispatch_total=status["redispatch_total"],
         duplicate_total=status["duplicate_total"],
         speculative_buffers=spec, launches=phase,
         phase_s=time.perf_counter() - t_phase)
    return {"launches": phase, "checksum": checksum, "legs": legs,
            "block_gf": block_gf, "crush_share": crush_share}


def placement_cluster(np):
    """Phase 14's deployment: phase 9's 1024-OSD cluster and reweights;
    pool 1 replicated size 3 at Ceph's (OSDs x 100) / size PGs to a power
    of two, pool 2 SHEC k=8 m=4 (12 slots) at 8,192 PGs with a
    two-position weight set under choose_args[2]. Returns the OSDMap, its
    CRUSH map and the EC rule."""
    from ceph_tpu_torch.crush.map import (POOL_TYPE_ERASURE,
                                          POOL_TYPE_REPLICATED)
    from ceph_tpu_torch.osd.osd_map import Incremental, OSDMap, PGPool
    from ceph_tpu_torch.tools import crushtool
    from ceph_tpu_torch.tools.crush_tier_turns import (CLUSTER_LAYERS,
                                                       cluster_reweight)

    crush = crushtool.build_map(1024, CLUSTER_LAYERS)
    ec_rule = crush.add_simple_rule("ec", "default", "host", mode="indep",
                                    rule_type=POOL_TYPE_ERASURE)
    rep_rule = crush.add_simple_rule("rep", "default", "host")
    crush.create_choose_args(2, positions=2)
    for host in (3, 17, 29, 42, 58):
        crush.choose_args_adjust_item_weight(2, -1 - host, host * 16 + 4,
                                             [0x4000, 0xC000])
    rw = cluster_reweight(np, 1024)
    m = OSDMap()
    inc = Incremental(1)
    inc.new_max_osd = 1024
    inc.new_crush = crush
    inc.new_pools[1] = PGPool(pool_id=1, name="rbd",
                              type=POOL_TYPE_REPLICATED, size=3, min_size=2,
                              pg_num=PLACEMENT_PGS[0], crush_rule=rep_rule)
    inc.new_pools[2] = PGPool(pool_id=2, name="ec", type=POOL_TYPE_ERASURE,
                              size=12, min_size=9, pg_num=PLACEMENT_PGS[1],
                              crush_rule=ec_rule,
                              erasure_code_profile="shec_k8_m4_c3")
    for osd in range(1024):
        inc.new_up[osd] = ("127.0.0.1", 6800 + osd)
        inc.new_weight[osd] = int(rw[osd])
    m.apply_incremental(inc)
    return m, crush, ec_rule


def placement_phase(np, torch, dev, smi):
    """Phase 14: the placement control plane on the card: the full remap
    (``OSDMapMapping.update``), churn through ``apply_incremental``, the
    upmap balancer and the two CLIs, on phase 9's 1024-OSD cluster with
    two pools (40,960 PGs). Returns the phase's straw2 launches, counted
    from 0 just before it, and its numbers."""
    import contextlib
    import io

    from ceph_tpu_torch import compressor
    from ceph_tpu_torch.crush import batched
    from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE
    from ceph_tpu_torch.ops import crush_kernel
    from ceph_tpu_torch.osd import balancer
    from ceph_tpu_torch.osd.osd_map import Incremental, OSDMapMapping, PGID
    from ceph_tpu_torch.tools import crushtool, osdmaptool
    from ceph_tpu_torch.utils.cuda_timing import crush_bound, time_ms

    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    m, crush, ec_rule = placement_cluster(np)
    n_pgs = sum(p.pg_num for p in m.pools.values())
    n_slots = sum(p.pg_num * p.size for p in m.pools.values())
    map_json = out_dir / "osdmap_1024.json"
    map_json.write_text(json.dumps(osdmaptool.osdmap_to_json(m)))
    built_map = m.clone()

    def counted(fn):
        """fn()'s result, wall ms, and the straw2 launches and table
        uploads it made."""
        l0, u0 = crush_kernel.LAUNCHES, crush_kernel.UPLOADS
        t0 = time.perf_counter()
        res = fn()
        ms = (time.perf_counter() - t0) * 1e3
        return res, ms, crush_kernel.LAUNCHES - l0, crush_kernel.UPLOADS - u0

    def remap(**kw):
        mapping = OSDMapMapping()
        mapping.update(m, **kw)
        return mapping

    def same_sets(a, b):
        return {o: sorted(p, key=lambda g: (g.pool, g.ps))
                for o, p in a.by_osd.items() if p} == \
            {o: sorted(p, key=lambda g: (g.pool, g.ps))
             for o, p in b.by_osd.items() if p}

    # the main path, counted from 0 just before it
    crush_kernel.clear_tables()
    crush_kernel.reset_launches()
    batched.reset_paths()
    sections = {}
    # (a) the full remap: cold tables, then warm, then over a flat mesh
    mapping, first_ms, launched, uploaded = counted(remap)
    check(launched == 2 and uploaded == 2,
          "(a) one straw2 launch and one table upload a pool (%d, %d)"
          % (launched, uploaded))
    check(batched.paths() == {"kernel": 2, "plain": 0, "scalar": 0},
          "(a) both pools took the kernel")
    warm, warm_ms, launched, uploaded = counted(remap)
    check(launched == 2 and uploaded == 0,
          "(a) a second update: one launch a pool, no table upload "
          "(%d, %d)" % (launched, uploaded))
    check(warm.by_pg == mapping.by_pg and warm.by_osd == mapping.by_osd,
          "(a) the second update maps alike")
    worst = 0
    for pool_id, pool in m.pools.items():
        cm = batched.compile_map(
            m.crush, m.crush.choose_args_get_with_fallback(pool_id))
        plan = batched.plan_rule(m.crush, pool.crush_rule, pool.size)
        wvec = batched.reweight_vector(m._weight_vector(), cm.max_devices)
        seeds = torch.from_numpy(pool.pps_of(np.arange(pool.pg_num))).to(dev)
        plain = batched.map_plain(cm, plan, seeds, torch.from_numpy(
            wvec).to(dev)).cpu().numpy()
        diff = int(np.abs(plain - mapping.raw[pool_id]).max())
        worst = max(worst, diff)
        check(diff == 0, "(a) pool %d's raw result equals the plain version "
              "on the card" % pool_id)
        rng = np.random.default_rng(pool_id)
        for ps in rng.choice(pool.pg_num, min(256, pool.pg_num),
                             replace=False):
            pgid = PGID(pool_id, int(ps))
            check(mapping.get(pgid) == m.pg_to_up_acting_osds(pgid),
                  "(a) %s equals the scalar path" % pgid)
    mesh = batched.make_batch_mesh(devices=["cuda:0"] * 4)
    meshed, mesh_ms, launched, uploaded = counted(lambda: remap(mesh=mesh))
    check(launched == 8, "(a) four launches a pool over the mesh (%d)"
          % launched)
    check(meshed.by_pg == mapping.by_pg and meshed.by_osd == mapping.by_osd,
          "(a) the mesh's remap maps alike")
    holes = {p: int((mapping.raw[p] == CRUSH_ITEM_NONE).sum())
             for p in m.pools}
    emit("placement", case="full_remap", gpu=smi, pgs=n_pgs, slots=n_slots,
         first_ms=first_ms, warm_ms=warm_ms, mesh_ms=mesh_ms,
         split_warm_ms=warm.split, split_mesh_ms=meshed.split,
         raw_holes=holes, max_abs_err=worst,
         sampled_scalar=256 * len(m.pools))
    sections["a"] = time.perf_counter() - t_phase

    # (b) churn: an overlay-only incremental, then a weight change
    rng = np.random.default_rng(14)
    in_osds = [o for o in range(1024) if m.is_in(o)]
    inc = Incremental(m.epoch + 1)
    for i, ps in enumerate(rng.choice(PLACEMENT_PGS[1], 64, replace=False)):
        pool_id, size = (1, 3) if i % 4 else (2, 12)
        inc.new_pg_temp[PGID(pool_id, int(ps))] = [
            int(o) for o in rng.choice(in_osds, size, replace=False)]
    for ps in rng.choice(PLACEMENT_PGS[1], 8, replace=False):
        up = mapping.get(PGID(2, int(ps)))[0]
        inc.new_primary_temp[PGID(2, int(ps))] = int(up[3])
    for ps in rng.choice(PLACEMENT_PGS[0], 64, replace=False):
        pgid = PGID(1, int(ps))
        up = mapping.get(pgid)[0]
        dst = next(o for o in rng.permutation(in_osds) if o not in up)
        inc.new_pg_upmap_items[pgid] = [(up[0], int(dst))]
    inc.new_down = [int(o) for o in rng.choice(in_osds, 8, replace=False)]
    m.apply_incremental(inc)
    info, inc_ms, launched, _ = counted(
        lambda: mapping.apply_incremental(m, inc))
    check(info["mode"] == "incremental" and launched == 0,
          "(b) the overlay-only inc recomputed on the host (%s)" % info)
    full, full_ms, launched, _ = counted(remap)
    check(launched == 2, "(b) the full remap: one launch a pool")
    check(mapping.by_pg == full.by_pg and same_sets(mapping, full),
          "(b) the incremental mapping equals a full update")
    inc2 = Incremental(m.epoch + 1)
    inc2.new_weight = {in_osds[100]: 0x4000}
    m.apply_incremental(inc2)
    info2, full2_ms, launched, uploaded = counted(
        lambda: mapping.apply_incremental(m, inc2))
    check(info2 == {"mode": "full", "recomputed": n_pgs} and launched == 2,
          "(b) a weight change falls back to a full update (%s)" % info2)
    emit("placement", case="churn", gpu=smi, pg_temp=64, primary_temp=8,
         pg_upmap_items=64, down=8, incremental=info, incremental_ms=inc_ms,
         full_update_ms=full_ms, weight_change=info2,
         weight_change_ms=full2_ms, weight_change_uploads=uploaded)
    sections["b"] = time.perf_counter() - t_phase

    # (c) the balancer, its sweeps on the card, on the map as built (a
    # down OSD is underfull to it, and would draw shards onto itself)
    m = built_map
    mapping = warm
    before, before_ms, launched_b, _ = counted(
        lambda: balancer.eval_distribution(m))
    check(launched_b == 2, "(c) eval: one launch a pool")
    res, bal_ms, launched, uploaded = counted(
        lambda: balancer.calc_pg_upmaps(m, max_changes=64,
                                        changes_per_sweep=16))
    check(res.num_changed > 0, "(c) the balancer proposed changes")
    check(launched == 2 * res.sweeps and uploaded == 0,
          "(c) one launch a pool a sweep, no upload (%d launches, %d "
          "sweeps, %d uploads)" % (launched, res.sweeps, uploaded))
    bal_launches = launched
    pre = {pg: mapping.get(pg)[0] for pg in res.new_pg_upmap_items}
    inc3 = Incremental(m.epoch + 1)
    res.apply_to(inc3)
    m.apply_incremental(inc3)
    info3 = mapping.apply_incremental(m, inc3)
    check(info3["mode"] == "incremental", "(c) the proposal is overlay-only")
    full = remap()
    check(mapping.by_pg == full.by_pg and same_sets(mapping, full),
          "(c) the mapping after apply_to equals a full update")
    pindex = balancer.parent_index(m.crush)
    for pgid, old in pre.items():
        pool = m.pools[pgid.pool]
        fd = balancer.rule_failure_domain(m.crush, pool.crush_rule)
        new = [o for o in full.get(pgid)[0] if o != CRUSH_ITEM_NONE]
        old = [o for o in old if o != CRUSH_ITEM_NONE]
        check(len(new) == len(old), "(c) %s keeps its replica count" % pgid)
        check(len({balancer.parent_of_type(m.crush, o, fd, pindex)
                   for o in new}) >=
              len({balancer.parent_of_type(m.crush, o, fd, pindex)
                   for o in old}),
              "(c) %s keeps its failure-domain count" % pgid)
    after = balancer.eval_distribution(m)
    dev_before = max(before.deviation(o) for o in before.targets)
    dev_after = max(after.deviation(o) for o in after.targets)
    check(dev_after <= dev_before, "(c) the largest deviation did not rise "
          "(%.3f -> %.3f)" % (dev_before, dev_after))
    emit("placement", case="balancer", gpu=smi, max_changes=64,
         changes_per_sweep=16, sweeps=res.sweeps, changes=res.num_changed,
         items=len(res.new_pg_upmap_items),
         dropped=len(res.old_pg_upmap_items),
         largest_deviation=[dev_before, dev_after],
         largest_abs_deviation=[
             max(abs(before.deviation(o)) for o in before.targets),
             max(abs(after.deviation(o)) for o in after.targets)],
         total_deviation=[res.start_deviation, res.end_deviation],
         stddev=[before.stddev, after.stddev], seconds=bal_ms / 1e3,
         straw2_launches=bal_launches, eval_ms=before_ms)
    sections["c"] = time.perf_counter() - t_phase

    # (d) the CLIs: crushtool -d / -c of the map and --test --batched,
    # osdmaptool --test-map-pgs --batched of the map as built
    def tool(mod, *argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main([str(a) for a in argv])
        check(rc == 0, "%s %s" % (mod.__name__, " ".join(map(str, argv))))
        return buf.getvalue()

    built, text = out_dir / "crush_1024_ws.json", out_dir / "crush_1024.txt"
    compiled = out_dir / "crush_1024_compiled.json"
    built.write_text(json.dumps(crushtool.map_to_json(crush)))
    tool(crushtool, "-d", built, "-o", text)
    tool(crushtool, "-c", text, "-o", compiled)
    docs = [json.loads(p.read_text()) for p in (built, compiled)]
    for doc in docs:
        doc["buckets"].sort(key=lambda b: b["id"])
    check(docs[0] == docs[1], "(d) crushtool -d then -c gives the same map")
    test_args = ["--test", "--rule", ec_rule, "--num-rep", 12, "--min-x", 0,
                 "--max-x", 65535, "--batched", "--show-utilization"]
    reports = [tool(crushtool, "-i", p, *test_args) for p in (built, compiled)]
    check(reports[0] == reports[1], "(d) --test --batched: the compiled map "
          "reports as the built one")
    _, r_built = crushtool.run_test(crush, ec_rule, 12, 0, 65535, batched=True)
    _, r_comp = crushtool.run_test(crushtool.map_from_json(docs[1]), ec_rule,
                                   12, 0, 65535, batched=True)
    check(r_built == r_comp, "(d) every seed of the compiled map maps as "
          "the built map's")
    t0 = time.perf_counter()
    report = tool(osdmaptool, map_json, "--test-map-pgs", "--batched")
    pgs_s = time.perf_counter() - t0
    counts = [int(line.split("\t")[1]) for line in report.splitlines()
              if line.startswith("osd.")]
    check(len(counts) == 1024 and sum(counts) == n_slots,
          "(d) osdmaptool's per-OSD counts sum to %d (%d)"
          % (n_slots, sum(counts)))
    (out_dir / "osdmaptool_test_map_pgs.txt").write_text(report)
    avail = {a: compressor.available(a)
             for a in ("zlib", "zstd", "snappy", "lz4", "jax_device")}
    emit("placement", case="tools", gpu=smi, text_bytes=text.stat().st_size,
         crushtool_test_summary=reports[0].strip().splitlines()[-2:],
         osdmaptool_summary=report.strip().splitlines()[-4:],
         osdmaptool_s=pgs_s, slots_counted=sum(counts),
         compressors_available=avail)
    sections["d"] = time.perf_counter() - t_phase
    launches = crush_kernel.LAUNCHES
    paths = batched.paths()
    check(launches > 0 and paths["plain"] == 0,
          "phase 14 launched the straw2 kernel and never the plain version")

    # the sweep's parts of one pool's remap (not on the main path's count):
    # compile_map, h2d, kernel (CUDA events, seeds on the card), d2h
    parts = {}
    for pool_id, pool in m.pools.items():
        args = m.crush.choose_args_get_with_fallback(pool_id)
        t0 = time.perf_counter()
        cm = batched.compile_map(m.crush, args)
        compile_ms = (time.perf_counter() - t0) * 1e3
        plan = batched.plan_rule(m.crush, pool.crush_rule, pool.size)
        wvec = batched.reweight_vector(m._weight_vector(), cm.max_devices)
        seeds = pool.pps_of(np.arange(pool.pg_num))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs = torch.from_numpy(seeds).to(dev)
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t0) * 1e3
        out = crush_kernel.crush_sweep(cm, plan, xs, wvec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.cpu().numpy()
        d2h_ms = (time.perf_counter() - t0) * 1e3
        kernel_ms = time_ms(lambda x: crush_kernel.crush_sweep(
            cm, plan, x, wvec), [xs], 10)
        work = torch.zeros((pool.pg_num, 2), dtype=torch.int32, device=dev)
        crush_kernel.crush_sweep(cm, plan, xs, wvec, work=work)
        bound_ms, bound_by = crush_bound(work, pool.size)
        parts[pool_id] = dict(seeds=pool.pg_num, compile_map_ms=compile_ms,
                              h2d_ms=h2d_ms, kernel_ms=kernel_ms,
                              d2h_ms=d2h_ms, bound_ms=bound_ms,
                              bound_by=bound_by,
                              share_of_bound=bound_ms / kernel_ms)
    emit("placement", case="sweep_parts", gpu=smi, pools=parts,
         launches=launches, paths=paths, sections_s=sections,
         phase_s=time.perf_counter() - t_phase)
    return {"launches": launches, "parts": parts,
            "warm_split": warm.split, "warm_ms": warm_ms,
            "balancer": {"sweeps": res.sweeps, "changes": res.num_changed,
                         "launches": bal_launches}}


def native_phase(np, torch, dev, smi):
    """Phase 15: the native seam on the card. (a) The port's build of the
    C++ runtime, after every nvcc build. (b) ``NativeCodec``
    ("jerasure", the runtime's host codec) against ``torch_cuda`` on the
    card at the main path's [16, 8, 131072]: encode and three decode
    signatures byte-equal, each side's MB/s. (c) The batching bridge: 8
    threads x 16 ``bridge_encode`` calls through
    ``install_cuda_dispatcher``, the GF kernel counted from 0 just before,
    after an untimed round, each call's latency timed in its thread,
    beside ``GpuDispatcher.encode_async`` at the same load. (d) Phase
    14's cluster through ``update(native=True)`` against ``update()`` on
    the card, and ``calc_pg_upmaps(use_native=True)`` against
    ``use_device=True``. (e) ``ceph_erasure_code`` and
    ``ceph_erasure_code_non_regression`` on the card and the host codec.
    Returns the bridge's GF launches and numbers."""
    import concurrent.futures
    import contextlib
    import io
    import shutil

    from ceph_tpu_torch import native, registry
    from ceph_tpu_torch.ops import crush_kernel, gf_kernel
    from ceph_tpu_torch.osd import balancer
    from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher
    from ceph_tpu_torch.osd.osd_map import OSDMapMapping
    from ceph_tpu_torch.tools import erasure_code, non_regression

    t_phase = time.perf_counter()
    sections = {}
    # (a) the build, from native/'s sources, after every nvcc build; no
    # fallback: a failed build fails the run
    info = native.build()
    renamed = native.renamed_symbols()
    check(len(renamed) > 0, "the native runtime's plugins' imports renamed")
    isa = native.gf_isa()
    check(isa in ("avx2", "ssse3", "scalar"), "gf_isa is named (%s)" % isa)
    emit("native", case="build", gpu=smi, renamed=len(renamed), gf_isa=isa,
         **({"seconds": info["seconds"], "compile_s": info["compile_s"],
             "compiler": info["compiler"]} if info else {"built": False}))

    # (b) the host codec against the card's at the main path's shape
    rng = np.random.default_rng(15)
    data = rng.integers(0, 256, (BATCH, K, N), dtype=np.uint8)
    host = native.NativeCodec("jerasure", dict(PROFILE))
    card = registry.factory("torch_cuda", dict(PROFILE))
    parity = np.empty((BATCH, M, N), dtype=np.uint8)

    def host_encode():
        for b in range(BATCH):
            host.encode_chunks(data[b], parity[b])

    host_encode()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        host_encode()
    host_enc_s = (time.perf_counter() - t0) / reps
    dev_data = torch.from_numpy(data).to(dev)
    got = card.encode_batch(dev_data)
    torch.cuda.synchronize()
    check(np.array_equal(got.cpu().numpy(), parity),
          "(b) NativeCodec's encode equals torch_cuda's on the card")
    t0 = time.perf_counter()
    for _ in range(reps):
        card.encode_batch(dev_data)
    torch.cuda.synchronize()
    card_enc_s = (time.perf_counter() - t0) / reps
    full = np.concatenate([data, parity], axis=1)
    dev_full = torch.from_numpy(full).to(dev)
    decodes = {}
    for avail in ((3, 4, 5, 6, 7, 8, 9, 10), (0, 1, 2, 4, 5, 7, 9, 10),
                  (0, 1, 2, 3, 4, 5, 6, 8)):
        rows = list(avail)
        out = np.empty((BATCH, K + M, N), dtype=np.uint8)
        survivors = np.ascontiguousarray(full[:, rows])
        t0 = time.perf_counter()
        for b in range(BATCH):
            host.decode_chunks(rows, survivors[b], out[b])
        host_s = time.perf_counter() - t0
        check(np.array_equal(out, full),
              "(b) NativeCodec decodes %s" % (avail,))
        dev_surv = dev_full[:, rows].contiguous()
        dec = card.decode_batch(avail, dev_surv)
        torch.cuda.synchronize()
        check(np.array_equal(dec.cpu().numpy(), out),
              "(b) torch_cuda's decode %s equals NativeCodec's" % (avail,))
        t0 = time.perf_counter()
        for _ in range(reps):
            card.decode_batch(avail, dev_surv)
        torch.cuda.synchronize()
        card_s = (time.perf_counter() - t0) / reps
        decodes[str(avail)] = {
            "host_MBps": BATCH * K * N / host_s / 1e6,
            "card_MBps": BATCH * K * N / card_s / 1e6}
    emit("native", case="codec", gpu=smi, shape=[BATCH, K, N],
         host_encode_MBps=BATCH * K * N / host_enc_s / 1e6,
         card_encode_MBps=BATCH * K * N / card_enc_s / 1e6,
         decodes=decodes, gf_isa=isa)
    del dev_data, dev_full, got
    sections["b"] = time.perf_counter() - t_phase

    # (c) the bridge: native threads' encodes coalesced into card batches.
    # Both paths get one untimed round first (codec, pinned staging
    # buffers, stream); each call's latency is timed in its thread, apart
    # from the inverse throughput (the round's wall over its requests)
    threads, per_thread = 8, 16
    requests = threads * per_thread

    rows = [list(data[b]) for b in range(BATCH)]      # views, no copy
    want = [[parity[b, j].tobytes() for j in range(M)] for b in range(BATCH)]

    def bridge_writer(tid, lat):
        for i in range(per_thread):
            b = (tid * per_thread + i) % BATCH
            t0 = time.perf_counter()
            got = native.bridge_encode(K, M, W, "reed_sol_van", rows[b])
            lat.append(time.perf_counter() - t0)
            if got != want[b]:
                raise RuntimeError("bridge parity mismatch, object %d" % b)

    def run_threads(fn):
        lats = [[] for _ in range(threads)]
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            t0 = time.perf_counter()
            for f in [pool.submit(fn, t, lats[t]) for t in range(threads)]:
                f.result(timeout=600)
            wall = time.perf_counter() - t0
        lat = np.sort(np.concatenate([np.asarray(x) for x in lats])) * 1e3
        return wall, {"mean": float(lat.mean()),
                      "p50": float(np.percentile(lat, 50)),
                      "p99": float(np.percentile(lat, 99))}

    dispatch = native.install_cuda_dispatcher(max_batch=16,
                                              max_delay_us=2000)
    check(dispatch.device.type == "cuda", "the bridge dispatches to the card")
    run_threads(bridge_writer)                  # untimed warm-up round
    warm_batches = dispatch.batches
    warm_stages = dict(dispatch.seconds)
    b0 = native.lib().ec_tpu_batches_dispatched()
    r0 = native.lib().ec_tpu_requests_dispatched()
    gf_kernel.reset_launches()            # the bridge's path, counted from 0
    bridge_s, bridge_lat = run_threads(bridge_writer)
    bridge_launches = gf_kernel.LAUNCHES
    batches = native.lib().ec_tpu_batches_dispatched() - b0
    served = native.lib().ec_tpu_requests_dispatched() - r0
    native.uninstall_dispatcher()
    stages_ms = {st: (v - warm_stages[st]) / batches * 1e3
                 for st, v in dispatch.seconds.items()}
    check(served == requests and batches < requests,
          "(c) %d requests coalesced into %d batches" % (served, batches))
    check(bridge_launches == batches == dispatch.batches - warm_batches,
          "(c) one GF launch a batch (%d launches, %d batches)"
          % (bridge_launches, batches))
    try:
        native.bridge_encode(K, M, W, "reed_sol_van", rows[0])
        check(False, "(c) bridge_encode raises after uninstall_dispatcher")
    except OSError:
        pass
    disp = GpuDispatcher()
    expect = [parity[b:b + 1] for b in range(BATCH)]

    def disp_writer(tid, lat):
        for i in range(per_thread):
            b = (tid * per_thread + i) % BATCH
            t0 = time.perf_counter()
            got = disp.encode_async(card, data[b:b + 1]).result(300)
            lat.append(time.perf_counter() - t0)
            if not np.array_equal(got, expect[b]):
                raise RuntimeError("dispatcher parity mismatch")

    run_threads(disp_writer)                    # untimed warm-up round
    d0 = disp.stats["dispatches"]
    disp_s, disp_lat = run_threads(disp_writer)
    disp_dispatches = disp.stats["dispatches"] - d0
    disp.shutdown()
    moved = requests * K * N
    # a request's latency less its batch's callback is its wait in the
    # bridge's queue: the coalescing window (max_delay_us, waited in full
    # by a batch under max_batch), the collector's wake-up and the GIL
    emit("native", case="bridge", gpu=smi, threads=threads,
         requests=requests, chunk_bytes=N, batches=batches,
         requests_per_batch=served / batches,
         gf_launches=bridge_launches, max_delay_us=2000,
         bridge_latency_ms=bridge_lat,
         bridge_inverse_throughput_ms=bridge_s / requests * 1e3,
         bridge_MBps=moved / bridge_s / 1e6,
         bridge_callback_ms_per_batch=stages_ms,
         bridge_queue_wait_ms=bridge_lat["mean"] - sum(stages_ms.values()),
         bridge_wall_s=bridge_s,
         dispatcher_latency_ms=disp_lat,
         dispatcher_inverse_throughput_ms=disp_s / requests * 1e3,
         dispatcher_MBps=moved / disp_s / 1e6,
         dispatcher_dispatches=disp_dispatches)
    sections["c"] = time.perf_counter() - t_phase

    # (d) placement: the native host mapper beside the straw2 kernel
    m, _, _ = placement_cluster(np)

    def remap(**kw):
        mapping = OSDMapMapping()
        t0 = time.perf_counter()
        mapping.update(m, **kw)
        return mapping, (time.perf_counter() - t0) * 1e3

    remap(native=True)                     # flatten and cache the map
    remap()
    crush_kernel.reset_launches()
    host_map, host_ms = remap(native=True)
    check(crush_kernel.LAUNCHES == 0, "(d) update(native=True) launched "
          "no straw2 kernel")
    card_map, card_ms = remap()
    check({p: s["path"] for p, s in host_map.split.items()} ==
          {1: "native", 2: "native"}, "(d) both pools took the native path")
    check(host_map.by_pg == card_map.by_pg and
          host_map.by_osd == card_map.by_osd,
          "(d) update(native=True) maps as update() on the card")
    for pool_id in m.pools:
        check(np.array_equal(host_map.raw[pool_id], card_map.raw[pool_id]),
              "(d) pool %d's raw result equal" % pool_id)
    t0 = time.perf_counter()
    res_n = balancer.calc_pg_upmaps(m, max_changes=16, changes_per_sweep=16,
                                    use_native=True)
    bal_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_d = balancer.calc_pg_upmaps(m, max_changes=16, changes_per_sweep=16,
                                    use_device=True)
    bal_card_s = time.perf_counter() - t0

    def proposal(r):
        return (r.num_changed, r.start_deviation, r.end_deviation, r.sweeps,
                list(r.new_pg_upmap_items.items()),
                list(r.old_pg_upmap_items))

    check(res_n.num_changed > 0 and proposal(res_n) == proposal(res_d),
          "(d) calc_pg_upmaps(use_native=True) proposes as use_device=True")
    emit("native", case="placement", gpu=smi,
         pgs=sum(p.pg_num for p in m.pools.values()),
         native_update_ms=host_ms, card_update_ms=card_ms,
         native_sweep_ms={p: s["sweep_ms"] for p, s in host_map.split.items()},
         native_mapper_ms={p: s["mapper_ms"]
                           for p, s in host_map.split.items()},
         card_sweep_ms={p: s["sweep_ms"] for p, s in card_map.split.items()},
         balancer_changes=res_n.num_changed, balancer_sweeps=res_n.sweeps,
         balancer_native_s=bal_native_s, balancer_card_s=bal_card_s)
    sections["d"] = time.perf_counter() - t_phase

    # (e) the two erasure-code CLIs, on the card and the host codec
    def tool(mod, *argv):
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = mod.main([str(a) for a in argv])
        return rc, buf.getvalue(), err.getvalue()

    rc, out, _ = tool(erasure_code, "--plugin_exists", "torch_cuda")
    check(rc == 0 and out == "", "(e) --plugin_exists torch_cuda")
    rc, out, _ = tool(erasure_code, "--all", "-P", "plugin=torch_cuda",
                      "-P", "k=8", "-P", "m=3")
    check(rc == 0 and out.splitlines() == [
        "get_chunk_size(1024)\t128", "get_data_chunk_count\t8",
        "get_coding_chunk_count\t3", "get_chunk_count\t11"],
        "(e) --all of torch_cuda k=8 m=3 (%r)" % out)
    base = ROOT / "chiprun_out" / "ec_corpus"
    shutil.rmtree(base, ignore_errors=True)
    params = ["-P", "technique=reed_sol_van", "-P", "k=8", "-P", "m=3",
              "--stripe-width", 1 << 20, "--base", base]
    corpus = {}
    for writer, checker in (("torch_cuda", "jerasure"),
                            ("jerasure", "torch_cuda")):
        rc, _, err = tool(non_regression, "--plugin", writer, *params,
                          "--create")
        check(rc == 0, "(e) --create with %s (%s)" % (writer, err))
        nr = {p: non_regression.NonRegression(
            non_regression.build_parser().parse_args(
                [str(a) for a in ["--plugin", p, *params]]))
            for p in (writer, checker)}
        shutil.copytree(nr[writer].directory, nr[checker].directory)
        rc, _, err = tool(non_regression, "--plugin", checker, *params,
                          "--check")
        check(rc == 0, "(e) a %s corpus passes --check with %s (%s)"
              % (writer, checker, err))
        corpus[writer + "->" + checker] = rc
        shutil.rmtree(base)
    tool(non_regression, "--plugin", "torch_cuda", *params, "--create")
    nr = non_regression.NonRegression(non_regression.build_parser()
                                      .parse_args([str(a) for a in [
                                          "--plugin", "torch_cuda",
                                          *params]]))
    path = Path(nr.chunk_path(9))
    buf = bytearray(path.read_bytes())
    buf[100] ^= 0x5A
    path.write_bytes(bytes(buf))
    rc, _, err = tool(non_regression, "--plugin", "torch_cuda", *params,
                      "--check")
    check(rc == 1 and "chunk 9 encodes differently" in err,
          "(e) a corrupted chunk fails --check (%s)" % err.strip())
    shutil.rmtree(base)
    emit("native", case="tools", gpu=smi, corpus=corpus,
         corrupted_check_rc=rc, phase_s=time.perf_counter() - t_phase,
         sections_s=sections)
    return {"bridge_launches": bridge_launches, "bridge_batches": batches,
            "bridge_requests": requests}


def ec_backend_phase(np, torch, dev, smi):
    """Phase 16: the OSD's erasure-coded backend on the card, driven
    through ECBackend's entry points in a loopback PG
    (``tests/torch_ec_loopback.py``: one PG of n in-process OSDs, each
    with its own MemStore, backend and delivery thread, standing in for
    the reference's PG, OSD daemon and messenger). Every kernel launch
    counter is set to 0 just before the phase and read after it. (a) RS
    reed_sol_van k=8, m=3 at stripe_unit 4096 (stripe width 32 KiB), 11
    shard OSDs, the primary's daemon with a ``GpuDispatcher`` and an
    ``HbmChunkTier`` of the default 64 objects on cuda:0 in fused mode
    "store": 64 whole-object writes of 4 MiB from 8 client threads, every
    object read whole with ``hbm_serve_reads`` on (served from the tier:
    no sub-read), one shard an object rebuilt from the tier
    (``recover_object``; then the same shards in one
    ``reconstruct_batch``, the OSD's coalesced shape), a bitrot mark on
    one shard caught by the read path's crc check (reconstructed around,
    repaired), 256 overwrites of 4-64 KiB at random offsets from 8
    threads (RMW readbacks through sub-reads and the extent cache, two in
    flight a thread), 64 appends of 64 KiB, every object read whole and
    256 ranges of 4 KiB-1 MiB against a host model of its bytes, degraded
    reads of every object with shard OSDs 1, then 1-2, then 1-3 down
    (one down: ec_util's single-erasure XOR shortcut on the host; two
    and three: a decode op on the dispatcher an object, a bit-sliced
    launch a dispatch, each checked), and one shard an object rebuilt
    with the tier off (sub-reads and a decode); a second pool in fused
    mode "compress" with 16 objects of 4 MiB of values 0..3 (each stored
    compressed), read back through the decompression. (b) MSR k=8, m=7
    (alpha 7, d 14; phase 11's configuration), 15 shard OSDs each with
    its own dispatcher: 16 objects of 4 MiB, one shard an object rebuilt
    from the tier (``_tier_reconstruct_striped`` on the card) and one
    with the tier off, through ``_try_repair``'s 14 helper fractions
    (each computed on its helper's dispatcher) and ``repair_combine``.
    Checks: every read equal to the model, every rebuilt shard to the
    shard its store holds, every shard store's chunk streams at the end
    to ``ec_util.encode`` of the model through the plain versions on the
    CPU, and the GF kernel's bit-sliced and mma designs, the per-lane GF
    kernel, K1-K3 and the tier's rebuild each launched. Nothing is cut.
    Returns the phase's launches per kernel and its numbers."""
    import concurrent.futures

    from ceph_tpu_torch import registry
    from ceph_tpu_torch.common.tracer import SpanCollector
    from ceph_tpu_torch.common.workqueue import SafeTimer
    from ceph_tpu_torch.ops import gf_kernel
    from ceph_tpu_torch.ops import write_kernels as wk
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.ec_backend import ECBackend
    from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher
    from ceph_tpu_torch.osd.hbm_tier import HbmChunkTier
    from ceph_tpu_torch.osd.pg_log import PGLog, entry_from_tuple
    from ceph_tpu_torch.osd.pg_transaction import PGTransaction
    from ceph_tpu_torch.store import MemStore, Transaction
    from tests.torch_ec_loopback import Loopback

    sz = EC_BACKEND
    obj = sz["object_bytes"]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(16)
    pool = concurrent.futures.ThreadPoolExecutor(8)
    loopbacks, dispatchers = [], []

    def run8(fn, items):
        """fn over items from 8 client threads, items of object i on
        thread i % 8 in order; returns the wall seconds."""
        lanes = [[] for _ in range(8)]
        for item in items:
            lanes[item[0] % 8].append(item)
        t0 = time.perf_counter()
        for f in [pool.submit(lambda lane=lane: [fn(it) for it in lane])
                  for lane in lanes]:
            f.result()
        return time.perf_counter() - t0

    def loopback(codec, width, mode, all_dispatch=False, pgid="1.0",
                 disp=None, tier=None, tracer=None):
        n = codec.get_chunk_count()
        disps = {0: disp} if disp is not None else {}
        for o in range(n) if all_dispatch else (0,):
            if o not in disps:
                disps[o] = GpuDispatcher(device=dev)
                dispatchers.append(disps[o])
        lb = Loopback(ECBackend=ECBackend, MemStore=MemStore,
                      Transaction=Transaction, PGLog=PGLog,
                      entry_from_tuple=entry_from_tuple,
                      SafeTimer=SafeTimer,
                      tracer=tracer or SpanCollector(), codec=codec,
                      stripe_width=width, dispatchers=disps, tier=tier,
                      fused_mode=mode, pgid=pgid)
        loopbacks.append(lb)
        return lb, disps[0]

    def padded(data, width):
        out = bytearray(data)
        out.extend(b"\0" * (-len(out) % width))
        return out

    def launches():
        return {"gf": gf_kernel.launches_by_design(),
                "per_lane": gf_kernel.launches_by_design(multi=True),
                "write": dict(wk.LAUNCHES)}

    def since(before):
        now = launches()
        return {part: {k: now[part][k] - before[part][k]
                       for k in now[part]} for part in now}

    def sub_reads(lb, before):
        return lb.sent.get("MOSDECSubOpRead", 0) - before

    def rebuild_all(lb, oids, label):
        """recover_object of shard i % n of object i, one after another:
        (ms an object, {oid: (shard, bytes)})."""
        got = {}
        t0 = time.perf_counter()
        for i, oid in enumerate(oids):
            shard = i % lb.n
            data = lb.recover(oid, shard)
            check(data is not None and data == lb.shard_store(shard).read(
                lb.cid(shard), oid), "%s: %s's shard %d rebuilt equal to "
                  "its store" % (label, oid, shard))
            got[oid] = (shard, data)
        return (time.perf_counter() - t0) * 1e3 / len(oids), got

    def check_stores(lb, model, plain, label):
        """Every shard store's chunk streams equal ec_util.encode of the
        model through the plain versions on the CPU."""
        sinfo = lb.primary.backend.sinfo
        for oid, data in model.items():
            want = ec_util.encode(sinfo, plain, np.frombuffer(
                bytes(data), dtype=np.uint8))
            for shard in range(lb.n):
                check(lb.shard_store(shard).read(lb.cid(shard), oid) ==
                      want[shard].tobytes(), "%s: %s shard %d equals the "
                      "plain encode of the model" % (label, oid, shard))

    try:
        gf_kernel.reset_launches()
        wk.reset_launches()
        # -- (a) RS k=8, m=3, the OSD's pool ---------------------------
        codec = registry.factory("torch_cuda", dict(PROFILE))
        plain = registry.factory("torch_cuda", dict(PROFILE), device="cpu")
        width = K * codec.get_chunk_size(4096 * K)
        check(width == 32768, "stripe width 32 KiB")
        disp = GpuDispatcher(device=dev)
        dispatchers.append(disp)
        tier = HbmChunkTier(device=dev)
        tracer = SpanCollector()
        lb, _ = loopback(codec, width, "store", disp=disp, tier=tier,
                         tracer=tracer)
        # the primary's dispatcher records its legs under the op's span
        disp.tracer = tracer
        oids = ["rbd_data.%04d" % i for i in range(sz["writes"])]
        datas = [rng.integers(0, 256, obj, dtype=np.uint8).tobytes()
                 for _ in oids]
        model = {oid: padded(d, width) for oid, d in zip(oids, datas)}

        def write(item):
            i, oid, data = item
            t = PGTransaction()
            t.create(oid)
            t.write(oid, 0, data)
            lb.submit(t)

        wall = run8(write, [(i, oid, datas[i])
                            for i, oid in enumerate(oids)])
        lb.drain()
        del datas
        resident = tier.stats()["resident_objects"]
        check(resident == len(oids), "every written object resident "
              "(%d)" % resident)
        rs = {"writes": len(oids), "writes_per_s": len(oids) / wall,
              "write_s": wall}
        emit("ec_backend", case="writes", gpu=smi, **rs,
             resident=resident, dispatcher=dict(disp.stats))

        # where a write's time goes: the first 16 objects rewritten whole
        # one at a time from one client, each under a traced op; the
        # spans' mean ms by name (the encode and the dispatcher's legs,
        # each shard's sub-write round trip, the replicas' apply)
        tracer.enabled = True
        walls = []
        for oid in oids[:16]:
            data = rng.integers(0, 256, obj, dtype=np.uint8).tobytes()
            model[oid] = padded(data, width)
            t = PGTransaction()
            t.write(oid, 0, data)
            root = tracer.start_trace("client_write")
            t0 = time.perf_counter()
            lb.submit_async(t, trace=root).result()
            walls.append(time.perf_counter() - t0)
            root.finish()
        lb.drain()
        tracer.enabled = False
        spans: dict = {}
        for rec in tracer.dump():
            spans.setdefault(rec["name"].split("(")[0], []).append(
                rec["duration"] * 1e3)
        rs["write_alone_ms"] = statistics.median(walls) * 1e3
        rs["write_spans_ms"] = {name: statistics.mean(d)
                                for name, d in sorted(spans.items())}
        rs["write_span_counts"] = {name: len(d)
                                   for name, d in sorted(spans.items())}
        emit("ec_backend", case="write_trace", gpu=smi,
             write_alone_ms=rs["write_alone_ms"],
             spans_ms=rs["write_spans_ms"],
             span_counts=rs["write_span_counts"])

        def read_whole(item):
            i, oid = item
            got = lb.read(oid)
            check(got == bytes(model[oid]), "read of %s equals the model"
                  % oid)

        # every object whole from the tier: no sub-read
        lb.primary.daemon.hbm_serve_reads = True
        s0, h0 = lb.sent.get("MOSDECSubOpRead", 0), tier.stats()["hits"]
        wall = run8(read_whole, list(enumerate(oids)))
        lb.primary.daemon.hbm_serve_reads = False
        check(sub_reads(lb, s0) == 0 and
              tier.stats()["hits"] - h0 == len(oids),
              "reads served from the tier, no sub-read")
        rs["tier_read_MBps"] = sum(len(model[oid]) for oid in oids) \
            / wall / 1e6
        # one shard an object rebuilt from the tier, then the same
        # shards in one coalesced launch
        before, s0 = launches(), lb.sent.get("MOSDECSubOpRead", 0)
        rs["tier_rebuild_ms"], rebuilt = rebuild_all(lb, oids, "tier")
        check(sub_reads(lb, s0) == 0, "tier rebuilds sent no sub-read")
        keys = [(lb.pgid, oid) for oid in oids]
        t0 = time.perf_counter()
        rows = tier.reconstruct_batch(keys, [rebuilt[oid][0]
                                             for oid in oids]).cpu().numpy()
        rs["tier_rebuild_batch_ms"] = (time.perf_counter() - t0) * 1e3
        for j, oid in enumerate(oids):
            check(rows[j].tobytes() == rebuilt[oid][1],
                  "reconstruct_batch equals recover_object (%s)" % oid)
        tier_rebuild = since(before)
        check(tier_rebuild["gf"]["bitsliced"] >= len(oids) and
              tier_rebuild["per_lane"]["bitsliced"] >= 1,
              "the tier's rebuild launched the GF kernel an object and "
              "the per-lane kernel once: %s" % tier_rebuild)
        emit("ec_backend", case="tier", gpu=smi,
             tier_read_MBps=rs["tier_read_MBps"],
             tier_rebuild_ms=rs["tier_rebuild_ms"],
             tier_rebuild_batch_ms=rs["tier_rebuild_batch_ms"],
             launches=tier_rebuild)

        # bitrot on one shard: the crc check reconstructs around it and
        # the read path repairs it
        victim = oids[0]
        lb.shard_store(1).faults.mark_bitrot(lb.cid(1), victim)
        check(lb.read(victim) == bytes(model[victim]),
              "a read around a bitrotten shard equals the model")
        lb.drain()
        check((victim, 1, 1) in lb.repaired and
              lb.primary.daemon.perf.get("read_err") >= 1,
              "the bitrotten shard was caught and repaired")

        # overwrites: RMW readbacks, two in flight a thread
        lo, hi = sz["overwrite_bytes"]
        jobs = []
        for _ in range(sz["overwrites"]):
            i = int(rng.integers(0, len(oids)))
            length = int(rng.integers(lo, hi + 1))
            off = int(rng.integers(0, obj - length))
            data = rng.integers(0, 256, length, dtype=np.uint8).tobytes()
            model[oids[i]][off:off + length] = data
            jobs.append((i, off, data))
        lanes = [[j for j in jobs if j[0] % 8 == t] for t in range(8)]
        latencies = []
        s0 = lb.sent.get("MOSDECSubOpRead", 0)

        def overwrite_lane(lane):
            ops = []
            for i, off, data in lane:
                t = PGTransaction()
                t.write(oids[i], off, data)
                ops.append(lb.submit_async(t))
                if len(ops) == 2:
                    op = ops.pop(0)
                    op.result()
                    latencies.append(op.seconds)
            for op in ops:
                op.result()
                latencies.append(op.seconds)

        t0 = time.perf_counter()
        for f in [pool.submit(overwrite_lane, lane) for lane in lanes]:
            f.result()
        wall = time.perf_counter() - t0
        lb.drain()
        check(sub_reads(lb, s0) > 0, "the overwrites read back through "
              "sub-reads")
        lat = sorted(latencies)
        rs.update(rmw_ops=len(lat), rmw_p50_ms=lat[len(lat) // 2] * 1e3,
                  rmw_p99_ms=lat[min(len(lat) - 1,
                                     int(len(lat) * 0.99))] * 1e3,
                  rmw_per_s=len(lat) / wall)

        def append(item):
            i, data = item
            oid = oids[i]
            off = len(model[oid])
            t = PGTransaction()
            t.write(oid, off, data)
            model[oid][off:off + len(data)] = data
            model[oid].extend(b"\0" * (-len(model[oid]) % width))
            lb.submit(t)

        run8(append, [(i % len(oids), rng.integers(
            0, 256, sz["append_bytes"], dtype=np.uint8).tobytes())
            for i in range(sz["appends"])])
        lb.drain()
        emit("ec_backend", case="rmw", gpu=smi,
             **{k: rs[k] for k in ("rmw_ops", "rmw_p50_ms", "rmw_p99_ms",
                                   "rmw_per_s")},
             appends=sz["appends"], dispatcher=dict(disp.stats))

        # reads: every object whole and random ranges
        nbytes = sum(len(m) for m in model.values())
        rs["read_MBps"] = nbytes / run8(read_whole,
                                        list(enumerate(oids))) / 1e6
        ranges = []
        for _ in range(sz["ranges"]):
            i = int(rng.integers(0, len(oids)))
            size = len(model[oids[i]])
            length = int(rng.integers(4096, min(1 << 20, size) + 1))
            off = int(rng.integers(0, size - length + 1))
            ranges.append((i, off, length))

        def read_range(item):
            i, off, length = item
            check(lb.read(oids[i], off, length) ==
                  bytes(model[oids[i]][off:off + length]),
                  "range read of %s equals the model" % oids[i])

        wall = run8(read_range, ranges)
        rs["range_read_MBps"] = sum(r[2] for r in ranges) / wall / 1e6
        # degraded reads: one shard down takes ec_util's single-erasure
        # XOR shortcut on the host (as the reference's does); with two
        # and three down each object read is a decode op on the
        # dispatcher, and each dispatch of them a launch of the GF
        # kernel's bit-sliced design
        rs["degraded_read_MBps"], rs["degraded_launches"] = {}, {}
        for down in ((1,), (1, 2), (1, 2, 3)):
            name = "-".join(map(str, down))
            lb.mark_down(*down)
            before = launches()
            ops0, disp0 = disp.stats["ops"], disp.stats["dispatches"]
            xor0 = codec.xor_fast_hits
            try:
                rs["degraded_read_MBps"][name] = \
                    nbytes / run8(read_whole, list(enumerate(oids))) / 1e6
            finally:
                lb.mark_up(*down)
            got = {"decode_ops": disp.stats["ops"] - ops0,
                   "dispatches": disp.stats["dispatches"] - disp0,
                   "bitsliced": since(before)["gf"]["bitsliced"],
                   "xor_shortcuts": codec.xor_fast_hits - xor0}
            rs["degraded_launches"][name] = got
            if len(down) == 1:
                check(got["xor_shortcuts"] >= len(oids),
                      "degraded reads with OSD 1 down took the XOR "
                      "shortcut (%r)" % got)
            else:
                check(got["decode_ops"] >= len(oids) and
                      got["bitsliced"] >= got["dispatches"] >= 1,
                      "degraded reads with OSDs %s down decoded through "
                      "the dispatcher on the GF kernel (%r)" % (name, got))
        emit("ec_backend", case="reads", gpu=smi,
             read_MBps=rs["read_MBps"],
             range_read_MBps=rs["range_read_MBps"],
             degraded_read_MBps=rs["degraded_read_MBps"],
             degraded_launches=rs["degraded_launches"])
        # rebuild with the tier off: sub-reads and a decode
        lb.primary.daemon.hbm_tier = None
        s0 = lb.sent.get("MOSDECSubOpRead", 0)
        rs["rebuild_ms"], _ = rebuild_all(lb, oids, "rebuild")
        check(sub_reads(lb, s0) > 0, "rebuilds with the tier off read "
              "the survivors")
        lb.primary.daemon.hbm_tier = tier
        lb.drain()
        t0 = time.perf_counter()
        check_stores(lb, model, plain, "rs")
        rs["store_check_s"] = time.perf_counter() - t0
        rs["dispatcher"] = dict(disp.stats)
        rs["ops_per_dispatch"] = disp.stats["ops"] / max(
            1, disp.stats["dispatches"])
        emit("ec_backend", case="rebuild", gpu=smi,
             rebuild_ms=rs["rebuild_ms"], store_check_s=rs["store_check_s"],
             dispatcher=rs["dispatcher"],
             ops_per_dispatch=rs["ops_per_dispatch"])

        # the compress pool on the same daemon's dispatcher and tier
        clb, _ = loopback(codec, width, "compress", pgid="2.0", disp=disp,
                          tier=tier)
        coids = ["cmp.%02d" % i for i in range(sz["compress"])]
        cdatas = {oid: rng.integers(0, 4, obj, dtype=np.uint8).tobytes()
                  for oid in coids}

        def cwrite(item):
            i, oid = item
            t = PGTransaction()
            t.create(oid)
            t.write(oid, 0, cdatas[oid])
            clb.submit(t)

        wall = run8(cwrite, list(enumerate(coids)))
        clb.drain()
        stored = 0
        sinfo = clb.primary.backend.sinfo
        for oid in coids:
            h = clb.primary.backend.get_hinfo(oid)
            check(h.comp_info is not None, "%s stored compressed" % oid)
            stored += h.get_total_chunk_size() * K
            streams = [clb.shard_store(s).read(clb.cid(s), oid)
                       for s in range(clb.n)]
            container = np.stack([np.frombuffer(st, dtype=np.uint8).reshape(
                -1, sinfo.chunk_size) for st in streams[:K]], axis=1)
            want = ec_util.encode(sinfo, plain, container.reshape(-1))
            check(all(streams[s] == want[s].tobytes()
                      for s in range(clb.n)),
                  "%s's shards equal the plain encode of its container"
                  % oid)

        def cread(item):
            i, oid = item
            check(clb.read(oid)[:obj] == cdatas[oid],
                  "%s reads back through the decompression" % oid)

        rwall = run8(cread, list(enumerate(coids)))
        compress = {"objects": len(coids), "writes_per_s": len(coids) /
                    wall, "read_MBps": len(coids) * obj / rwall / 1e6,
                    "stored_ratio": stored / (len(coids) * obj)}
        emit("ec_backend", case="compress", gpu=smi, **compress)

        # -- (b) MSR k=8, m=7 ------------------------------------------
        mprof = {"k": "8", "m": "7", "w": "8"}
        mcodec = registry.factory("msr_cuda", mprof)
        mplain = registry.factory("msr_cuda", mprof, device="cpu")
        mwidth = K * mcodec.get_chunk_size(4096 * K)
        mtier = HbmChunkTier(device=dev)
        mlb, mdisp = loopback(mcodec, mwidth, None, all_dispatch=True,
                              pgid="3.0", tier=mtier)
        moids = ["msr.%02d" % i for i in range(sz["msr"])]
        mdatas = {oid: rng.integers(0, 256, obj, dtype=np.uint8).tobytes()
                  for oid in moids}
        mmodel = {oid: padded(d, mwidth) for oid, d in mdatas.items()}

        def mwrite(item):
            i, oid = item
            t = PGTransaction()
            t.create(oid)
            t.write(oid, 0, mdatas[oid])
            mlb.submit(t)

        wall = run8(mwrite, list(enumerate(moids)))
        mlb.drain()
        check(mtier.stats()["resident_objects"] == len(moids),
              "every MSR object resident")
        before = launches()
        msr = {"objects": len(moids), "writes_per_s": len(moids) / wall}
        msr["tier_rebuild_ms"], _ = rebuild_all(mlb, moids, "msr tier")
        torch.cuda.synchronize()
        msr_tier = since(before)
        check(msr_tier["gf"]["mma"] >= len(moids),
              "the striped tier rebuild decoded on the mma design: %s"
              % msr_tier)
        mlb.primary.daemon.hbm_tier = None
        s0 = mlb.sent.get("MOSDECSubOpRead", 0)
        r0 = mlb.sent.get("MOSDECSubOpRepairRead", 0)
        msr["repair_ms"], _ = rebuild_all(mlb, moids, "msr repair")
        mlb.drain()
        check(sub_reads(mlb, s0) == 0 and
              mlb.sent.get("MOSDECSubOpRepairRead", 0) - r0 >=
              13 * len(moids), "MSR rebuilt through helper fractions")
        mlb.primary.daemon.hbm_tier = mtier
        shipped = sum(o.daemon.perf.get("l_osd_repair_bytes_shipped")
                      for o in mlb.osds)
        chunk_total = mlb.primary.backend.get_hinfo(
            moids[0]).get_total_chunk_size()
        msr["repair_bytes"] = shipped
        msr["full_decode_bytes"] = K * chunk_total * len(moids)
        msr["traffic_ratio"] = shipped / msr["full_decode_bytes"]
        check(msr["traffic_ratio"] < 0.3, "MSR's repair moved under 0.3 "
              "of a full decode's bytes")
        for oid, data in mdatas.items():
            check(mlb.read(oid)[:obj] == data, "MSR read of %s" % oid)
        check_stores(mlb, mmodel, mplain, "msr")
        msr["dispatcher"] = dict(mdisp.stats)
        emit("ec_backend", case="msr", gpu=smi, **msr, launches=msr_tier)

        phase = launches()      # counted from 0 at the phase's start
        check(phase["gf"]["bitsliced"] > 0 and phase["gf"]["mma"] > 0 and
              phase["per_lane"]["bitsliced"] > 0 and
              all(phase["write"].values()),
              "the phase launched the GF kernel's bit-sliced and mma "
              "designs, the per-lane kernel and K1-K3: %s" % phase)
        seconds = time.perf_counter() - t_phase
        emit("ec_backend", case="launches", gpu=smi, launches=phase,
             seconds=seconds)
        return {"launches": phase, "tier_rebuild": tier_rebuild,
                "msr_tier": msr_tier, "rs": rs, "compress": compress,
                "msr": msr, "seconds": seconds}
    finally:
        for lb_ in loopbacks:
            lb_.shutdown()
        for d in dispatchers:
            d.shutdown()
        pool.shutdown()


def pg_phase(np, torch, dev, smi):
    """Phase 17: the PG on the card (``ceph_tpu_torch/osd/pg.py``), driven
    through its entry points (``do_op``, map epochs, ``scrub_pg``,
    ``repair_shard``) on loopback daemons (``tests/torch_pg_loopback.py``:
    each with its own MemStore, FIFO thread and timer, ``home_device`` the
    card, a ``GpuDispatcher`` and an ``HbmChunkTier`` of the default 64
    objects there). Every launch counter is set to 0 just before the phase
    and read after it.

    (a) RS reed_sol_van k=8, m=3 (``torch_cuda``) at stripe_unit 4096, 12
    OSDs and one pool of 8 PGs (size 11, min_size 9), fused mode "store":
    128 whole writes of 4 MiB from 8 client threads, 256 overwrites of
    4-64 KiB at random offsets (RMW pre-reads), 8 objects written under a
    snapshot context (each head cloned), every object read whole and 256
    ranges against a host model; OSD A down (the PGs peer around it), 32
    writes degraded, every object read (a lost data shard takes the host's
    XOR shortcut), OSD B down too, 8 writes, every object read (two
    erasures: decoded through the dispatcher), both up (log recovery),
    OSD C out (the PGs remap and bring their new members up to date),
    every head and clone read (a remap that moves an OSD to another shard
    leaves that shard's objects missing there until a read or a scrub
    repairs them, in the reference too), a deep scrub with repair of every
    PG (its counts printed), 32 new objects written (resident, their
    hinfo crcs valid), bitrot on two of their shards (one a
    primary's, hashed by K1 on the card), a deep scrub with repair, a
    second deep scrub, bitrot on four more shards rebuilt through
    ``repair_shard`` from the tier, then the same four rebuilt again by
    their primaries' tiers in one ``reconstruct_batch`` a tier (the PG
    rebuilds one object at a time, as the reference; the batched call is
    the tier's own); then, with every daemon's fused mode
    switched to "compress", a second pool of 2 PGs with 8 low-entropy
    objects (K3). (b) MSR k=8, m=7 (``msr_cuda``), 16 OSDs and a pool of 2
    PGs: 16 objects of 4 MiB, bitrot on one shard repaired by a deep scrub
    (the tier's striped rebuild), then on another with the primary's tier
    detached, rebuilt by ``repair_shard`` through the helpers' fractions.

    Checks: every op returned 0 and every read equals the model; each
    deep scrub after the bitrot found and repaired exactly what was
    injected, and the second finds nothing; every acting shard store
    equals ``ec_util.encode`` of the model through the plain versions on
    the CPU; the GF kernel's bit-sliced design launched in the degraded
    reads, in recovery, in each deep-scrub repair and each
    ``repair_shard`` from the tier (with no sub-read), the per-lane
    kernel in the tiers' batched rebuild (its rows equal to the plain
    encode), K1-K3 in the writes, K1 in the deep scrub and the mma design
    in (b). Nothing is cut. Returns the phase's launches
    per kernel and its numbers."""
    import concurrent.futures
    import types

    from ceph_tpu_torch import registry
    from ceph_tpu_torch.common.reserver import AsyncReserver
    from ceph_tpu_torch.common.tracer import SpanCollector
    from ceph_tpu_torch.common.workqueue import SafeTimer
    from ceph_tpu_torch.msg.message import MOSDOp, MWatchNotifyAck
    from ceph_tpu_torch.ops import gf_kernel
    from ceph_tpu_torch.ops import write_kernels as wk
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd import osd_map
    from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher
    from ceph_tpu_torch.osd.hbm_tier import HbmChunkTier
    from ceph_tpu_torch.osd.pg import PG
    from ceph_tpu_torch.store import MemStore
    from ceph_tpu_torch.tools.crushtool import build_map
    from tests.torch_pg_loopback import Cluster
    from tests.torch_pg_scenario import store_mismatches, stripe_width

    sz = PG_PHASE
    obj = sz["object_bytes"]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(17)
    pool = concurrent.futures.ThreadPoolExecutor(8)
    pkg = types.SimpleNamespace(
        PG=PG, OSDMap=osd_map.OSDMap, Incremental=osd_map.Incremental,
        PGPool=osd_map.PGPool, PGID=osd_map.PGID,
        POOL_TYPE_ERASURE=osd_map.POOL_TYPE_ERASURE,
        POOL_TYPE_REPLICATED=osd_map.POOL_TYPE_REPLICATED,
        build_crush=build_map, MemStore=MemStore, SafeTimer=SafeTimer,
        AsyncReserver=AsyncReserver, MOSDOp=MOSDOp,
        MWatchNotifyAck=MWatchNotifyAck, SpanCollector=SpanCollector)
    clusters, dispatchers = [], []

    def cluster(n, mode):
        def make_dispatcher(osd):
            dispatchers.append(GpuDispatcher(device=dev))
            return dispatchers[-1]

        cl = Cluster(pkg, n, home_device=dev,
                     make_dispatcher=make_dispatcher,
                     make_tier=lambda osd: HbmChunkTier(device=dev),
                     fused_mode=mode)
        clusters.append(cl)
        return cl

    def launches():
        return {"gf": gf_kernel.launches_by_design(),
                "per_lane": gf_kernel.launches_by_design(multi=True),
                "write": dict(wk.LAUNCHES)}

    def since(before):
        now = launches()
        return {part: {k: now[part][k] - before[part][k]
                       for k in now[part]} for part in now}

    def run8(fn, items):
        """fn over items from 8 client threads, items of object i on
        thread i % 8 in order; returns the wall seconds."""
        lanes = [[] for _ in range(8)]
        for item in items:
            lanes[item[0] % 8].append(item)
        t0 = time.perf_counter()
        for f in [pool.submit(lambda lane=lane: [fn(it) for it in lane])
                  for lane in lanes]:
            f.result()
        return time.perf_counter() - t0

    def call(cl, pool_id, oid, ops, **kw):
        op = cl.submit(pool_id, oid, ops, **kw)
        result, data = op.result()
        check(result == 0, "%s on %s returned %d" % (ops[0][0], oid,
                                                     result))
        return data, op.seconds

    def write_all(cl, pool_id, model, items):
        """writefull of (i, oid, bytes) from 8 threads into the model."""
        def write(item):
            i, oid, data = item
            call(cl, pool_id, oid, [("writefull", data)])
            model[oid] = bytearray(data)
        return run8(write, items)

    def read_all(cl, pool_id, model, clones=()):
        """Every object (and clone, at its snap) whole against the model;
        returns (bytes read, wall seconds)."""
        items = [(i, oid, 0) for i, oid in enumerate(sorted(model))]
        items += [(i, c.split("@")[0], int(c.split("@")[1]))
                  for i, c in enumerate(sorted(clones))]

        def read(item):
            _, oid, snap = item
            data, _ = call(cl, pool_id, oid, [("read", 0, 0)], snap=snap)
            want = clones["%s@%d" % (oid, snap)] if snap else model[oid]
            check(bytes(data) == bytes(want), "read of %s (snap %d) "
                  "equals the model" % (oid, snap))
        wall = run8(read, items)
        return sum(len(model[o]) for o in model) + sum(
            len(clones[c]) for c in clones), wall

    def xor_hits(cl, pool_id):
        return sum(pg.backend.codec.xor_fast_hits
                   for d in cl.daemons for pgid, pg in list(d.pgs.items())
                   if pgid.pool == pool_id)

    def disp_stats():
        return {k: sum(d.stats[k] for d in dispatchers)
                for k in ("ops", "dispatches")}

    def perf(cl, name):
        return cl.perf_totals().get(name, 0)

    def plain_encoder(profile, width):
        plain = registry.factory(profile["plugin"], dict(profile),
                                 device="cpu")
        sinfo = ec_util.StripeInfo(plain.get_data_chunk_count(), width)

        def encode(data):
            buf = bytearray(data)
            buf.extend(b"\0" * (-len(buf) % width))
            shards = ec_util.encode(sinfo, plain, np.frombuffer(
                bytes(buf), dtype=np.uint8))
            return [shards[i].tobytes() for i in range(len(shards))]
        return encode

    def mark_bitrot(cl, pool_id, oid, pos):
        pgid = cl.pgid_of(pool_id, oid)
        acting, _ = cl.acting(pgid)
        cl.daemons[acting[pos]].store.faults.mark_bitrot(
            ("pg", str(pgid), pos), oid)
        return pgid, acting[pos]

    def scrub(cl, pool_id, repair):
        t0 = time.perf_counter()
        stats = cl.scrub(pool_id, deep=True, repair=repair)
        wall = time.perf_counter() - t0
        found = sum(s.get("errors", 0) for s in stats.values())
        fixed = sum(s.get("repaired", 0) for s in stats.values())
        check(all(s.get("state") in ("clean", "inconsistent")
                  for s in stats.values()), "every deep scrub finished: %r"
              % stats)
        return found, fixed, stats, wall

    try:
        gf_kernel.reset_launches()
        wk.reset_launches()
        # -- (a) RS k=8, m=3 on 12 OSDs, 8 PGs --------------------------
        profile = dict(PROFILE, plugin="torch_cuda")
        codec = registry.factory("torch_cuda", dict(PROFILE), device=dev)
        width = stripe_width(codec, 4096)
        check(width == 32768, "stripe width 32 KiB")
        encode = plain_encoder(profile, width)
        cl = cluster(sz["osds"], "store")
        rs = {"active_ms": {}}
        t0 = time.perf_counter()
        cl.create_pool(1, "rbd_ec", size=K + M, min_size=K + 1,
                       pg_num=sz["pg_num"], profile=profile,
                       stripe_width=width)
        rs["active_ms"]["create"] = cl.wait_active(1, t0)
        cl.drain()
        model, clones, whole = {}, {}, []
        oids = ["rbd_data.%04d" % i for i in range(sz["writes"])]
        before = launches()
        wall = write_all(cl, 1, model, [
            (i, oid, rng.integers(0, 256, obj, dtype=np.uint8).tobytes())
            for i, oid in enumerate(oids)])
        cl.drain()
        rs["writes_per_s"] = len(oids) / wall
        writes = since(before)
        check(writes["write"]["crc32_rows"] >= len(oids) and
              writes["write"]["xxh32_rows"] >= len(oids) and
              writes["gf"]["bitsliced"] >= len(oids),
              "every write was a fused write on the card (K1, K2 and the "
              "GF kernel): %s" % writes)
        resident = sum(d.hbm_tier.stats()["resident_objects"]
                       for d in cl.daemons)
        check(resident == len(oids), "every written object resident on "
              "its primary's tier (%d)" % resident)

        # overwrites: RMW pre-reads; one thread per object lane, in order
        lo, hi = sz["overwrite_bytes"]
        jobs = []
        for _ in range(sz["overwrites"]):
            i = int(rng.integers(0, len(oids)))
            length = int(rng.integers(lo, hi + 1))
            off = int(rng.integers(0, obj - length))
            jobs.append((i, off, rng.integers(0, 256, length,
                                              dtype=np.uint8).tobytes()))
        latencies = []

        def overwrite(item):
            i, off, data = item
            _, secs = call(cl, 1, oids[i], [("write", off, data)])
            model[oids[i]][off:off + len(data)] = data
            latencies.append(secs)

        wall = run8(overwrite, jobs)
        cl.drain()
        lat = sorted(latencies)
        rs.update(rmw_ops=len(lat), rmw_per_s=len(lat) / wall,
                  rmw_p50_ms=lat[len(lat) // 2] * 1e3,
                  rmw_p99_ms=lat[min(len(lat) - 1,
                                     int(len(lat) * 0.99))] * 1e3)
        # snapshot 1: 64 KiB at offset 0 of 8 objects; each head cloned
        snapped = oids[-sz["snaps"]:]

        def snap_write(item):
            _, oid = item
            data = bytes(64 << 10)
            clones["%s@1" % oid] = bytes(model[oid])
            call(cl, 1, oid, [("write", 0, data)], snapc=(1, (1,)))
            model[oid][:len(data)] = data

        run8(snap_write, list(enumerate(snapped)))
        cl.drain()
        nbytes, wall = read_all(cl, 1, model, clones)
        rs["read_MBps"] = nbytes / wall / 1e6
        ranges = []
        for _ in range(sz["ranges"]):
            i = int(rng.integers(0, len(oids)))
            length = int(rng.integers(4096, min(1 << 20, obj) + 1))
            off = int(rng.integers(0, obj - length + 1))
            ranges.append((i, off, length))

        def read_range(item):
            i, off, length = item
            data, _ = call(cl, 1, oids[i], [("read", off, length)])
            check(bytes(data) == bytes(model[oids[i]][off:off + length]),
                  "range read of %s equals the model" % oids[i])

        wall = run8(read_range, ranges)
        rs["range_read_MBps"] = sum(r[2] for r in ranges) / wall / 1e6
        emit("pg", case="client", gpu=smi, writes=len(oids),
             writes_per_s=rs["writes_per_s"], rmw_ops=rs["rmw_ops"],
             rmw_per_s=rs["rmw_per_s"], rmw_p50_ms=rs["rmw_p50_ms"],
             rmw_p99_ms=rs["rmw_p99_ms"], read_MBps=rs["read_MBps"],
             range_read_MBps=rs["range_read_MBps"],
             active_ms=rs["active_ms"], launches=writes)

        # -- peering, degraded writes and reads, recovery, remap ----------
        A, B, C = sz["down"], sz["down2"], sz["out"]
        t0 = cl.mark_down(A)
        rs["active_ms"]["down"] = cl.wait_active(1, t0)
        cl.drain()
        new = ["rbd_data.%04d" % i for i in range(
            len(oids), len(oids) + sz["degraded_writes"])]
        write_all(cl, 1, model, [
            (i, oid, rng.integers(0, 256, obj, dtype=np.uint8).tobytes())
            for i, oid in enumerate(new)])
        cl.drain()
        whole = list(new)
        xor0, before, d0 = xor_hits(cl, 1), launches(), disp_stats()
        nbytes, wall = read_all(cl, 1, model)
        one_down = {"MBps": nbytes / wall / 1e6,
                    "xor_shortcuts": xor_hits(cl, 1) - xor0,
                    "bitsliced": since(before)["gf"]["bitsliced"],
                    "decode_ops": disp_stats()["ops"] - d0["ops"]}
        check(one_down["xor_shortcuts"] > 0, "reads with OSD %d down took "
              "the XOR shortcut (%r)" % (A, one_down))
        t0 = cl.mark_down(B)
        rs["active_ms"]["down2"] = cl.wait_active(1, t0)
        cl.drain()
        new2 = ["rbd_data.%04d" % i for i in range(
            len(oids) + len(new), len(oids) + len(new) + 8)]
        write_all(cl, 1, model, [
            (i, oid, rng.integers(0, 256, obj, dtype=np.uint8).tobytes())
            for i, oid in enumerate(new2)])
        cl.drain()
        whole += new2
        before, d0 = launches(), disp_stats()
        nbytes, wall = read_all(cl, 1, model)
        degraded = since(before)
        two_down = {"MBps": nbytes / wall / 1e6,
                    "bitsliced": degraded["gf"]["bitsliced"],
                    "decode_ops": disp_stats()["ops"] - d0["ops"],
                    "dispatches": disp_stats()["dispatches"] -
                    d0["dispatches"]}
        check(two_down["decode_ops"] > 0 and two_down["bitsliced"] >=
              two_down["dispatches"] > 0, "reads with OSDs %d and %d down "
              "decoded through the dispatcher on the GF kernel (%r)"
              % (A, B, two_down))
        rs["degraded"] = {"one_down": one_down, "two_down": two_down}
        emit("pg", case="degraded", gpu=smi, down=[A, B],
             active_ms=rs["active_ms"], **rs["degraded"])
        pushes0 = perf(cl, "l_osd_recovery_ops")
        bytes0 = perf(cl, "l_osd_recovery_bytes") + \
            perf(cl, "l_osd_backfill_bytes")
        before = launches()
        t0 = cl.mark_up(A, B)
        rs["active_ms"]["up"] = cl.wait_active(1, t0)
        cl.drain()
        recovery_s = time.perf_counter() - t0
        recovered = perf(cl, "l_osd_recovery_ops") - pushes0
        recovery = since(before)
        check(recovered > 0 and recovery["gf"]["bitsliced"] > 0,
              "log recovery pushed the missing shards, decoding on the GF "
              "kernel (%d pushes, %s)" % (recovered, recovery))
        rs["recovery"] = {"pushes": recovered, "seconds": recovery_s,
                          "ms_per_object": recovery_s * 1e3 / recovered,
                          "launches": recovery}
        pushes0 = perf(cl, "l_osd_recovery_ops") + \
            perf(cl, "l_osd_backfill_ops")
        bytes0 = perf(cl, "l_osd_recovery_bytes") + \
            perf(cl, "l_osd_backfill_bytes")
        t0 = cl.mark_out(C)
        rs["active_ms"]["out"] = cl.wait_active(1, t0)
        cl.drain()
        remap_s = time.perf_counter() - t0
        moved = perf(cl, "l_osd_recovery_bytes") + \
            perf(cl, "l_osd_backfill_bytes") - bytes0
        rs["backfill"] = {"pushes": perf(cl, "l_osd_recovery_ops") +
                          perf(cl, "l_osd_backfill_ops") - pushes0,
                          "bytes": moved, "seconds": remap_s,
                          "MBps": moved / remap_s / 1e6}
        check(moved > 0, "the remap moved shards to the new members")
        nbytes, wall = read_all(cl, 1, model, clones)
        rs["remapped_read_MBps"] = nbytes / wall / 1e6
        cl.drain()
        found, fixed, _, wall = scrub(cl, 1, repair=True)
        rs["remap_scrub"] = {"errors": found, "repaired": fixed,
                             "seconds": wall}
        check(found == fixed, "the scrub after the remap repaired what "
              "it found (%d of %d)" % (fixed, found))
        emit("pg", case="recovery", gpu=smi, out=C,
             active_ms=rs["active_ms"], recovery=rs["recovery"],
             backfill=rs["backfill"],
             remapped_read_MBps=rs["remapped_read_MBps"],
             remap_scrub=rs["remap_scrub"],
             read_repairs=perf(cl, "repaired"))

        # -- deep scrub of resident objects with bitrot ------------------
        # new objects: resident on their primaries' tiers, their hinfo
        # crcs valid (a rewrite's truncate drops an object's crcs)
        first = len(oids) + len(new) + len(new2)
        rewrites = ["rbd_data.%04d" % i for i in range(
            first, first + sz["rewrites"])]
        write_all(cl, 1, model, [
            (i, oid, rng.integers(0, 256, obj, dtype=np.uint8).tobytes())
            for i, oid in enumerate(rewrites)])
        cl.drain()
        resident = sum(d.hbm_tier.stats()["resident_objects"]
                       for d in cl.daemons)
        injected = [mark_bitrot(cl, 1, rewrites[0], 0),
                    mark_bitrot(cl, 1, rewrites[1], 5)]
        before, rep0 = launches(), perf(cl, "repaired")
        found, fixed, stats, wall = scrub(cl, 1, repair=True)
        deep = since(before)
        shards = sum(s.get("objects", 0) for s in stats.values()) * (K + M)
        # every shard stream a deep scrub reads: each object's padded
        # length over k, on each of its k + m shards
        stored = sum(-(-len(d) // width) * width // K
                     for d in list(model.values()) + list(clones.values()))
        check(found == len(injected) == fixed, "the deep scrub found and "
              "repaired exactly the %d injected shards (%d, %d): %r"
              % (len(injected), found, fixed, stats))
        check(deep["write"]["crc32_rows"] > 0, "the deep scrub hashed "
              "resident shards with K1 on the card: %s" % deep)
        check(deep["gf"]["bitsliced"] >= len(injected), "the deep "
              "scrub's repairs rebuilt on the GF kernel: %s" % deep)
        found2, _, _, wall2 = scrub(cl, 1, repair=False)
        check(found2 == 0, "a second deep scrub is clean (%d)" % found2)
        rs["scrub"] = {"errors": found, "repaired": fixed, "seconds": wall,
                       "GBps": stored * (K + M) / wall / 1e9,
                       "second_seconds": wall2,
                       "shards_hashed": shards,
                       "hashed_on_card": deep["write"]["crc32_rows"],
                       "resident_share": deep["write"]["crc32_rows"] /
                       max(1, shards), "resident_objects": resident,
                       "repaired_perf": perf(cl, "repaired") - rep0,
                       "launches": deep}
        # four more shards rebuilt through repair_shard from the
        # primaries' tiers, one at a time: a GF launch each, no sub-read
        victims = [(rewrites[2 + j], 1 + 3 * j) for j in range(4)]
        times, by_tier = [], {}
        before, s0 = launches(), cl.sent.get("MOSDECSubOpRead", 0)
        for oid, pos in victims:
            pgid, osd = mark_bitrot(cl, 1, oid, pos)
            pg = cl.primary_pg(pgid)
            by_tier.setdefault(pg.whoami, []).append((pgid, oid, pos))
            t0 = time.perf_counter()
            cl.daemons[pg.whoami].op_wq.queue(
                pgid, pg.repair_shard, oid, pos, osd)
            cl.drain()
            times.append(time.perf_counter() - t0)
            check(cl.daemons[osd].store.read(("pg", str(pgid), pos), oid)
                  == encode(model[oid])[pos], "repair_shard rewrote %s's "
                  "shard %d" % (oid, pos))
        repair = since(before)
        check(cl.sent.get("MOSDECSubOpRead", 0) == s0, "repair_shard "
              "rebuilt from the tier: no sub-read")
        check(repair["gf"]["bitsliced"] >= len(victims), "each "
              "repair_shard rebuilt on the GF kernel: %s" % repair)
        rs["repair_ms_per_shard"] = statistics.mean(times) * 1e3
        # the same shards from the same tiers, one per-lane launch a tier
        # (the PG rebuilds one object at a time, as the reference does;
        # the tier's batched rebuild is the call that coalesces them)
        before = launches()
        t0 = time.perf_counter()
        for osd, items in sorted(by_tier.items()):
            rows = cl.daemons[osd].hbm_tier.reconstruct_batch(
                [(str(pgid), oid) for pgid, oid, _ in items],
                [pos for _, _, pos in items]).cpu().numpy()
            for row, (_, oid, pos) in zip(rows, items):
                check(row.tobytes() == encode(model[oid])[pos],
                      "the tier's batched rebuild of %s's shard %d "
                      "equals the plain encode" % (oid, pos))
        rs["tier_rebuild_batch_ms"] = (time.perf_counter() - t0) * 1e3
        batch = since(before)
        check(batch["per_lane"]["bitsliced"] >= len(by_tier),
              "the tier's batched rebuild ran the per-lane kernel once a "
              "tier: %s" % batch)
        emit("pg", case="scrub", gpu=smi, **rs["scrub"],
             repair_ms_per_shard=rs["repair_ms_per_shard"],
             repair_ms=[t * 1e3 for t in times], repair_launches=repair,
             tier_rebuild_batch_ms=rs["tier_rebuild_batch_ms"],
             tier_rebuild_batch_launches=batch)
        read_all(cl, 1, model, clones)
        cl.drain()
        t0 = time.perf_counter()
        bad = store_mismatches(cl, {**{o: bytes(d) for o, d in
                                       model.items()}, **clones}, encode)
        check(bad == [], "every acting shard equals the plain encode of "
              "the model: %r" % bad[:4])
        rs["store_check_s"] = time.perf_counter() - t0
        # -- the compress step: a second pool, K3 -------------------------
        for d in cl.daemons:
            d.fused_mode = "compress"
        cl.create_pool(2, "rbd_ecz", size=K + M, min_size=K + 1,
                       pg_num=2, profile=profile, stripe_width=width)
        cl.drain()
        cmodel = {}
        before = launches()
        write_all(cl, 2, cmodel, [
            (i, "cmp.%02d" % i, rng.integers(0, 4, obj,
                                             dtype=np.uint8).tobytes())
            for i in range(sz["compress"])])
        cl.drain()
        compress = since(before)
        read_all(cl, 2, cmodel)
        for d in cl.daemons:
            d.fused_mode = "store"
        check(compress["write"]["bitplane_stage"] >= sz["compress"],
              "the compress writes ran K3 on the card: %s" % compress)
        rs["compress_launches"] = compress
        rs["dispatcher"] = disp_stats()

        # -- (b) MSR k=8, m=7 on 16 OSDs, 2 PGs ---------------------------
        mprofile = {"plugin": "msr_cuda", "k": "8", "m": "7", "w": "8"}
        mcodec = registry.factory("msr_cuda", {"k": "8", "m": "7",
                                               "w": "8"}, device=dev)
        mwidth = stripe_width(mcodec, 4096)
        mencode = plain_encoder(mprofile, mwidth)
        mcl = cluster(sz["msr_osds"], None)
        mcl.create_pool(1, "msr", size=15, min_size=9,
                        pg_num=sz["msr_pg_num"], profile=mprofile,
                        stripe_width=mwidth)
        mcl.drain()
        mmodel = {}
        moids = ["msr.%02d" % i for i in range(sz["msr"])]
        before = launches()
        wall = write_all(mcl, 1, mmodel, [
            (i, oid, rng.integers(0, 256, obj, dtype=np.uint8).tobytes())
            for i, oid in enumerate(moids)])
        mcl.drain()
        msr = {"writes_per_s": len(moids) / wall}
        mark_bitrot(mcl, 1, moids[0], 3)
        found, fixed, _, wall = scrub(mcl, 1, repair=True)
        check(found == fixed == 1, "MSR's deep scrub repaired the one "
              "injected shard (%d, %d)" % (found, fixed))
        found2, _, _, _ = scrub(mcl, 1, repair=False)
        check(found2 == 0, "MSR's second deep scrub is clean")
        msr["scrub_s"] = wall
        # a rebuild through the helpers' fractions: the primary's tier off
        pgid, osd = mark_bitrot(mcl, 1, moids[1], 6)
        prim = mcl.daemons[mcl.acting(pgid)[1]]
        tier, prim.hbm_tier = prim.hbm_tier, None
        r0 = mcl.sent.get("MOSDECSubOpRepairRead", 0)
        shipped0 = perf(mcl, "l_osd_repair_bytes_shipped")
        t0 = time.perf_counter()
        pg = mcl.primary_pg(pgid)
        prim.op_wq.queue(pgid, pg.repair_shard, moids[1], 6, osd)
        mcl.drain()
        msr["repair_ms"] = (time.perf_counter() - t0) * 1e3
        prim.hbm_tier = tier
        msr["repair_reads"] = mcl.sent.get("MOSDECSubOpRepairRead", 0) - r0
        msr["repair_bytes"] = perf(mcl, "l_osd_repair_bytes_shipped") - \
            shipped0
        check(msr["repair_reads"] >= 8 and msr["repair_bytes"] > 0,
              "repair_shard rebuilt the shard through helper fractions "
              "(%d reads, %d bytes)" % (msr["repair_reads"],
                                        msr["repair_bytes"]))
        read_all(mcl, 1, mmodel)
        mcl.drain()
        bad = store_mismatches(mcl, {o: bytes(d) for o, d in
                                     mmodel.items()}, mencode)
        check(bad == [], "every MSR shard equals the plain encode: %r"
              % bad[:4])
        msr["launches"] = since(before)
        check(msr["launches"]["gf"]["mma"] > 0, "MSR ran the GF kernel's "
              "mma design: %s" % msr["launches"])
        emit("pg", case="msr", gpu=smi, **msr)

        phase = launches()      # counted from 0 at the phase's start
        check(phase["gf"]["bitsliced"] > 0 and phase["gf"]["mma"] > 0 and
              phase["per_lane"]["bitsliced"] > 0 and
              all(phase["write"].values()),
              "the phase launched the GF kernel's bit-sliced and mma "
              "designs, the per-lane kernel and K1-K3: %s" % phase)
        seconds = time.perf_counter() - t_phase
        emit("pg", case="launches", gpu=smi, launches=phase,
             seconds=seconds, threads=[len(c.daemons) for c in clusters])
        return {"launches": phase, "rs": rs, "msr": msr,
                "seconds": seconds}
    finally:
        for cl_ in clusters:
            cl_.shutdown()
        for d in dispatchers:
            d.shutdown()
        pool.shutdown()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "ceph_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(ceph_tpu_torch/ not found beside the script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from ceph_tpu_torch import registry
    from ceph_tpu_torch.device import host_tensor
    from ceph_tpu_torch.ops import (_build, gf, gf_kernel, gf_ref,
                                    launch_check, packet_kernel)
    from ceph_tpu_torch.ops import write_kernels as wk
    from ceph_tpu_torch.ops.xor_mm import bitmatrix_encode_plain
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd import fused_transform as ft
    from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher
    from ceph_tpu_torch.utils.cuda_timing import (bitplane_bound, crc_bound,
                                                  gf_bound, packet_bound,
                                                  time_ms, xxh32_bound)

    torch.backends.cuda.matmul.allow_tf32 = False  # plain version exact
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261016)
    smi = nvidia_smi()

    # -- 1. setup ------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    ptxas = {name: _build.ptxas_report(name) for name in _build.sources()}
    emit("setup", build_s=time.perf_counter() - t0,
         compiled={k: round(v, 3) for k, v in built.items()},
         gpu=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, ptxas=ptxas)
    edge_static, edge_sums = launch_check.smem_edge()
    torch.cuda.synchronize()
    emit("setup", case="smem_edge", static_bytes=edge_static,
         dynamic_bytes=launch_check.EDGE_BYTES, sums=edge_sums.tolist())
    check(edge_static > 0 and edge_sums.tolist() ==
          [launch_check.smem_edge_expected()] * edge_sums.numel(),
          "48 KiB of dynamic beside static shared memory launches")
    for name, kernels in ptxas.items():
        check(bool(kernels), "ptxas reported the kernels of " + name)
        for inst, res in kernels.items():
            check("registers" in res, "registers of %s" % inst)
            check(res.get("spill_stores", 1) == 0 and
                  res.get("spill_loads", 1) == 0, "no spill in %s" % inst)

    # -- 2. kernel against its plain version on the card ------------------
    coding = gf.rs_vandermonde_generator(K, M, W)

    def dec_bitmat(avail, w=W, cod=coding):
        dec = gf.decode_matrix(cod, cod.shape[1], avail, w)
        return gf.generator_to_bitmatrix(
            np.concatenate([dec, gf.gf_matmul(cod, dec, w)]), w)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rand_dev(*shape):
        return on_dev(rng.integers(0, 256, shape, dtype=np.uint8))

    def off_by_one(*shape):
        """A contiguous view one byte into a larger buffer."""
        count = int(np.prod(shape))
        buf = rand_dev(count + 1)
        return buf[1:].view(*shape)

    def rand_bitmat(rows, k):
        return rng.integers(0, 2, (rows, k * W), dtype=np.uint8)

    coding16 = gf.rs_vandermonde_generator(16, 4, W)
    coding40 = gf.rs_vandermonde_generator(40, 4, W)
    data_sets = [rand_dev(BATCH, K, N) for _ in range(4)]
    # (name, w, bitmatrix, inputs, the design its geometry takes)
    cases = [("encode", W, gf.generator_to_bitmatrix(coding, W), data_sets,
              "bitsliced")]
    for avail in [(3, 4, 5, 6, 7, 8, 9, 10), (0, 1, 2, 4, 5, 6, 9, 10),
                  (1, 2, 3, 5, 6, 7, 8, 9)]:
        cases.append(("decode" + "".join(map(str, avail)), W,
                      dec_bitmat(avail), data_sets, "bitsliced"))
    k16 = [rand_dev(2, 16, N)]
    cases += [
        ("encode_k16_m4", W, gf.generator_to_bitmatrix(coding16, W), k16,
         "bitsliced"),
        ("decode_k16_m4", W, dec_bitmat(tuple(range(4, 20)), cod=coding16),
         k16, "bitsliced"),
        ("encode_ragged", W, gf.generator_to_bitmatrix(coding, W),
         [rand_dev(BATCH, K, N - 1001)], "bitsliced"),
        ("encode_offset1", W, gf.generator_to_bitmatrix(coding, W),
         [off_by_one(4, K, N)], "bitsliced"),
        ("encode_k40_m4", W, gf.generator_to_bitmatrix(coding40, W),
         [rand_dev(2, 40, N // 8)], "mma"),
        ("encode_k40_offset1", W, gf.generator_to_bitmatrix(coding40, W),
         [off_by_one(2, 40, N // 8 - 3)], "mma"),
        # E = rows * KMAX*8 words: 224 KiB fits the card's opt-in shared
        # memory, 256 KiB (KMAX = 16, 8, 4) sends w=8 to the mma kernel
        ("random_448x128", W, rand_bitmat(448, 16),
         [rand_dev(2, 16, N // 8)], "bitsliced"),
        ("random_512x128", W, rand_bitmat(512, 16),
         [rand_dev(2, 16, N // 8)], "mma"),
        ("random_1024x64", W, rand_bitmat(1024, 8),
         [rand_dev(2, 8, N // 8)], "mma"),
        ("random_2048x32", W, rand_bitmat(2048, 4),
         [rand_dev(2, 4, N // 8)], "mma"),
        # past 512 columns: the chunked mma kernel, eight row groups
        ("random_1368x720", W, rand_bitmat(1368, 90),
         [rand_dev(2, 90, N // 8)], "mma"),
        # the slice's geometries: SHEC k=8, m=4 decode from 11 survivors,
        # LRC k=4, m=2, l=3 decode from 6 survivors and its fused encode
        ("shec_decode_96x88", W, rand_bitmat(96, 11),
         [rand_dev(BATCH, 11, N)], "bitsliced"),
        ("lrc_decode_64x48", W, rand_bitmat(64, 6),
         [rand_dev(BATCH, 6, N)], "bitsliced"),
        ("lrc_encode_32x32", W, rand_bitmat(32, 4),
         [rand_dev(BATCH, 4, N)], "bitsliced")]
    for w in (16, 32):
        cases.append(("encode_w%d" % w, w, gf.generator_to_bitmatrix(
            gf.rs_vandermonde_generator(K, M, w), w), data_sets[:1],
            "popcount" if w == 16 else "mma"))

    timings = {}
    worst = 0
    phase2_start = gf_kernel.launches_by_design()
    for name, w, bm_np, inputs, expect in cases:
        bm = on_dev(bm_np)
        k = inputs[0].shape[-2]
        design = gf_kernel.kernel_design(bm.shape[0], k, w, dev)
        before = gf_kernel.launches_by_design()
        out = gf_kernel.matrix_encode(bm, inputs[0], w)
        torch.cuda.synchronize()
        after = gf_kernel.launches_by_design()
        launched = {d: after[d] - before[d] for d in after}
        ref = gf_kernel.matrix_encode_plain(bm, inputs[0], w)
        err = int((out.to(torch.int16) - ref.to(torch.int16)).abs().max())
        worst = max(worst, err)
        rec = {"case": name, "w": w, "bitmat": list(bm.shape),
               "data": list(inputs[0].shape), "design": design,
               "equal": err == 0, "max_abs_err": err}
        if name == "encode" or name.startswith("decode3"):
            rec["ms"] = time_ms(
                lambda x: gf_kernel.matrix_encode(bm, x, w), inputs, 40)
            rec["plain_ms"] = time_ms(
                lambda x: gf_kernel.matrix_encode_plain(bm, x, w),
                inputs, 8)
            rec["bound_ms"], rec["bound_by"] = gf_bound(bm, inputs[0], out,
                                                        w)
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
            timings[name] = rec
        emit("kernel", **rec)
        check(design == expect and launched[expect] == 1 and
              sum(launched.values()) == 1,
              "%s launched the %s design once" % (name, expect))
        check(err == 0, "kernel equals plain version for " + name)
    phase2_launches = {d: n - phase2_start[d]
                       for d, n in gf_kernel.launches_by_design().items()}
    check(all(phase2_launches.values()), "every design launched")
    # the per-lane and row-table entry points on the mma design past 512
    # columns (the chunked kernel, three row groups of [400, 720])
    bms = on_dev(rng.integers(0, 2, (3, 400, 720), dtype=np.uint8))
    lane_data = rand_dev(3, 2, 90, N // 16)
    part = rand_dev(3, 93, N // 16)
    picks = np.concatenate([p * 93 + rng.permutation(93)[:90]
                            for p in range(3)])
    for entry, run, plain in (
            ("multi",
             lambda: gf_kernel.matrix_encode_multi(bms, lane_data, W),
             lambda: gf_kernel.matrix_encode_multi_plain(bms, lane_data,
                                                         W)),
            ("multi_rows",
             lambda: gf_kernel.matrix_encode_multi_rows(bms, [part],
                                                        [picks], W),
             lambda: gf_kernel.matrix_encode_multi_rows_plain(
                 bms, [part], [picks], W))):
        before = gf_kernel.launches_by_design(multi=True)
        out = run()
        torch.cuda.synchronize()
        after = gf_kernel.launches_by_design(multi=True)
        launched = {d: after[d] - before[d] for d in after}
        err = int((out.to(torch.int16) - plain().to(torch.int16)).abs().max())
        worst = max(worst, err)
        emit("kernel", case="mma_" + entry, w=W, bitmat=list(bms.shape),
             data=list(lane_data.shape) if entry == "multi" else
             [3, 90, N // 16], design="mma", launches=launched,
             equal=err == 0, max_abs_err=err)
        check(launched == {"bitsliced": 0, "mma": 1, "popcount": 0},
              "the %s entry point launched the mma design once" % entry)
        check(err == 0, "kernel equals plain version for the %s entry "
              "point" % entry)
    del bms, lane_data, part
    del cases, k16

    # -- 3. main path: registry -> RS codec -> bank -> kernel -------------
    gf_kernel.reset_launches()
    codec = registry.factory("torch_cuda", dict(PROFILE))
    check(codec.device.type == "cuda", "codec on the card by default")
    data = data_sets[0]
    parity = codec.encode_batch(data)
    torch.cuda.synchronize()
    check(tuple(parity.shape) == (BATCH, M, N) and parity.is_cuda,
          "parity shape and device")
    host0 = data[0].cpu().numpy()
    check(np.array_equal(parity[0].cpu().numpy(),
                         gf_ref.matrix_encode_ref(codec.coding, host0, W)),
          "encode equals gf_ref on one object")
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        codec.encode_batch(data)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    full = torch.cat([data, parity], 1)

    sigs = list(itertools.combinations(range(K + M), K))
    t0 = time.perf_counter()
    for avail in sigs:           # first pass also builds the bank
        out = codec.decode_batch(avail, full[:, list(avail)].contiguous())
        check(torch.equal(out, full), "decode %s reconstructs" % (avail,))
    bank_s = time.perf_counter() - t0
    survivors = [full[:, list(a)].contiguous() for a in sigs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for avail, chunks in zip(sigs, survivors):
        codec.decode_batch(avail, chunks)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    del survivors
    avail = (3, 4, 5, 6, 7, 8, 9, 10)
    full0 = full[0].cpu().numpy()
    ref = gf_ref.decode_ref(codec.coding, K, W,
                            {i: full0[i] for i in avail})
    got = codec.decode_batch(avail, full[:1, list(avail)].contiguous())
    check(all(np.array_equal(got[0, i].cpu().numpy(), ref[i])
              for i in range(K + M)), "decode equals gf_ref on one object")
    launches_main = gf_kernel.LAUNCHES
    check(launches_main > 0, "main path launched the kernel")
    obj_bytes = BATCH * K * N
    emit("main_path", signatures=len(sigs), bank=list(codec._bank_dev.shape),
         encode_MBps=obj_bytes * reps / enc_s / 1e6,
         decode_MBps=obj_bytes * len(sigs) / dec_s / 1e6,
         first_decode_pass_s=bank_s, launches=launches_main,
         table_cache=codec.table_cache_stats())

    # -- 4. coalescing dispatcher, host batches of 1 MiB objects ----------
    host_data = data.cpu().numpy()
    host_full = full.cpu().numpy()
    del full, parity
    disp = GpuDispatcher()
    check(disp.device.type == "cuda", "dispatcher on the card by default")
    sig_pool = [sigs[i] for i in rng.choice(len(sigs), 6, replace=False)]
    threads, iters, per_op = 8, 24, 2
    errors: list[str] = []
    moved = [0]
    lock = threading.Lock()

    def submitter(tid: int, n_iters: int) -> None:
        r = random.Random(tid)
        try:
            for _ in range(n_iters):
                i = r.randrange(BATCH - per_op + 1)
                sl = slice(i, i + per_op)
                avail = sig_pool[r.randrange(len(sig_pool))]
                f_enc = disp.encode_async(codec, host_data[sl])
                f_dec = disp.decode_async(
                    codec, avail, host_full[sl][:, list(avail)])
                if not np.array_equal(f_enc.result(300), host_full[sl, K:]):
                    errors.append("encode mismatch")
                if not np.array_equal(f_dec.result(300), host_full[sl]):
                    errors.append("decode mismatch %s" % (avail,))
                with lock:
                    moved[0] += 2 * per_op * K * N
        except Exception as e:  # reported below; the run then fails
            errors.append(repr(e))

    def run_submitters(n_iters: int) -> tuple[float, bool]:
        t0 = time.perf_counter()
        pool = [threading.Thread(target=submitter, args=(t, n_iters))
                for t in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(600)
        return time.perf_counter() - t0, any(t.is_alive() for t in pool)

    before = gf_kernel.LAUNCHES
    run_submitters(2)            # warm the pinned-memory caches
    disp.perf.reset()
    moved[0] = 0
    ops0, disp0 = disp.stats["ops"], disp.stats["dispatches"]
    wall, alive = run_submitters(iters)
    perf = disp.perf.dump()
    disp.shutdown()
    launches_disp = gf_kernel.LAUNCHES - before
    emit("dispatcher", threads=threads, timed_ops=disp.stats["ops"] - ops0,
         timed_dispatches=disp.stats["dispatches"] - disp0,
         ops=disp.stats["ops"], dispatches=disp.stats["dispatches"],
         coalesced=disp.stats["coalesced"], streaming_MBps=moved[0] / wall
         / 1e6, wall_s=wall, h2d_s=perf["l_gpu_h2d"]["sum"],
         compute_s=perf["l_gpu_compute"]["sum"],
         d2h_s=perf["l_gpu_d2h"]["sum"],
         queue_s=perf["l_gpu_dispatch_queue"]["sum"],
         reused=perf["l_gpu_reused"], launches=launches_disp,
         errors=errors[:5])
    check(not alive, "submitters finished")
    check(not errors, "dispatcher results verified")
    check(disp.stats["dispatches"] < disp.stats["ops"], "ops coalesced")
    check(launches_disp > 0, "dispatcher launched the kernel")
    launches = gf_kernel.LAUNCHES
    launches_by_design = gf_kernel.launches_by_design()
    main_design = gf_kernel.kernel_design(M * W, K, W, dev)
    check(main_design == "bitsliced" and
          gf_kernel.kernel_design((K + M) * W, K, W, dev) == main_design,
          "the main path's geometry takes the bit-sliced design")
    check(launches_by_design[main_design] == launches and
          sum(launches_by_design.values()) == launches,
          "every main-path launch went to the bit-sliced design")

    # -- 5. packet kernel against its plain version on the card ----------
    def packet_case(name, bm_np, data, w, packetsize, timed=None):
        """One launch on the design the geometry and alignment take, byte
        equal to the plain version; timed on `timed` inputs if given."""
        bm = on_dev(bm_np)
        k = data.shape[-2]
        set_bits = int(bm_np.sum())    # as a codec gives it

        def run(x):
            return packet_kernel.bitmatrix_encode(bm, x, w, packetsize,
                                                  set_bits=set_bits)
        design = packet_kernel.kernel_design(bm, data, w, packetsize,
                                             set_bits)
        before = packet_kernel.launches_by_design()
        out = run(data)
        torch.cuda.synchronize()
        after = packet_kernel.launches_by_design()
        launched = {d: after[d] - before[d] for d in after}
        ref = bitmatrix_encode_plain(bm, data, w, packetsize)
        err = int((out.to(torch.int16) - ref.to(torch.int16)).abs().max())
        # input bytes read from device memory per launch, counted from
        # the design's loads: the staged design copies each input byte
        # once; the others load one packet row per set bit
        read = data.numel() if design == "staged" else \
            set_bits * data.numel() // (k * w)
        rec = {"case": name, "w": w, "packetsize": packetsize,
               "bitmat": list(bm.shape), "data": list(data.shape),
               "design": design, "equal": err == 0, "max_abs_err": err,
               "counted_read_bytes": read, "unique_bytes": data.numel(),
               "counted_read_over_unique": read / data.numel()}
        # every case timed on its own input; the Cauchy shapes on inputs
        # rotated out of L2, beside the plain version
        rec["ms"] = time_ms(run, timed or [data], 40)
        rec["bound_ms"], rec["bound_by"] = packet_bound(bm, data, out)
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        if timed:
            rec["plain_ms"] = time_ms(lambda x: bitmatrix_encode_plain(
                bm, x, w, packetsize), timed, 8)
            rec["set_bits"] = set_bits
            rec["selected_TBps"] = set_bits * data.numel() / (
                k * w) / (rec["ms"] * 1e-3) / 1e12
        emit("packet", **rec)
        check(launched[design] == 1 and sum(launched.values()) == 1,
              "%s launched the %s design once" % (name, design))
        check(err == 0, "packet kernel equals plain version for " + name)
        return rec

    phase5_start = packet_kernel.launches_by_design()
    packet_worst = 0
    prng = np.random.default_rng(4)
    for w in (7, 8, 16, 32):
        for packetsize in (3, 8, 24, 2048, 8192):
            bm_np = prng.integers(0, 2, (2 * w, 3 * w), dtype=np.uint8)
            for batch in (1, 16):
                data = rand_dev(batch, 3, (3 if batch == 1 else 2) * w *
                                packetsize)
                rec = packet_case("w%d_p%d_b%d" % (w, packetsize, batch),
                                  bm_np, data, w, packetsize)
                packet_worst = max(packet_worst, rec["max_abs_err"])
    for packetsize in (8, 2048):
        bm_np = prng.integers(0, 2, (16, 32), dtype=np.uint8)
        rec = packet_case("offset1_p%d" % packetsize, bm_np,
                          off_by_one(2, 4, 3 * 8 * packetsize), 8,
                          packetsize)
        packet_worst = max(packet_worst, rec["max_abs_err"])
    # k*w tiles past the staged design's 32 KiB buffer (64-byte tiles,
    # under the 128-byte least): the vector design; and a packetsize whose
    # last tile is 16 bytes
    for name, w, k, packetsize in (("vector_w32_k9_p2048", 32, 9, 2048),
                                   ("staged_w8_k10_p2064", 8, 10, 2064)):
        rec = packet_case(name, prng.integers(0, 2, (2 * w, k * w),
                                              dtype=np.uint8),
                          rand_dev(2, k, 2 * w * packetsize), w, packetsize)
        packet_worst = max(packet_worst, rec["max_abs_err"])
    cauchy_coding = gf.cauchy_good_generator(10, 4, W)
    cauchy_sets = [rand_dev(BATCH, 10, N) for _ in range(4)]
    penc = packet_case("cauchy_encode", gf.generator_to_bitmatrix(
        cauchy_coding, W), cauchy_sets[0], W, 2048, timed=cauchy_sets)
    pdec = packet_case("cauchy_decode0123", dec_bitmat(
        tuple(range(4, 14)), cod=cauchy_coding), cauchy_sets[0], W, 2048,
        timed=cauchy_sets)
    # the same bytes with another count of set bits, and the same
    # bitmatrix on twice the bytes: does the time follow the selected
    # packet bytes or the bytes moved?
    pdense = packet_case("random_32x80", rng.integers(
        0, 2, (32, 80), dtype=np.uint8), cauchy_sets[0], W, 2048,
        timed=cauchy_sets)
    del cauchy_sets
    p8192_sets = [rand_dev(BATCH, 10, 2 * N) for _ in range(2)]
    p8192 = packet_case("cauchy_encode_p8192", gf.generator_to_bitmatrix(
        cauchy_coding, W), p8192_sets[0], W, 8192, timed=p8192_sets)
    del p8192_sets
    # a sparse bitmatrix (2.1 selects per input packet): the vector design
    lib_codec = registry.factory("torch_cuda", {
        "technique": "liberation", "k": "7", "w": "7", "m": "2",
        "packetsize": "2048"}, device="cpu")
    lib_sets = [rand_dev(BATCH, 7, lib_codec.get_chunk_size(1 << 20))
                for _ in range(4)]
    plib = packet_case("liberation_k7_w7_encode", lib_codec._bitmat,
                       lib_sets[0], 7, 2048, timed=lib_sets)
    check(plib["design"] == "vector",
          "the liberation encode takes the vector design")
    del lib_sets
    packet_worst = max(packet_worst, *(r["max_abs_err"] for r in (
        penc, pdec, pdense, p8192, plib)))
    big = torch.zeros((1792, 1024), dtype=torch.uint8, device=dev)
    count = packet_kernel.LAUNCHES
    try:
        packet_kernel.bitmatrix_encode(
            big, torch.zeros((1, 32, 64), dtype=torch.uint8, device=dev),
            32, 2)
        raised = False
    except ValueError:
        raised = True
    emit("packet", case="past_shared_memory", bitmat=[1792, 1024],
         raised=raised)
    check(raised and packet_kernel.LAUNCHES == count,
          "a bitmatrix past shared memory raises before any launch")
    phase5_launches = {d: n - phase5_start[d] for d, n in
                       packet_kernel.launches_by_design().items()}
    check(all(phase5_launches.values()), "every packet design launched")

    # -- 6. the slice's path: Cauchy, LRC, SHEC through the registry -------
    obj = 1 << 20
    mbps = {}

    def timed_loop(fn, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def cauchy_codec(packetsize):
        return registry.factory("torch_cuda", {
            "technique": "cauchy_good", "k": "10", "m": "4", "w": "8",
            "packetsize": str(packetsize)})

    gf_kernel.reset_launches()
    packet_kernel.reset_launches()
    t_slice = time.perf_counter()
    sweep = {}
    for packetsize in (512, 1024, 2048, 4096, 8192):
        codec = cauchy_codec(packetsize)
        check(codec.device.type == "cuda", "Cauchy codec on the card")
        size = codec.get_chunk_size(obj)
        data = rand_dev(BATCH, 10, size)
        parity = codec.encode_batch(data)
        torch.cuda.synchronize()
        check(tuple(parity.shape) == (BATCH, 4, size) and parity.is_cuda,
              "Cauchy parity shape and device")
        check(np.array_equal(parity[0].cpu().numpy(),
                             gf_ref.bitmatrix_encode_ref(
                                 codec._bitmat, data[0].cpu().numpy(), W,
                                 packetsize)),
              "Cauchy encode equals gf_ref at packetsize %d" % packetsize)
        enc_s = timed_loop(lambda: codec.encode_batch(data), reps)
        full = torch.cat([data, parity], 1)
        avail = tuple(range(4, 14))
        survivors = full[:, 4:].contiguous()
        check(torch.equal(codec.decode_batch(avail, survivors), full),
              "Cauchy decode of chunks 0-3 at packetsize %d" % packetsize)
        dec_s = timed_loop(lambda: codec.decode_batch(avail, survivors),
                           reps)
        sweep[str(packetsize)] = {
            "chunk": size, "encode_MBps": BATCH * 10 * size * reps / enc_s
            / 1e6, "decode0123_MBps": BATCH * 10 * size * reps / dec_s / 1e6}
        if packetsize == 2048:
            sigs = list(itertools.combinations(range(14), 10))
            t0 = time.perf_counter()
            for avail in sigs:
                out = codec.decode_batch(avail,
                                         full[:, list(avail)].contiguous())
                check(torch.equal(out, full),
                      "Cauchy decode %s reconstructs" % (avail,))
            torch.cuda.synchronize()
            sweep["2048"].update(signatures=len(sigs),
                                 all_signatures_s=time.perf_counter() - t0)
        del data, parity, full, survivors
    best = max(sweep, key=lambda p: sweep[p]["encode_MBps"])
    emit("codecs", codec="cauchy_good k=10 m=4", sweep=sweep,
         best_packetsize=int(best))

    lrc = registry.factory("lrc_cuda", {"k": "4", "m": "2", "l": "3"})
    check(lrc.device.type == "cuda" and all(
        layer.codec.device.type == "cuda" for layer in lrc.layers),
        "LRC and its inner codecs on the card")
    size = lrc.get_chunk_size(obj)
    data = rand_dev(BATCH, 4, size)
    parity = lrc.encode_batch(data)
    torch.cuda.synchronize()
    host0 = data[0].cpu().numpy()
    bufs = {pos: host0[i] for i, pos in
            enumerate(i for i, c in enumerate(lrc.mapping) if c == "D")}
    for layer in lrc.layers:     # the per-layer walk on the numpy oracle
        par = gf_ref.matrix_encode_ref(
            layer.codec.coding, np.stack([bufs[c] for c in layer.data]), W)
        for j, c in enumerate(layer.coding):
            bufs[c] = par[j]
    check(all(np.array_equal(parity[0, j].cpu().numpy(),
                             bufs[lrc.chunk_index(4 + j)])
              for j in range(4)), "LRC encode equals the layer walk")
    enc_s = timed_loop(lambda: lrc.encode_batch(data), reps)
    full = torch.cat([data, parity], 1)
    avail = (1, 2, 3, 4, 6, 7)             # 0 and 5: one per group
    survivors = full[:, list(avail)].contiguous()
    want = tuple(range(8))
    check(torch.equal(lrc.decode_batch(avail, survivors, want_rows=want),
                      full), "LRC decode of chunks 0 and 5")
    dec_s = timed_loop(lambda: lrc.decode_batch(avail, survivors,
                                                want_rows=want), reps)
    mbps["lrc"] = {"encode_MBps": BATCH * 4 * size * reps / enc_s / 1e6,
                   "decode_MBps": BATCH * 4 * size * reps / dec_s / 1e6}
    emit("codecs", codec="lrc k=4 m=2 l=3", chunk=size, erased=[0, 5],
         **mbps["lrc"])
    del data, parity, full, survivors

    shec = registry.factory("shec_cuda", {"technique": "multiple",
                                          "k": "8", "m": "4", "c": "3"})
    size = shec.get_chunk_size(obj)
    data = rand_dev(BATCH, 8, size)
    parity = shec.encode_batch(data)
    torch.cuda.synchronize()
    check(np.array_equal(parity[0].cpu().numpy(), gf_ref.matrix_encode_ref(
        shec.coding, data[0].cpu().numpy(), W)), "SHEC encode equals gf_ref")
    enc_s = timed_loop(lambda: shec.encode_batch(data), reps)
    full = torch.cat([data, parity], 1)
    shec_sigs = [tuple(i for i in range(12) if i not in erased)
                 for e in (1, 2) for erased in
                 itertools.combinations(range(12), e)]
    survivors = [full[:, list(a)].contiguous() for a in shec_sigs]
    t0 = time.perf_counter()
    for avail, chunks in zip(shec_sigs, survivors):   # plans every entry
        check(torch.equal(shec.decode_batch(avail, chunks), full),
              "SHEC decode %s reconstructs" % (avail,))
    first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for avail, chunks in zip(shec_sigs, survivors):
        shec.decode_batch(avail, chunks)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    mbps["shec"] = {"encode_MBps": BATCH * 8 * size * reps / enc_s / 1e6,
                    "decode_MBps": BATCH * 8 * size * len(shec_sigs) / dec_s
                    / 1e6}
    emit("codecs", codec="shec k=8 m=4 c=3", chunk=size,
         signatures=len(shec_sigs), first_decode_pass_s=first_s,
         **mbps["shec"])
    del data, parity, full, survivors

    # the dispatcher fed two Cauchy codecs of one bitmatrix and chunk
    # size but another packetsize: 2 MiB objects at 2048, 1 MiB at 8192
    pair = [cauchy_codec(2048), cauchy_codec(8192)]
    sizes = [pair[0].get_chunk_size(2 * obj), pair[1].get_chunk_size(obj)]
    check(sizes[0] == sizes[1] and
          GpuDispatcher._codec_key(pair[0]) != GpuDispatcher._codec_key(
              pair[1]), "equal batch shapes under two dispatch keys")
    size = sizes[0]
    hdata = rng.integers(0, 256, (BATCH, 10, size), dtype=np.uint8)
    dev_data = on_dev(hdata)
    hfull = [torch.cat([dev_data, c.encode_batch(dev_data)], 1).cpu()
             .numpy() for c in pair]
    del dev_data
    check(not np.array_equal(hfull[0], hfull[1]),
          "the two packetsizes compute different functions")
    rows_run = [0, 0]
    rows_sent = [0, 0]
    row_lock = threading.Lock()

    def record(tag, fn):
        def call(*args, **kw):
            batch = args[-1]
            with row_lock:
                rows_run[tag] += int(batch.shape[0])
            return fn(*args, **kw)
        return call

    for tag, c in enumerate(pair):
        c.encode_batch = record(tag, c.encode_batch)
        c.decode_batch = record(tag, c.decode_batch)
    cauchy_pool = [tuple(range(4, 14)), (0, 2, 3, 5, 6, 8, 9, 10, 12, 13),
                   (1, 2, 3, 4, 5, 6, 7, 8, 9, 10)]
    disp = GpuDispatcher()
    cerrors: list[str] = []

    def cauchy_submitter(tid: int) -> None:
        r = random.Random(100 + tid)
        try:
            for _ in range(6):
                c = r.randrange(2)
                i = r.randrange(BATCH - per_op + 1)
                sl = slice(i, i + per_op)
                avail = cauchy_pool[r.randrange(len(cauchy_pool))]
                with row_lock:
                    rows_sent[c] += 2 * per_op
                f_enc = disp.encode_async(pair[c], hdata[sl])
                f_dec = disp.decode_async(pair[c], avail,
                                          hfull[c][sl][:, list(avail)])
                if not np.array_equal(f_enc.result(300), hfull[c][sl, 10:]):
                    cerrors.append("encode mismatch at packetsize %d"
                                   % pair[c].packetsize)
                if not np.array_equal(f_dec.result(300), hfull[c][sl]):
                    cerrors.append("decode mismatch %s" % (avail,))
        except Exception as e:  # reported below; the run then fails
            cerrors.append(repr(e))

    pool = [threading.Thread(target=cauchy_submitter, args=(t,))
            for t in range(threads)]
    t0 = time.perf_counter()
    for t in pool:
        t.start()
    for t in pool:
        t.join(600)
    cwall = time.perf_counter() - t0
    disp.shutdown()
    emit("codecs", codec="dispatcher cauchy_good 2048+8192", chunk=size,
         threads=threads, ops=disp.stats["ops"],
         dispatches=disp.stats["dispatches"],
         coalesced=disp.stats["coalesced"], rows_sent=rows_sent,
         rows_run=rows_run, wall_s=cwall, errors=cerrors[:5])
    check(not any(t.is_alive() for t in pool), "Cauchy submitters finished")
    check(not cerrors, "Cauchy dispatcher results verified")
    check(rows_run == rows_sent,
          "every dispatch ran the rows of its own packetsize only")
    check(disp.stats["dispatches"] < disp.stats["ops"],
          "Cauchy ops coalesced")
    slice_s = time.perf_counter() - t_slice
    slice_gf_launches = gf_kernel.LAUNCHES
    slice_packet_launches = packet_kernel.LAUNCHES
    slice_packet_by_design = packet_kernel.launches_by_design()
    emit("codecs", slice_s=slice_s, gf_bitmatrix_launches=slice_gf_launches,
         gf_packet_launches=slice_packet_launches,
         gf_packet_launches_by_design=slice_packet_by_design)
    check(slice_gf_launches > 0 and slice_packet_launches > 0,
          "the slice's path launched both kernels")
    check(sum(slice_packet_by_design.values()) == slice_packet_launches,
          "every packet launch counted by its design")

    # -- 7. the write transform's kernels against their plain versions ----
    def as_i64(t):
        """uint32 results as int64 values, for comparison on the card."""
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    def diff(a, b):
        if a.numel() == 0:
            return 0
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    consts = ft.dev_consts(dev)
    CUDA_PER_CALL = {"crc32_rows": 1, "xxh32_rows": 1, "bitplane_stage": 1}
    wk_worst = dict.fromkeys(wk.LAUNCHES, 0)
    wk_timed = {}

    def write_case(kernel, name, fn, plain, inputs=None, bound=None,
                   library=None, **info):
        """One call held against the plain version byte for byte (uint32
        results as values); with `inputs`, kernel and plain timed over
        them (rotated out of L2) beside the bound."""
        before = wk.LAUNCHES[kernel]
        cuda_before = sum(wk.launches_by_kernel().values())
        out = fn(inputs[0] if inputs else None)
        torch.cuda.synchronize()
        launched = wk.LAUNCHES[kernel] - before
        info["cuda_launches"] = sum(wk.launches_by_kernel().values()) - \
            cuda_before
        ref = plain(inputs[0] if inputs else None)
        if isinstance(out, tuple):       # K3: (stored, dec)
            err = max(diff(out[0], ref[0]),
                      diff(out[1][:3], ref[1][:3]), diff(out[1][4:],
                                                         ref[1][4:]))
            milli = int(out[1][3]), int(ref[1][3])
            info["entropy_milli"] = milli
            info["fields"] = dict(zip(wk.DEC_FIELDS, out[1].tolist()))
            check(abs(milli[0] - milli[1]) <= 1,
                  "%s entropy_milli within 1 of plain" % name)
        else:
            err = diff(as_i64(out), as_i64(ref))
        wk_worst[kernel] = max(wk_worst[kernel], err)
        rec = {"kernel": kernel, "case": name, "equal": err == 0,
               "max_abs_err": err, **info}
        if inputs and len(inputs) > 1:
            rec["ms"] = time_ms(fn, inputs, 40)
            rec["plain_ms"] = time_ms(plain, inputs, 3)
            rec["bound_ms"], rec["bound_by"] = bound
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
            rec["library_ms"] = time_ms(library, inputs, 40) \
                if library else None
            wk_timed[name] = rec
        emit("write_kernels", **rec)
        check(launched == 1, "%s launched its kernel once" % name)
        check(info["cuda_launches"] == CUDA_PER_CALL[kernel],
              "%s made %d CUDA launches" % (name, CUDA_PER_CALL[kernel]))
        check(err == 0, "%s equals its plain version" % name)
        return out

    WCHUNK, WSTRIPES = 4096, 128         # one 4 MiB object at stripe_unit 4096
    BCHUNK, BSTRIPES = 65536, 16         # the bench's fused shape
    obj_sets = [rand_dev(WSTRIPES, K, WCHUNK) for _ in range(16)]
    bench_sets = [rand_dev(BSTRIPES, K, BCHUNK) for _ in range(8)]
    zc, cc = consts[ft.POLY_ZLIB], consts[ft.POLY_C]

    def crc_fn(poly, shape3, pad=None):
        return (lambda x: wk.crc32_rows(x.view(*shape3), poly, pad),
                lambda x: wk.crc32_rows_plain(x.view(*shape3), poly, pad))

    for sets, (s_, c_) in ((obj_sets, (WSTRIPES, WCHUNK)),
                           (bench_sets, (BSTRIPES, BCHUNK))):
        shape3 = (s_ * K, 1, c_)
        fn, plain = crc_fn(cc, shape3)
        out = write_case("crc32_rows", "chunk_crc32c_%dx%dx%d" % (s_, K, c_),
                         fn, plain, sets, crc_bound(sets[0].view(*shape3),
                                                    torch.empty(s_ * K)),
                         rows=s_ * K, length=c_)
        fn = lambda x: wk.xxh32_rows(x.view(-1, x.shape[-1]))
        plain = lambda x: wk.xxh32_rows_plain(x.view(-1, x.shape[-1]))
        write_case("xxh32_rows", "chunk_xxh32_%dx%dx%d" % (s_, K, c_), fn,
                   plain, sets, xxh32_bound(sets[0].view(-1, c_)),
                   rows=s_ * K, length=c_)
        for rows in (3, 33):             # a warp's 8 rows, not filled
            part = sets[1].view(-1, c_)[:rows]
            write_case("xxh32_rows", "chunk_xxh32_%dx%d" % (rows, c_),
                       lambda _: wk.xxh32_rows(part),
                       lambda _: wk.xxh32_rows_plain(part), rows=rows,
                       length=c_)
    # the store mode's shard streams of [128, 11, 4096], read in place
    shard_sets = [rand_dev(WSTRIPES, K + M, WCHUNK) for _ in range(12)]
    write_case("crc32_rows", "shard_crc32_128x11x4096",
               lambda x: wk.crc32_rows(x.permute(1, 0, 2), zc),
               lambda x: wk.crc32_rows_plain(x.permute(1, 0, 2), zc),
               shard_sets, crc_bound(shard_sets[0], torch.empty(K + M)),
               rows=K + M, length=WSTRIPES * WCHUNK)
    del shard_sets
    # compress-mode capacity of a 4 MiB object, un-shifted by a pad of
    # none, one stripe and most of the capacity
    s_cap = ft.plan_capacity(WSTRIPES * K * WCHUNK, K * WCHUNK) // (K * WCHUNK)
    cap_rows = rand_dev(s_cap, K + M, WCHUNK)
    for stripes in (0, 1, s_cap - 1):
        pad = torch.tensor([stripes * WCHUNK], device=dev)
        write_case("crc32_rows", "shard_crc32_pad_%d_stripes" % stripes,
                   lambda _: wk.crc32_rows(cap_rows.permute(1, 0, 2), zc, pad),
                   lambda _: wk.crc32_rows_plain(cap_rows.permute(1, 0, 2),
                                                 zc, pad),
                   rows=K + M, length=s_cap * WCHUNK, pad=stripes * WCHUNK)
    host_tail = cap_rows.clone()
    host_tail[3:] = 0
    got = wk.crc32_rows(host_tail.permute(1, 0, 2), zc,
                        torch.tensor([(s_cap - 3) * WCHUNK], device=dev))
    tail = host_tail[:3].cpu().numpy()
    check([int(c) for c in as_i64(got).tolist()] == [
        zlib.crc32(np.ascontiguousarray(tail[:, i]).tobytes())
        for i in range(K + M)], "un-shifted shard crcs equal zlib")
    del cap_rows, host_tail
    for chunk in (1, 15, 96, 4097):      # ragged chunks: the byte paths
        batch = rand_dev(64, K, chunk)
        write_case("crc32_rows", "chunk_crc32c_ragged_%d" % chunk,
                   lambda _: wk.crc32_rows(batch.view(64 * K, 1, chunk), cc),
                   lambda _: wk.crc32_rows_plain(batch.view(64 * K, 1, chunk),
                                                 cc), rows=64 * K,
                   length=chunk)
        write_case("crc32_rows", "shard_crc32_ragged_%d" % chunk,
                   lambda _: wk.crc32_rows(batch.permute(1, 0, 2), zc),
                   lambda _: wk.crc32_rows_plain(batch.permute(1, 0, 2), zc),
                   rows=K, length=64 * chunk)
        write_case("xxh32_rows", "chunk_xxh32_ragged_%d" % chunk,
                   lambda _: wk.xxh32_rows(batch.view(64 * K, chunk)),
                   lambda _: wk.xxh32_rows_plain(batch.view(64 * K, chunk)),
                   rows=64 * K, length=chunk)
        write_case("xxh32_rows", "chunk_xxh32_ragged_%d_33_rows" % chunk,
                   lambda _: wk.xxh32_rows(batch.view(64 * K, chunk)[:33]),
                   lambda _: wk.xxh32_rows_plain(
                       batch.view(64 * K, chunk)[:33]), rows=33,
                   length=chunk)
    odd = off_by_one(64 * K, WCHUNK)
    write_case("xxh32_rows", "chunk_xxh32_offset1", lambda _: wk.xxh32_rows(
        odd), lambda _: wk.xxh32_rows_plain(odd), rows=64 * K, length=WCHUNK)
    write_case("crc32_rows", "chunk_crc32c_offset1", lambda _: wk.crc32_rows(
        odd.view(64 * K, 1, WCHUNK), cc), lambda _: wk.crc32_rows_plain(
        odd.view(64 * K, 1, WCHUNK), cc), rows=64 * K, length=WCHUNK)
    # device_crc32's stream: one 8 MiB + 3 byte row
    long_sets = [rand_dev(1, 1, (8 << 20) + 3) for _ in range(8)]
    got = write_case("crc32_rows", "device_crc32_8MiB+3",
                     lambda x: wk.crc32_rows(x, zc),
                     lambda x: wk.crc32_rows_plain(x, zc), long_sets,
                     crc_bound(long_sets[0], torch.empty(1)), rows=1,
                     length=(8 << 20) + 3)
    check(int(as_i64(got)[0]) == zlib.crc32(long_sets[0].cpu().numpy()
                                            .tobytes()),
          "8 MiB + 3 crc equals zlib")
    del long_sets, odd

    def bitplane_fn(n, sw, chunk):
        cap2 = ft.plan_capacity(n, sw)
        return (cap2,
                lambda x: wk.bitplane_stage(x.view(-1), cap2, sw, chunk,
                                            875, 7000),
                lambda x: wk.bitplane_stage_plain(x.view(-1), cap2, sw, chunk,
                                                  875, 7000),
                lambda x: torch.bincount(x.view(-1), minlength=256))

    low_obj = [on_dev(rng.integers(0, 4, (WSTRIPES, K, WCHUNK),
                                   dtype=np.uint8)) for _ in range(16)]
    low_bench = [on_dev(rng.integers(0, 4, (BSTRIPES, K, BCHUNK),
                                     dtype=np.uint8)) for _ in range(8)]
    for kind, sets, chunk in (("low", low_obj, WCHUNK),
                              ("random", obj_sets, WCHUNK),
                              ("zeros", [torch.zeros_like(obj_sets[0])],
                               WCHUNK),
                              ("low", low_bench, BCHUNK)):
        n = sets[0].numel()
        cap2, fn, plain, lib = bitplane_fn(n, K * chunk, chunk)
        timed = kind == "low"
        out = write_case("bitplane_stage", "bitplane_%s_%d" % (kind, n), fn,
                         plain, sets if timed else sets[:1],
                         bitplane_bound(sets[0], cap2) if timed else None,
                         lib if timed else None, n=n, cap2=cap2)
        check(bool(out[1][1]) == (kind != "random"),
              "bitplane %s decision" % kind)
    ones = torch.full_like(obj_sets[0], 255)
    cap2, fn, plain, _ = bitplane_fn(ones.numel(), K * WCHUNK, WCHUNK)
    out = write_case("bitplane_stage", "bitplane_ones_%d" % ones.numel(),
                     lambda _: fn(ones), lambda _: plain(ones),
                     n=ones.numel(), cap2=cap2)
    check(bool(out[1][1]), "bitplane ones decision")
    ragged = rand_dev(4 * K * 4097)          # N not a multiple of 64
    cap2, fn, plain, _ = bitplane_fn(ragged.numel(), K * 4097, 4097)
    write_case("bitplane_stage", "bitplane_ragged_%d" % ragged.numel(),
               lambda _: fn(ragged), lambda _: plain(ragged),
               n=ragged.numel(), cap2=cap2)
    # 16 MiB: more 64-byte blocks than the resident grid has threads, so
    # the tiles past it are loaded and transposed again after the barrier
    big = on_dev(rng.integers(0, 4, 16 << 20, dtype=np.uint8))
    cap2, fn, plain, _ = bitplane_fn(big.numel(), K * WCHUNK, WCHUNK)
    recomputed0 = wk.bitplane_recomputed_tiles()
    out = write_case("bitplane_stage", "bitplane_low_%d" % big.numel(),
                     lambda _: fn(big), lambda _: plain(big),
                     n=big.numel(), cap2=cap2)
    big_recomputed = wk.bitplane_recomputed_tiles() - recomputed0
    check(bool(out[1][1]) and big_recomputed > 0,
          "16 MiB compresses, with tiles past the resident grid")
    # no memset before a bit-plane call: the scratch the kernel leaves
    # zeroed is reused, so the wrapper clears nothing
    clears = []
    saved = torch.zeros, torch.zeros_like, torch.Tensor.zero_
    torch.zeros = lambda *a, **k: clears.append("zeros") or saved[0](*a, **k)
    torch.zeros_like = lambda *a, **k: clears.append("zeros_like") or \
        saved[1](*a, **k)
    torch.Tensor.zero_ = lambda t: clears.append("zero_") or saved[2](t)
    try:
        fn(big)
    finally:
        torch.zeros, torch.zeros_like, torch.Tensor.zero_ = saved
    torch.cuda.synchronize()
    emit("write_kernels", case="bitplane_no_memset", clears=clears,
         recomputed_tiles_16MiB=big_recomputed)
    check(not clears, "a bit-plane call clears no buffer")
    del ragged, bench_sets, low_bench, big, ones
    wk_by_kernel = wk.launches_by_kernel()
    emit("write_kernels", worst=wk_worst, launches_by_kernel=wk_by_kernel)

    # -- 8. the write path: ec_util, the dispatcher's fused leg ----------
    gf_kernel.reset_launches()
    wk.reset_launches()
    t_write = time.perf_counter()
    wcodec = registry.factory("torch_cuda", dict(PROFILE))
    check(ft.fused_supported(wcodec) and wcodec.device.type == "cuda",
          "the RS codec fuses, on the card")
    sinfo = ec_util.StripeInfo(K, K * WCHUNK)
    obj_bytes = WSTRIPES * K * WCHUNK
    payload = rng.integers(0, 256, obj_bytes, dtype=np.uint8)
    # (a) store mode, the OSD's default write
    counts0 = (dict(wk.launches_by_kernel()), gf_kernel.LAUNCHES)
    shards, r = ec_util.encode_fused(sinfo, wcodec, payload)
    per_write = {k_: v - counts0[0][k_]
                 for k_, v in wk.launches_by_kernel().items()}
    per_write["gf_bitmatrix"] = gf_kernel.LAUNCHES - counts0[1]
    check(sum(per_write.values()) == 5, "a store write is 5 launches: "
          "K1 three times, K2 and the GF encode once each")
    separate = ec_util.encode(sinfo, wcodec, payload)
    check(set(shards) == set(separate) and all(
        np.array_equal(shards[s], separate[s]) for s in separate),
        "fused store shards equal ec_util.encode")
    check(r.shard_crcs == [zlib.crc32(shards[s].tobytes())
                           for s in range(K + M)],
          "all 11 shard crcs equal zlib")
    batch_np = payload.reshape(WSTRIPES, K, WCHUNK)
    samples = [(0, 0), (1, 5), (63, 2), (64, 7), (100, 4), (127, 7)]
    check(all(int(r.chunk_crc32c[s, i]) == ft.crc32c_host(batch_np[s, i])
              and int(r.chunk_xxh32[s, i]) == ft.xxh32_host(batch_np[s, i])
              for s, i in samples), "sampled chunk digests equal the host "
          "oracles")
    batch_dev = on_dev(batch_np)
    par_dev = on_dev(r.parity)
    check(np.array_equal(r.chunk_crc32c, as_i64(wk.crc32_rows_plain(
        batch_dev.view(-1, 1, WCHUNK), cc)).view(WSTRIPES, K).cpu().numpy())
          and np.array_equal(r.chunk_xxh32, as_i64(wk.xxh32_rows_plain(
              batch_dev.view(-1, WCHUNK))).view(WSTRIPES, K).cpu().numpy())
          and r.shard_crcs == as_i64(torch.cat([
              wk.crc32_rows_plain(batch_dev.permute(1, 0, 2), zc),
              wk.crc32_rows_plain(par_dev.permute(1, 0, 2), zc)])).tolist(),
          "every digest equals the plain version on the card")
    reps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ec_util.encode_fused(sinfo, wcodec, payload)
    store_s = (time.perf_counter() - t0) / reps
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for _ in range(reps):
        ft.run_fused(wcodec, batch_dev)
    ev1.record()
    torch.cuda.synchronize()
    store_dev_ms = ev0.elapsed_time(ev1) / reps
    # where a write's time goes: the h2d of the payload, the device time
    # of its launches queued behind a spin (no host in the way), the
    # host's launch calls, and the d2h of its outputs
    t0 = time.perf_counter()
    for _ in range(reps):
        staged = host_tensor(batch_np).to(dev)
    torch.cuda.synchronize()
    h2d_s = (time.perf_counter() - t0) / reps
    queued_ms = time_ms(lambda x: ft.run_fused(wcodec, x), obj_sets, 20)
    compress_queued_ms = time_ms(
        lambda x: ft.run_fused(wcodec, x, mode="compress"), low_obj, 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = ft.run_fused(wcodec, staged)
    launch_s = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ft.to_host(out)
    d2h_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):              # the host's part: the shard map
        ec_util._shard_map(wcodec, batch_np, r.parity, None)
    shard_map_s = (time.perf_counter() - t0) / reps
    emit("write_path", case="store_4MiB", shape=[WSTRIPES, K, WCHUNK],
         launches_per_write=per_write,
         launches_per_write_total=sum(per_write.values()),
         write_ms=store_s * 1e3, write_MBps=obj_bytes / store_s / 1e6,
         device_ms=store_dev_ms,
         device_MBps=obj_bytes / store_dev_ms / 1e3,
         h2d_ms=h2d_s * 1e3, device_queued_ms=queued_ms,
         host_launch_ms=launch_s * 1e3, d2h_ms=d2h_s * 1e3,
         shard_map_ms=shard_map_s * 1e3,
         compress_device_queued_ms=compress_queued_ms)
    del batch_dev, par_dev, staged, out, obj_sets, low_obj
    # (b) compress mode: the bench's shape and the 4 MiB object
    bsinfo = ec_util.StripeInfo(K, K * BCHUNK)
    low = rng.integers(0, 4, BSTRIPES * K * BCHUNK, dtype=np.uint8)
    counts0 = (dict(wk.launches_by_kernel()), gf_kernel.LAUNCHES)
    cshards, cr = ec_util.encode_fused(bsinfo, wcodec, low, mode="compress")
    per_cwrite = {k_: v - counts0[0][k_]
                  for k_, v in wk.launches_by_kernel().items()}
    per_cwrite["gf_bitmatrix"] = gf_kernel.LAUNCHES - counts0[1]
    check(sum(per_cwrite.values()) == 6, "a compress write is 6 launches: "
          "K1 three times, K2, K3 and the GF encode once each")
    twin, padded = ft.bitplane_compress_host(low.tobytes())
    stored = cr.stored.reshape(-1)
    check(cr.compressed and stored[:cr.comp_len].tobytes() == twin and
          not stored[cr.comp_len:].any(),
          "the container equals bitplane_compress_host")
    check(ft.bitplane_decompress(twin, padded)[:low.size] == low.tobytes(),
          "the container decompresses to the payload")
    check(np.array_equal(cr.parity, wcodec.encode_batch(cr.stored)),
          "the parity is the encode of the stored rows")
    check(cr.shard_crcs == [zlib.crc32(cshards[s].tobytes())
                            for s in range(K + M)],
          "compressed shard crcs equal zlib")
    low4 = rng.integers(0, 4, obj_bytes, dtype=np.uint8)
    _, cr4 = ec_util.encode_fused(sinfo, wcodec, low4, mode="compress")
    check(cr4.compressed and cr4.comp_len * 1000 <= obj_bytes * 875,
          "a 4 MiB low-entropy object compresses")
    _, rr = ec_util.encode_fused(sinfo, wcodec, payload, mode="compress")
    check(not rr.probe_ok and not rr.compressed and
          rr.used_stripes == WSTRIPES and np.array_equal(rr.stored, batch_np),
          "random bytes: the probe rejects and the raw bytes are stored")
    emit("write_path", case="compress", bench_shape=[BSTRIPES, K, BCHUNK],
         launches_per_write=per_cwrite,
         launches_per_write_total=sum(per_cwrite.values()),
         device_queued_ms_4MiB=compress_queued_ms,
         bench={"comp_len": cr.comp_len, "used_stripes": cr.used_stripes,
                "entropy_bpb": cr.entropy_bpb},
         obj_4MiB={"compressed": cr4.compressed, "comp_len": cr4.comp_len,
                   "ratio": cr4.comp_len / obj_bytes},
         random_4MiB={"probe_ok": rr.probe_ok, "entropy_bpb": rr.entropy_bpb,
                      "used_stripes": rr.used_stripes})
    # (c) the dispatcher: 8 threads, 8 objects of 4 MiB, one in four
    # compressed
    objects = [rng.integers(0, 4 if t % 4 == 0 else 256, obj_bytes,
                            dtype=np.uint8).reshape(WSTRIPES, K, WCHUNK)
               for t in range(threads)]
    modes = ["compress" if t % 4 == 0 else "store" for t in range(threads)]
    expect = [ft.finish_fused(ft.run_fused(wcodec, o, mode=md), WSTRIPES, K,
                              WCHUNK, md) for o, md in zip(objects, modes)]
    disp = GpuDispatcher()
    fused_iters = 4
    ferrors: list[str] = []

    def fused_writer(tid):
        try:
            for _ in range(fused_iters):
                got = ft.result_from_host(disp.fused_write_async(
                    wcodec, objects[tid], mode=modes[tid]).result(300),
                    WSTRIPES, K, WCHUNK, modes[tid])
                exp = expect[tid]
                if got.shard_crcs != exp.shard_crcs or got.compressed != \
                        exp.compressed or not np.array_equal(
                            got.parity, exp.parity) or not np.array_equal(
                            got.chunk_xxh32, exp.chunk_xxh32) or (
                        got.stored is not None and not np.array_equal(
                            got.stored, exp.stored)):
                    ferrors.append("fused write mismatch, thread %d" % tid)
        except Exception as e:  # reported below; the run then fails
            ferrors.append(repr(e))

    def run_writers():
        pool = [threading.Thread(target=fused_writer, args=(t,))
                for t in range(threads)]
        t0 = time.perf_counter()
        for t in pool:
            t.start()
        for t in pool:
            t.join(600)
        return time.perf_counter() - t0, any(t.is_alive() for t in pool)

    run_writers()                        # warm the pinned-memory caches
    disp.perf.reset()
    counts0 = (dict(wk.launches_by_kernel()), gf_kernel.LAUNCHES)
    d0 = disp.stats["dispatches"]
    fwall, alive = run_writers()
    fperf = disp.perf.dump()
    disp.shutdown()
    nwrites = threads * fused_iters
    launches_disp = {k_: (v - counts0[0][k_]) / nwrites
                     for k_, v in wk.launches_by_kernel().items()}
    launches_disp["gf_bitmatrix"] = (gf_kernel.LAUNCHES - counts0[1]) / nwrites
    emit("write_path", case="dispatcher", threads=threads,
         writes=nwrites, dispatches=disp.stats["dispatches"] - d0,
         writes_per_s=nwrites / fwall,
         MBps=nwrites * obj_bytes / fwall / 1e6, wall_s=fwall,
         h2d_s=fperf["l_gpu_h2d"]["sum"],
         compute_s=fperf["l_gpu_compute"]["sum"],
         d2h_s=fperf["l_gpu_d2h"]["sum"],
         queue_s=fperf["l_gpu_dispatch_queue"]["sum"],
         fused={k_: v for k_, v in fperf.items()
                if k_.startswith("l_gpu_fused")},
         stats=disp.fused_stats, launches_per_write=launches_disp,
         errors=ferrors[:5])
    check(not alive and not ferrors, "fused dispatcher results verified")
    check(disp.stats["coalesced"] == 0 and
          fperf["l_gpu_fused_dispatches"] == nwrites,
          "every fused write its own dispatch")
    check(fperf["l_gpu_fused_compressed"] == nwrites // 4,
          "one fused write in four compressed")
    del objects, expect
    # (d) fused against separate, the bench's comparison, interleaved
    bbatch = low.reshape(BSTRIPES, K, BCHUNK)

    def fused_once():
        return ft.finish_fused(ft.run_fused(wcodec, bbatch, mode="compress"),
                               BSTRIPES, K, BCHUNK, "compress")

    def separate_once():
        parity = wcodec.encode_batch(bbatch)            # h2d, encode, d2h
        allr = np.concatenate([bbatch, parity], axis=1)
        crcs = [zlib.crc32(np.ascontiguousarray(allr[:, i]).tobytes())
                for i in range(K + M)]
        body, _ = ft.bitplane_compress_host(bbatch.tobytes())
        return crcs, len(body)

    fused_once()
    separate_once()
    windows = {"fused": [], "separate": []}
    for w_ in range(5):
        order = ("fused", "separate") if w_ % 2 == 0 else ("separate",
                                                           "fused")
        for name in order:
            fn = fused_once if name == "fused" else separate_once
            t0 = time.perf_counter()
            for _ in range(2):
                fn()
            windows[name].append((time.perf_counter() - t0) / 2)
    vol = bbatch.size
    fused_mbps = vol / statistics.median(windows["fused"]) / 1e6
    sep_mbps = vol / statistics.median(windows["separate"]) / 1e6
    emit("write_path", case="fused_vs_separate",
         shape=[BSTRIPES, K, BCHUNK], fused_MBps=fused_mbps,
         separate_MBps=sep_mbps, fused_vs_separate=fused_mbps / sep_mbps,
         fused_s=windows["fused"], separate_s=windows["separate"])
    # (e) deep scrub's audit hash
    t0 = time.perf_counter()
    crc = ft.device_crc32(payload.tobytes())
    scrub_s = time.perf_counter() - t0
    check(crc == zlib.crc32(payload.tobytes()), "device_crc32 equals zlib")
    write_s = time.perf_counter() - t_write
    write_launches = dict(wk.LAUNCHES)
    write_by_kernel = wk.launches_by_kernel()
    write_gf_launches = gf_kernel.LAUNCHES
    emit("write_path", case="device_crc32", bytes=obj_bytes,
         seconds=scrub_s, write_path_s=write_s, launches=write_launches,
         launches_by_kernel=write_by_kernel,
         gf_bitmatrix_launches=write_gf_launches)
    check(all(write_launches.values()) and all(write_by_kernel.values())
          and write_gf_launches > 0,
          "the write path launched every kernel")

    # -- 9. batched CRUSH: the bench's map and the 1024-OSD cluster -------
    crush_line = crush_phase(np, torch, dev, smi)

    # -- 10. the device chunk tier ----------------------------------------
    tier_lines = hbm_tier_phase(np, torch, dev, smi)

    # -- 11. the MSR regenerating code ---------------------------------
    msr_part = msr_repair_phase(np, torch, dev, smi)

    # -- 12. telemetry: the dispatcher's stage profiler, spans, ledger -----
    telemetry_phase(np, torch, dev, host_data, host_full, sig_pool)

    # -- 13. the mesh legs, the sharded CRUSH sweep, rateless dispatch -----
    mesh_part = mesh_phase(np, torch, dev, smi)

    # -- 14. the placement control plane: remap, churn, balancer, tools ----
    placement_part = placement_phase(np, torch, dev, smi)

    # -- 15. the native seam: build, host codec, bridge, mapper, CLIs -----
    native_part = native_phase(np, torch, dev, smi)

    # -- 16. the OSD's erasure-coded backend in a loopback PG -------------
    ec_part = ec_backend_phase(np, torch, dev, smi)

    # -- 17. the PG on loopback daemons -----------------------------------
    pg_part = pg_phase(np, torch, dev, smi)

    # -- 18. kernels line -------------------------------------------------
    enc = timings["encode"]
    dec = timings["decode345678910"]
    kernels = [{
        "name": "gf_bitmatrix_encode", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_bitmatrix.cu",
        "replaces": "ceph_tpu/ops/pallas_gf.py:58",
        "design": main_design, "designs": list(gf_kernel.DESIGNS),
        "launches": launches,
        "launches_by_design": launches_by_design,
        "phase2_launches_by_design": phase2_launches,
        "matched": worst == 0 and msr_part["max_abs_err"] == 0,
        "max_abs_err": max(worst, msr_part["max_abs_err"]),
        "ms": enc["ms"], "kernel_ms": enc["ms"],
        "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"], "library_ms": None,
        "decode_ms": dec["ms"], "decode_plain_ms": dec["plain_ms"],
        "decode_bound_ms": dec["bound_ms"],
        "share_of_bound": enc["share_of_bound"],
        "decode_share_of_bound": dec["share_of_bound"],
        "slice_launches": slice_gf_launches,
        "write_path_launches": write_gf_launches,
        "msr_repair_launches_by_design": msr_part["launches_by_design"],
        "msr_repair_launches_by_call": msr_part["launches_by_call"],
        "msr_repair_matrices": msr_part["matrices"],
        "msr_repair_max_abs_err": msr_part["max_abs_err"],
        "mesh_launches": mesh_part["launches"]["gf"],
        "ec_backend_launches_by_design": ec_part["launches"]["gf"],
        "ec_backend_tier_rebuild_launches": ec_part["tier_rebuild"]["gf"],
        "ec_backend_msr_tier_launches": ec_part["msr_tier"]["gf"],
        "pg_launches_by_design": pg_part["launches"]["gf"],
        "pg_degraded_read_launches": pg_part["rs"]["degraded"][
            "two_down"]["bitsliced"],
        "pg_recovery_launches": pg_part["rs"]["recovery"]["launches"]["gf"],
        "pg_msr_launches": pg_part["msr"]["launches"]["gf"],
        "bridge_launches": native_part["bridge_launches"],
        "bridge_batches": native_part["bridge_batches"],
        "bridge_requests": native_part["bridge_requests"],
        "mesh_block": mesh_part["block_gf"], "mesh_legs": mesh_part["legs"],
        "shape": {"bitmat": enc["bitmat"], "data": enc["data"],
                  "decode_bitmat": dec["bitmat"]}}, {
        "name": "gf_packet_encode", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_packet.cu",
        "replaces": "ceph_tpu/ops/xor_mm.py:110",
        "design": penc["design"], "launches": slice_packet_launches,
        "launches_by_design": slice_packet_by_design,
        "phase5_launches_by_design": phase5_launches,
        "matched": packet_worst == 0, "max_abs_err": packet_worst,
        "ms": penc["ms"], "kernel_ms": penc["ms"],
        "plain_ms": penc["plain_ms"], "bound_ms": penc["bound_ms"],
        "bound_by": penc["bound_by"], "library_ms": None,
        "decode_ms": pdec["ms"], "decode_plain_ms": pdec["plain_ms"],
        "decode_bound_ms": pdec["bound_ms"],
        "share_of_bound": penc["share_of_bound"],
        "decode_share_of_bound": pdec["share_of_bound"],
        "shape": {"bitmat": penc["bitmat"], "data": penc["data"],
                  "packetsize": penc["packetsize"],
                  "decode_bitmat": pdec["bitmat"]}}]

    CUDA_KERNELS = {"crc32_rows": ("crc_rows",),
                    "xxh32_rows": ("xxh32",),
                    "bitplane_stage": ("bitplane",)}

    def write_line(name, kernel, replaces, main, extra):
        """A write-transform kernel's line: launches on the write path,
        the worst error over phase 7, the times of its main-path case."""
        rec = wk_timed[main]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ceph_tpu_torch/csrc/write_transform.cu",
            "replaces": replaces, "launches": write_launches[kernel],
            "ec_backend_launches": ec_part["launches"]["write"][kernel],
            "pg_launches": pg_part["launches"]["write"][kernel],
            "cuda_launches": {k_: write_by_kernel[k_]
                              for k_ in CUDA_KERNELS[kernel]},
            "matched": wk_worst[kernel] == 0,
            "max_abs_err": wk_worst[kernel], "ms": rec["ms"],
            "kernel_ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "share_of_bound": rec["share_of_bound"], "case": main,
            "other_cases": {c: {f: wk_timed[c][f] for f in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for c in extra}})

    write_line("crc32_rows", "crc32_rows",
               "ceph_tpu/osd/fused_transform.py:354",
               "chunk_crc32c_128x8x4096",
               ["shard_crc32_128x11x4096", "chunk_crc32c_16x8x65536",
                "device_crc32_8MiB+3"])
    write_line("xxh32_rows", "xxh32_rows",
               "ceph_tpu/osd/fused_transform.py:392",
               "chunk_xxh32_128x8x4096", ["chunk_xxh32_16x8x65536"])
    write_line("bitplane_stage", "bitplane_stage",
               "ceph_tpu/osd/fused_transform.py:442",
               "bitplane_low_%d" % obj_bytes,
               ["bitplane_low_%d" % (BSTRIPES * K * BCHUNK)])
    for line in kernels:
        if line["name"] == "crc32_rows":
            # K1 as fused_transform.scrub_crc in phase 17's deep scrub
            line["pg_scrub_launches"] = \
                pg_part["rs"]["scrub"]["hashed_on_card"]
    crush_line["mesh_launches"] = mesh_part["launches"]["crush"]
    crush_line["mesh_share"] = mesh_part["crush_share"]
    crush_line["remap_launches"] = placement_part["launches"]
    crush_line["remap"] = {f: placement_part[f] for f in (
        "parts", "warm_split", "warm_ms", "balancer")}
    kernels.append(crush_line)
    for line in tier_lines:
        if line["name"] == "gf_bitmatrix_multi":
            line["ec_backend_launches_by_design"] = \
                ec_part["launches"]["per_lane"]
            # the PG rebuilds one object at a time (tier.reconstruct); these
            # are the tier's batched rebuild of phase 17's repaired shards
            line["pg_launches_by_design"] = pg_part["launches"]["per_lane"]
        if line["name"] == "chunk_digest":
            line["mesh_launches"] = mesh_part["launches"]["digest"]
            line["mesh_checksum"] = mesh_part["checksum"]
    kernels.extend(tier_lines)
    _records.append({"kernels": kernels})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "chip_smoke.jsonl", "w") as f:
        for rec in _records:
            f.write(json.dumps(rec) + "\n")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
