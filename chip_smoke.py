#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ceph_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path at the bench's real size — Reed-Solomon
reed_sol_van k=8, m=3, w=8 on batches of 16 objects of 1 MiB
([16, 8, 131072] uint8) — and the OSD's fused write of a 4 MiB object
through the entry points a user calls, and holds every kernel of the
paths against its plain PyTorch version on the card. Phases, each printing one JSON line:

  1. setup       build every ``ceph_tpu_torch/csrc/*.cu`` (one nvcc each,
                 all at once), report the card and, from ptxas' log, the
                 registers and spill bytes of every kernel instantiation
                 (a spill fails the phase).
  2. kernel      the GF bitmatrix kernel against ``matrix_encode_plain``
                 on CUDA tensors, on both of its designs: bit-sliced
                 (w=8 k=8 encode and three decode bitmatrices, w=8 k=16
                 m=4 encode and decode, a ragged N, a data pointer one
                 byte off, a [448, 128] bitmatrix whose expansion just
                 fits in shared memory) and popcount (w=8 k=40, w=16,
                 w=32, and w=8 bitmatrices of k = 4, 8, 16 whose
                 expansion does not fit): byte equality, the design each
                 case took and its one launch, as the entry point counts
                 them, kernel / plain times.
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
                 the compress capacity, one 8 MiB + 3 byte stream) and the
                 bit-plane stage (low-entropy, random and all-zero bytes,
                 an N that is not a multiple of 64); CUDA launches per
                 call; kernel / plain / bound times and, for the
                 histogram, torch.bincount.
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
                 write (by kernel and in all), counted from 0 just before
                 the phase.
  9. kernels     one JSON line per the port's kernel table: the design
                 the main path takes, launches on the main path (phases
                 3-4 for the GF bitmatrix kernel, phase 6 for the packet
                 kernel, phase 8 for the write transform's kernels, each
                 counted from 0 just before its path), the GF kernel's
                 launches on phases 6 and 8 as well, max_abs_err, ms,
                 plain_ms, bound_ms, bound_by, library_ms.

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
PROFILE = {"technique": "reed_sol_van", "k": str(K), "m": str(M), "w": str(W)}

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
    from ceph_tpu_torch.ops import _build, gf, gf_kernel, gf_ref, packet_kernel
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
         [rand_dev(2, 40, N // 8)], "popcount"),
        ("encode_k40_offset1", W, gf.generator_to_bitmatrix(coding40, W),
         [off_by_one(2, 40, N // 8 - 3)], "popcount"),
        # E = rows * KMAX*8 words: 224 KiB fits the card's opt-in shared
        # memory, 256 KiB (KMAX = 16, 8, 4) sends w=8 to the popcount kernel
        ("random_448x128", W, rand_bitmat(448, 16),
         [rand_dev(2, 16, N // 8)], "bitsliced"),
        ("random_512x128", W, rand_bitmat(512, 16),
         [rand_dev(2, 16, N // 8)], "popcount"),
        ("random_1024x64", W, rand_bitmat(1024, 8),
         [rand_dev(2, 8, N // 8)], "popcount"),
        ("random_2048x32", W, rand_bitmat(2048, 4),
         [rand_dev(2, 4, N // 8)], "popcount"),
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
            "popcount"))

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
    check(all(phase2_launches.values()), "both designs launched")
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
    CUDA_PER_CALL = {"crc32_rows": 1, "xxh32_rows": 1, "bitplane_stage": 3}
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
    ragged = rand_dev(4 * K * 4097)          # N not a multiple of 64
    cap2, fn, plain, _ = bitplane_fn(ragged.numel(), K * 4097, 4097)
    write_case("bitplane_stage", "bitplane_ragged_%d" % ragged.numel(),
               lambda _: fn(ragged), lambda _: plain(ragged),
               n=ragged.numel(), cap2=cap2)
    del ragged, bench_sets, low_bench
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

    # -- 9. kernels line --------------------------------------------------
    enc = timings["encode"]
    dec = timings["decode345678910"]
    kernels = [{
        "name": "gf_bitmatrix_encode", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_bitmatrix.cu",
        "replaces": "ceph_tpu/ops/pallas_gf.py:58",
        "design": main_design, "launches": launches,
        "launches_by_design": launches_by_design,
        "phase2_launches_by_design": phase2_launches,
        "matched": worst == 0, "max_abs_err": worst,
        "ms": enc["ms"], "kernel_ms": enc["ms"],
        "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"], "library_ms": None,
        "decode_ms": dec["ms"], "decode_plain_ms": dec["plain_ms"],
        "decode_bound_ms": dec["bound_ms"],
        "share_of_bound": enc["share_of_bound"],
        "decode_share_of_bound": dec["share_of_bound"],
        "slice_launches": slice_gf_launches,
        "write_path_launches": write_gf_launches,
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
                    "bitplane_stage": ("bp_count", "bp_decide",
                                       "bp_scatter")}

    def write_line(name, kernel, replaces, main, extra):
        """A write-transform kernel's line: launches on the write path,
        the worst error over phase 7, the times of its main-path case."""
        rec = wk_timed[main]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ceph_tpu_torch/csrc/write_transform.cu",
            "replaces": replaces, "launches": write_launches[kernel],
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
