"""Device time of the GF bitmatrix, packet or write kernels against the batch size.

    python -m ceph_tpu_torch.tools.gf_kernel_sweep [--batches 1,2,4]
        [--kernel gf|designs|mma_rate|packet|crc|xxh32|bitplane] [--split]
        [--parent DIR]

``--kernel gf`` (the default): for the Reed-Solomon k=8, m=3, w=8 encode
bitmatrix ([24, 64]) and the decode bitmatrix of signature (3..10)
([88, 64]), at data [B, 8, 131072] (the main path's objects of 1 MiB)
for each batch size B: the kernel's median device time over 40
launches, its bound, the design the geometry takes and the threads it
needs (one per 32 columns in the bit-sliced design).

``--kernel designs``: the GF bitmatrix kernel through the codecs' entry
point (``xor_mm.matrix_encode``) on every geometry outside the
bit-sliced design (the design each takes is printed), and on the main
path's bit-sliced encode and decode: ``chip_smoke.py`` phase 2's w=8
k=40 (aligned and a data pointer one byte off), its random [512, 128],
[1024, 64] and [2048, 32], the RS k=8, m=3 w=16 and w=32 encodes on
[16, 8, 131072], the RS encode and decode bitmatrices at w=16 with k = 4
and 8 and at w=32 with k = 2, 3, 4 and 8 (k*w <= 128 but one, on
[16, k, 131072]), the MSR k=8, m=7 encode and decode at phase 11's (a)
([8, 56, 18736]) and (b) ([64, 56, 74912]) and the k=10, m=9 encode and
decode on [16, 90, 11664]; ``--only`` keeps the geometries whose names
start with one of its comma-separated prefixes. With ``--parent DIR``
(a checkout whose ``ceph_tpu_torch/`` is
another version of the port) each geometry is timed on both trees in
turns, parent / this / this / parent, on the same inputs, after a
byte-equality check of the two; the launches of this tree's call are
counted by design. Then ``torch._int_mm`` of the (a) decode's unpacked
0/1 operands ([840, 448] int8 times [448, 149888] int8), the rate
cuBLAS gets from the same multiply-adds without the unpacking and
packing (key ``int_mm``; the port never calls it).

``--kernel mma_rate``: the tensor cores' rate through ``mma.sync``
(``gf_timing_mma_rate``): warps of 8 independent accumulator chains on
constant A and B registers, m16n8k32 s8 (the mma design's product) and
the binary path, m16n8k256 b1 with AND and POPC (its multiply-adds are
GF(2) ones, counted as int8 ones are), at 8, 16 and 32 warps an SM;
TOP/s and the share of the H100's dense int8 peak (the binary path's
ratio to the int8 path is what ``utils/cuda_timing.GF2_OPS_PER_S``
rests on).

``--kernel packet``: the packet kernel, every aligned design that takes
a geometry (staged, vector) timed on it in turns (A, B, B, A), the
design the entry point picks with the bitmatrix's set bits marked. For
each batch size B, the cauchy_good k=10, m=4 encode bitmatrix ([32,
80]), the decode bitmatrix with chunks 0-3 erased ([112, 80]) and an
all-zero [32, 80] bitmatrix, which selects nothing and so times a
design's loads and stores alone (the intercept of its time against B is
the fixed part of a launch), at packetsize 2048 on data [B, 10, 131072]
(the BASELINE's Cauchy objects of 1 MiB); then the Liberation family at
its largest k (liberation k=7, w=7; blaum_roth k=6, w=6; liber8tion
k=8), m=2, packetsize 2048, on objects of 1 MiB, encode and the decode
of chunks 0 and 1; then the aligned shapes of ``chip_smoke.py`` phase 5
(random [2w, 3w] bitmatrices at w = 7, 8, 16, 32, packetsizes 2048 and
8192, B = 1 and 16; a [16, 80] bitmatrix at packetsize 2064; Cauchy at
packetsize 8192; a random [32, 80]); and an all-one [16, 24] bitmatrix
(k*w = 24, the densest) on the same shapes as the random one at w = 8.

``--kernel crc``: K1 (``crc32_rows``) on the write path's rows for B
stripes of 4096-byte chunks (an object of B * 32 KiB; 128 stripes is 4
MiB): the chunk crc32c of [B*8, 4096] and the crc32 of the 11 shard
streams of [B, 11, 4096] read in place, and one stream of B * 64 KiB +
3 bytes (the byte path; 8 MiB + 3 at 128, as deep scrub's
``device_crc32``).

``--kernel xxh32``: K2 (``xxh32_rows``) on rows of 4096 and 65536
bytes (the write path's chunks at stripe_unit 4096 and the bench's
64 KiB), for each row count in ``--batches`` (default 1, 2, 4, ..., 1024).
With ``--split``: the cycles of one lane's chain of 4096 dependent rounds
(the chain that ``utils/cuda_timing.XXH_ROUND_CYCLES`` counts), and the
TMA kernel's clock readings at 1, 8, 16 and 128 rows (cycles per block:
the copying warp's time, the computing warp's waits for a stage, its
chain and its total, and each per 16-byte stripe).

``--kernel bitplane``: K3 (``bitplane_stage``) on 64 KiB to 16 MiB of
low-entropy (values 0..3), random and zero bytes at the write path's
stripe width (8 chunks of 4096 bytes). With ``--split``: each of a call's
device operations on its own at 4 and 8 MiB of low-entropy and random
bytes, and at 16 MiB (past the grid the card holds at once): the kernel
with and without its histogram, in turns, the tiles each loaded twice,
and block 0's clock at the
end of each phase (counting, the barrier, the decision, its tiles'
writes, its end).

Every run first times the floor of the timing itself: one 16-byte
``zero_`` between the same events. The inputs rotate through 256 MiB,
so that each launch finds its input out of L2. One JSON line per point,
then the card's name and power limit as nvidia-smi prints them. Needs a
CUDA card; it fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .. import registry
from ..ops import gf, gf_kernel, packet_kernel, write_kernels, xor_mm
from ..osd import fused_transform
from ..utils.cuda_timing import (INT8_OPS_PER_S, bitplane_bound, crc_bound,
                                 gf_bound, packet_bound, time_ms,
                                 xxh32_bound)

K, M, W, N = 8, 3, 8, 131072
PACKET_K, PACKET_M, PACKETSIZE = 10, 4, 2048
ROTATE_BYTES = 256 << 20
OBJECT = 1 << 20
LIBERATION_FAMILY = ({"technique": "liberation", "k": "7", "w": "7"},
                     {"technique": "blaum_roth", "k": "6", "w": "6"},
                     {"technique": "liber8tion", "k": "8"})


def bitmatrices(k: int = K, m: int = M, w: int = W) -> dict[str, np.ndarray]:
    """The RS encode bitmatrix and the decode bitmatrix of the first m
    data chunks lost (K=8, M=3: signature 3..10)."""
    coding = gf.rs_vandermonde_generator(k, m, w)
    avail = tuple(range(m, k + m))
    dec = gf.decode_matrix(coding, k, avail, w)
    full = np.concatenate([dec, gf.gf_matmul(coding, dec, w)])
    return {"encode": gf.generator_to_bitmatrix(coding, w),
            "decode" + "".join(map(str, avail)):
            gf.generator_to_bitmatrix(full, w)}


def packet_bitmatrices() -> dict[str, np.ndarray]:
    coding = gf.cauchy_good_generator(PACKET_K, PACKET_M, W)
    avail = tuple(range(PACKET_M, PACKET_K + PACKET_M))
    dec = gf.decode_matrix(coding, PACKET_K, avail, W)
    full = np.concatenate([dec, gf.gf_matmul(coding, dec, W)])
    return {"encode": gf.generator_to_bitmatrix(coding, W),
            "decode0123": gf.generator_to_bitmatrix(full, W)}


def rotated(pool: torch.Tensor, shape: tuple) -> list[torch.Tensor]:
    """Views of `shape` over successive slices of the pool."""
    size = int(np.prod(shape))
    return [pool[o:o + size].view(shape)
            for o in range(0, ROTATE_BYTES - size + 1, size)]


def gf_sweep(pool: torch.Tensor, batches: list[int], dev) -> None:
    for name, bm_np in bitmatrices().items():
        bm = torch.from_numpy(bm_np).to(dev)
        design = gf_kernel.kernel_design(bm.shape[0], K, W, dev)

        def run(x):
            return gf_kernel.matrix_encode(bm, x, W)
        for b in batches:
            inputs = rotated(pool, (b, K, N))
            out = run(inputs[0])
            ms = time_ms(run, inputs, 40)
            bound_ms, bound_by = gf_bound(bm, inputs[0], out, W)
            print(json.dumps({
                "kernel": "gf", "bitmat": name, "shape": [b, K, N],
                "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / ms, "design": design,
                "threads": b * -(-N // 32)}), flush=True)


def design_geometries():
    """(name, bitmatrix, w, data shape, byte offset of the data) of every
    point of ``--kernel designs``."""
    prng = np.random.default_rng(12)
    coding40 = gf.rs_vandermonde_generator(40, 4, W)
    yield ("encode_k40_m4", gf.generator_to_bitmatrix(coding40, W), W,
           (2, 40, N // 8), 0)
    yield ("encode_k40_offset1", gf.generator_to_bitmatrix(coding40, W), W,
           (2, 40, N // 8 - 3), 1)
    for rows, k in ((512, 16), (1024, 8), (2048, 4)):
        yield ("random_%dx%d" % (rows, k * W),
               prng.integers(0, 2, (rows, k * W), dtype=np.uint8), W,
               (2, k, N // 8), 0)
    for w in (16, 32):
        yield ("encode_w%d" % w, gf.generator_to_bitmatrix(
            gf.rs_vandermonde_generator(K, M, w), w), w, (16, K, N), 0)
    # k*w <= 128 past w=8 (the popcount design's), and 256 at w=32
    for w, k, m in ((16, 4, 2), (16, 8, 3), (32, 2, 2), (32, 3, 2),
                    (32, 4, 2), (32, 8, 3)):
        for part, bm in bitmatrices(k, m, w).items():
            yield ("rs_w%d_k%d_%s" % (w, k, part[:6]), bm, w, (16, k, N),
                   0)
    for k, m, cases in ((8, 7, (("a", 8, 1 << 20), ("b", 64, 4 << 20))),
                        (10, 9, (("c", 16, 1 << 20),))):
        msr = registry.factory("msr_cuda", {"k": str(k), "m": str(m)},
                               device="cpu")
        avail = tuple(range(1, k + 1))
        dec = np.ascontiguousarray(msr._decode_entry(avail)["bitmat"])
        for part, objs, size in cases:
            sub = msr.repair_sub_size(msr.get_chunk_size(size))
            shape = (objs, k * msr.alpha, sub)
            tag = "msr_k%d_%s" % (k, part)
            yield (tag + "_encode", np.ascontiguousarray(msr._bitmat), 8,
                   shape, 0)
            yield (tag + "_decode", dec, 8, shape, 0)
    for name, bm in bitmatrices().items():
        yield ("rs_" + name, bm, W, (16, K, N), 0)


def load_tree(root: str):
    """The ``ops.xor_mm`` module of the port in checkout `root`, imported
    as a package of another name beside this one (its kernels build into
    its own ``build/``)."""
    pkg = Path(root).resolve() / "ceph_tpu_torch"
    name = "parent_ceph_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(name + ".ops.xor_mm")


def designs_sweep(pool: torch.Tensor, batches: list[int], dev,
                  parent: str | None = None,
                  only: str | None = None) -> None:
    trees = {"this": xor_mm}
    if parent:
        trees["parent"] = load_tree(parent)
    order = ["parent", "this", "this", "parent"] if parent else ["this"]
    for name, bm_np, w, shape, offset in design_geometries():
        if only and not name.startswith(tuple(only.split(","))):
            continue
        bm = torch.from_numpy(bm_np).to(dev)
        size = int(np.prod(shape))
        step = -(-size // 16) * 16
        inputs = [pool[o + offset:o + offset + size].view(shape)
                  for o in range(0, ROTATE_BYTES - step - 16 + 1, step)]
        if not inputs:          # (b): one input of its own, past the L2
            inputs = [torch.randint(0, 256, shape, dtype=torch.uint8,
                                    device=dev)]
        before = gf_kernel.launches_by_design()
        out = xor_mm.matrix_encode(bm, inputs[0], w)
        torch.cuda.synchronize()
        after = gf_kernel.launches_by_design()
        for tree, mod in trees.items():
            if not torch.equal(mod.matrix_encode(bm, inputs[0], w), out):
                raise RuntimeError("%s: the %s tree disagrees" % (name, tree))
        if not torch.equal(out[:2], gf_kernel.matrix_encode_plain(
                bm, inputs[0][:2], w)):
            raise RuntimeError("%s: the kernel disagrees with the plain "
                               "version" % name)
        times = {t: [] for t in trees}
        for tree in order:
            mod = trees[tree]
            times[tree].append(time_ms(
                lambda x: mod.matrix_encode(bm, x, w), inputs, 40))
        bound_ms, bound_by = gf_bound(bm, inputs[0], out, w)
        rec = {"kernel": "gf", "geometry": name, "bitmat": list(bm.shape),
               "shape": list(shape), "w": w, "offset": offset,
               "design": gf_kernel.kernel_design(bm.shape[0], shape[-2], w,
                                                 dev),
               "launches": {d: after[d] - before[d] for d in after},
               "row_groups": len(gf_kernel.row_groups(
                   bm.shape[0], shape[-2], w, dev)),
               "ms": times, "bound_ms": bound_ms, "bound_by": bound_by,
               "share_of_bound": {t: bound_ms / min(v)
                                  for t, v in times.items()}}
        if parent:
            rec["this_over_parent"] = (sum(times["this"]) /
                                       sum(times["parent"]))
        print(json.dumps(rec), flush=True)
    # cuBLAS's int8 product on the (a) decode's unpacked 0/1 operands
    msr = registry.factory("msr_cuda", {"k": "8", "m": "7"}, device="cpu")
    dec = torch.from_numpy(np.ascontiguousarray(
        msr._decode_entry(tuple(range(1, 9)))["bitmat"])).to(dev)
    sub = msr.repair_sub_size(msr.get_chunk_size(1 << 20))
    data = rotated(pool, (8, 56, sub))[:3]
    lhs = dec.to(torch.int8)
    rhs = [xor_mm.unpack_element_bits(x, 8).permute(1, 0, 2).reshape(
        448, -1).to(torch.int8).contiguous() for x in data]
    ms = time_ms(lambda x: torch._int_mm(lhs, x), rhs, 40)
    bound_ms, bound_by = gf_bound(dec, data[0], torch.empty(
        (8, 105, sub), dtype=torch.uint8), 8)
    print(json.dumps({"kernel": "int_mm", "geometry": "msr_k8_a_decode",
                      "operands": [list(lhs.shape), list(rhs[0].shape)],
                      "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "share_of_bound": bound_ms / ms}), flush=True)


MMA_RATE_MODES = ("s8_m16n8k32", "b1_and_popc_m16n8k256")


def mma_rate_sweep(pool: torch.Tensor, batches: list[int], dev) -> None:
    lib = gf_kernel._kernel()
    lib.gf_timing_mma_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p,
                                                            ctypes.c_void_p]
    lib.gf_timing_mma_rate.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    threads, iters = 256, 4096
    for per_sm in (1, 2, 4):
        blocks = sms * per_sm
        sink = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
        for mode, name in enumerate(MMA_RATE_MODES):
            def run(_):
                _rc("gf_timing_mma_rate", lib.gf_timing_mma_rate(
                    mode, blocks, threads, iters, sink.data_ptr(), stream))
            ms = time_ms(run, [None], 10)
            depth = 256 if mode == 1 else 32        # K of one mma
            ops = blocks * threads // 32 * iters * 8 * 16 * 8 * depth * 2
            print(json.dumps({
                "kernel": "mma_rate", "mode": name,
                "warps_per_sm": per_sm * threads // 32, "ms": ms,
                "tops": ops / ms / 1e9,
                "share_of_int8_peak": ops / ms / 1e9 / (INT8_OPS_PER_S /
                                                        1e12)}),
                  flush=True)


def packet_geometries(batches: list[int]):
    """(name, bitmatrix, w, packetsize, data shape) of every point."""
    cauchy = packet_bitmatrices()
    cauchy["zeros"] = np.zeros_like(cauchy["encode"])
    for b in batches:
        for name, bm in cauchy.items():
            yield ("cauchy_" + name, bm, W, PACKETSIZE,
                   (b, PACKET_K, N))
    for profile in LIBERATION_FAMILY:
        codec = registry.factory("torch_cuda", dict(
            profile, m="2", packetsize=str(PACKETSIZE)), device="cpu")
        k, w = codec.k, codec.w
        chunk = codec.get_chunk_size(OBJECT)
        dec = codec._decode_entry(tuple(range(2, k + 2)))["bitmat"]
        for b in batches:
            for name, bm in (("encode", codec._bitmat), ("decode01", dec)):
                yield ("%s_k%d_w%d_%s" % (profile["technique"], k, w, name),
                       np.ascontiguousarray(bm), w, PACKETSIZE,
                       (b, k, chunk))
    prng = np.random.default_rng(4)
    for w in (7, 8, 16, 32):
        for packetsize in (2048, 8192):
            bm = prng.integers(0, 2, (2 * w, 3 * w), dtype=np.uint8)
            for b in (1, 16):
                yield ("random_w%d_p%d" % (w, packetsize), bm, w, packetsize,
                       (b, 3, (3 if b == 1 else 2) * w * packetsize))
    for packetsize in (2048, 8192):
        for b in (1, 16):
            supers = 3 if b == 1 else 2
            yield ("ones_w8_p%d" % packetsize, np.ones((16, 24), np.uint8),
                   8, packetsize, (b, 3, supers * 8 * packetsize))
    yield ("random_w8_k10_p2064", prng.integers(0, 2, (16, 80),
                                                dtype=np.uint8),
           8, 2064, (2, 10, 16 * 2064))
    yield ("cauchy_encode_p8192", cauchy["encode"], W, 8192,
           (16, PACKET_K, 2 * N))
    yield ("random_32x80", prng.integers(0, 2, (32, 80), dtype=np.uint8),
           W, PACKETSIZE, (16, PACKET_K, N))


def packet_sweep(pool: torch.Tensor, batches: list[int], dev) -> None:
    for name, bm_np, w, packetsize, shape in packet_geometries(batches):
        bm = torch.from_numpy(bm_np).to(dev)
        set_bits = int(bm_np.sum())
        inputs = rotated(pool, shape)
        picked = packet_kernel.kernel_design(bm, inputs[0], w, packetsize,
                                             set_bits)
        out = packet_kernel.bitmatrix_encode(bm, inputs[0], w, packetsize,
                                             set_bits=set_bits)
        bound_ms, bound_by = packet_bound(bm, inputs[0], out)
        designs = []
        for d in ("staged", "vector"):
            try:
                got = packet_kernel.bitmatrix_encode(bm, inputs[0], w,
                                                     packetsize, design=d)
            except RuntimeError:        # the design does not take it
                continue
            if not torch.equal(got, out):
                raise RuntimeError("%s: the %s design disagrees with the "
                                   "picked one" % (name, d))
            designs.append(d)
        times = {d: [] for d in designs}
        for d in designs + designs[::-1]:       # A, B, B, A
            times[d].append(time_ms(lambda x: packet_kernel.bitmatrix_encode(
                bm, x, w, packetsize, design=d), inputs, 40))
        print(json.dumps({
            "kernel": "packet", "geometry": name, "bitmat": list(bm.shape),
            "shape": list(shape), "w": w, "packetsize": packetsize,
            "set_bits": set_bits, "picked": picked, "ms": times,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": {d: bound_ms / min(t) for d, t in
                               times.items()}}), flush=True)


def crc_sweep(pool: torch.Tensor, batches: list[int], dev) -> None:
    consts = fused_transform.dev_consts(dev)
    chunk, k, n = 4096, K, K + M
    for b in batches:
        cases = (("chunk_crc32c", fused_transform.POLY_C, k * chunk,
                  lambda x: x.view(b * k, 1, chunk)),
                 ("shard_crc32", fused_transform.POLY_ZLIB, n * chunk,
                  lambda x: x.view(b, n, chunk).permute(1, 0, 2)),
                 ("stream_crc32", fused_transform.POLY_ZLIB, 16 * chunk,
                  lambda x: x.view(1, 1, -1)))
        for name, poly, width, view in cases:
            size = b * width + (3 if name == "stream_crc32" else 0)
            views = [view(x) for x in rotated(pool, (size,))]
            ms = time_ms(lambda v: write_kernels.crc32_rows(
                v, consts[poly]), views, 40)
            bound_ms, bound_by = crc_bound(views[0], torch.empty(
                views[0].shape[0]))
            print(json.dumps({
                "kernel": "crc", "case": name, "stripes": b,
                "view": list(views[0].shape), "ms": ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "share_of_bound": bound_ms / ms}),
                flush=True)


def _timing_lib() -> ctypes.CDLL:
    """write_transform's library with its timing-only entry points typed."""
    lib = write_kernels._kernel()
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.wt_timing_xxh32_clocks.argtypes = [p, ll, ll, p, p, p]
    lib.wt_timing_xxh_chain.argtypes = [p, i, p, p, p]
    lib.wt_timing_bitplane.argtypes = [i, p, ll, ll, ll, ll, p, p, p, p,
                                       ctypes.POINTER(ll), p]
    for fn in (lib.wt_timing_xxh32_clocks, lib.wt_timing_xxh_chain,
               lib.wt_timing_bitplane):
        fn.restype = i
    return lib


def _rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError("%s failed with code %d" % (name, rc))


XXH_LENGTHS = (4096, 65536)
XXH_CLOCKS = ("copier", "wait", "chain", "total")


def xxh32_sweep(pool: torch.Tensor, batches: list[int], dev,
                split: bool = False) -> None:
    if split:
        return xxh32_split(pool, dev)
    for length in XXH_LENGTHS:
        for rows in batches:
            inputs = rotated(pool, (rows, length))
            ms = time_ms(write_kernels.xxh32_rows, inputs, 40)
            bound_ms, bound_by = xxh32_bound(inputs[0])
            print(json.dumps({
                "kernel": "xxh32", "rows": rows, "length": length, "ms": ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / ms,
                "ns_per_stripe": ms * 1e6 / (length // 16)}), flush=True)


def xxh32_split(pool: torch.Tensor, dev) -> None:
    lib = _timing_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    words = pool[:256].view(torch.int32).clone()
    out = torch.empty(32, dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    rounds = 4096
    for _ in range(3):
        _rc("wt_timing_xxh_chain", lib.wt_timing_xxh_chain(
            words.data_ptr(), rounds, out.data_ptr(), cycles.data_ptr(),
            stream))
    torch.cuda.synchronize()
    print(json.dumps({"kernel": "xxh32", "split": "chain",
                      "rounds": rounds, "cycles": int(cycles),
                      "cycles_per_round": int(cycles) / rounds}), flush=True)
    for length in XXH_LENGTHS:
        for rows in (1, 8, 16, 128):
            inputs = rotated(pool, (rows, length))
            res = torch.empty(rows, dtype=torch.int32, device=dev)
            blocks = -(-rows // 8)
            clocks = torch.zeros(blocks, 4, dtype=torch.int64, device=dev)
            for x in inputs[:3]:
                _rc("wt_timing_xxh32_clocks", lib.wt_timing_xxh32_clocks(
                    x.data_ptr(), rows, length, res.data_ptr(),
                    clocks.data_ptr(), stream))
            torch.cuda.synchronize()
            if not torch.equal(res, write_kernels.xxh32_rows(
                    inputs[2]).view(torch.int32)):
                raise RuntimeError("the clocked kernel disagrees")
            c = clocks.double().mean(0).tolist()
            stripes = length // 16
            print(json.dumps({
                "kernel": "xxh32", "split": "clocks", "rows": rows,
                "length": length,
                "ms": time_ms(write_kernels.xxh32_rows, inputs, 40),
                "cycles": dict(zip(XXH_CLOCKS, c)),
                "cycles_per_stripe": dict(zip(
                    XXH_CLOCKS, [v / stripes for v in c]))}), flush=True)


BITPLANE_SIZES = (64 << 10, 256 << 10, 1 << 20, 4 << 20, 8 << 20, 16 << 20)
BP_SW, BP_CHUNK = 8 * 4096, 4096


def bitplane_sweep(pool: torch.Tensor, batches: list[int], dev,
                   split: bool = False) -> None:
    pools = {"low": pool & 3, "random": pool}
    if split:
        return bitplane_split(pools, dev)
    pools["zeros"] = torch.zeros_like(pool)
    for kind, src in pools.items():
        for n in BITPLANE_SIZES:
            inputs = rotated(src, (n,))
            cap2 = fused_transform.plan_capacity(n, BP_SW)

            def run(x):
                return write_kernels.bitplane_stage(x, cap2, BP_SW, BP_CHUNK,
                                                    875, 7000)
            dec = run(inputs[0])[1]
            ms = time_ms(run, inputs, 40)
            bound_ms, bound_by = bitplane_bound(inputs[0], cap2)
            print(json.dumps({
                "kernel": "bitplane", "kind": kind, "n": n, "ms": ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / ms,
                "do_compress": int(dec[1])}), flush=True)


BP_VARIANTS = {"kernel": 0, "no_hist": 1}
BP_PHASES = ("counted", "barrier", "decided", "written", "end")


def bitplane_split(pools: dict, dev) -> None:
    lib = _timing_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for kind, src in pools.items():
        for n in (4 << 20, 8 << 20, 16 << 20):
            inputs = rotated(src, (n,))
            cap2 = fused_transform.plan_capacity(n, BP_SW)
            scratch = write_kernels._scratch_for(
                dev, stream, write_kernels._kernel().wt_bitplane_scratch_words(
                    n))
            dec = torch.zeros(6, dtype=torch.int64, device=dev)
            stored = torch.empty(cap2, dtype=torch.uint8, device=dev)
            clocks = torch.zeros(5, dtype=torch.int64, device=dev)
            grid = ctypes.c_longlong(0)
            tiles = -(-(-(-n // 64)) // 256)    # of 256 64-byte blocks

            def run(x, variant):
                _rc("wt_timing_bitplane", lib.wt_timing_bitplane(
                    variant, x.data_ptr(), n, cap2, BP_SW, BP_CHUNK,
                    scratch.data_ptr(), dec.data_ptr(), stored.data_ptr(),
                    clocks.data_ptr(), ctypes.byref(grid), stream))
            ms, recomputed = {}, {}
            for name in (*BP_VARIANTS, *reversed(BP_VARIANTS)):  # in turns
                run(inputs[0], BP_VARIANTS[name])
                recomputed[name] = tiles - grid.value
                ms.setdefault(name, []).append(time_ms(
                    lambda x: run(x, BP_VARIANTS[name]), inputs, 40))
            phases = []
            for x in inputs[:3]:
                run(x, 2)
                torch.cuda.synchronize()
                phases.append(dict(zip(BP_PHASES, clocks.tolist())))
            print(json.dumps({"kernel": "bitplane", "split": "variants",
                              "kind": kind, "n": n, "ms": ms,
                              "recomputed_tiles": recomputed,
                              "block0_cycles": phases[-1]}), flush=True)


SWEEPS = {"gf": gf_sweep, "designs": designs_sweep,
          "mma_rate": mma_rate_sweep, "packet": packet_sweep, "crc": crc_sweep,
          "xxh32": xxh32_sweep, "bitplane": bitplane_sweep}
SPLITS = ("xxh32", "bitplane")
DEFAULT_BATCHES = {"xxh32": "1,2,4,8,16,32,64,128,256,512,1024"}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", default=None,
                   help="comma-separated batch sizes B (rows for xxh32; "
                   "default 1,2,4,6,8,10,11,12,13,14,16)")
    p.add_argument("--kernel", choices=tuple(SWEEPS), default="gf")
    p.add_argument("--split", action="store_true",
                   help="xxh32 and bitplane: time the parts of a call")
    p.add_argument("--parent", default=None,
                   help="designs: a checkout of another version of the "
                   "port, timed in turns with this one")
    p.add_argument("--only", default=None,
                   help="designs: the geometries whose names start with "
                   "one of these comma-separated prefixes")
    args = p.parse_args(argv)
    if args.split and args.kernel not in SPLITS:
        p.error("--split is for --kernel %s" % " or ".join(SPLITS))
    if (args.parent or args.only) and args.kernel != "designs":
        p.error("--parent and --only are for --kernel designs")
    batches = args.batches or DEFAULT_BATCHES.get(
        args.kernel, "1,2,4,6,8,10,11,12,13,14,16")
    if not torch.cuda.is_available():
        print("gf_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(20261016)
    pool = torch.randint(0, 256, (ROTATE_BYTES,), dtype=torch.uint8,
                         device=dev, generator=gen)
    tiny = [torch.empty(16, dtype=torch.uint8, device=dev) for _ in range(8)]
    print(json.dumps({"case": "floor", "what": "zero_ of 16 bytes",
                      "ms": time_ms(lambda x: x.zero_(), tiny, 40)}),
          flush=True)
    run = [int(x) for x in batches.split(",")]
    if args.kernel in SPLITS:
        SWEEPS[args.kernel](pool, run, dev, split=args.split)
    elif args.kernel == "designs":
        designs_sweep(pool, run, dev, parent=args.parent, only=args.only)
    else:
        SWEEPS[args.kernel](pool, run, dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
