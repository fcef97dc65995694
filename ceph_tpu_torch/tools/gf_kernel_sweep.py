"""Device time of the GF bitmatrix, packet or CRC kernel against the batch size.

    python -m ceph_tpu_torch.tools.gf_kernel_sweep [--batches 1,2,4]
        [--kernel gf|packet|crc]

``--kernel gf`` (the default): for the Reed-Solomon k=8, m=3, w=8 encode
bitmatrix ([24, 64]) and the decode bitmatrix of signature (3..10)
([88, 64]), at data [B, 8, 131072] (the main path's objects of 1 MiB)
for each batch size B: the kernel's median device time over 40
launches, its bound, the design the geometry takes and the threads it
needs (one per 32 columns in the bit-sliced design).

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

Every run first times the floor of the timing itself: one 16-byte
``zero_`` between the same events. The inputs rotate through 256 MiB,
so that each launch finds its input out of L2. One JSON line per point,
then the card's name and power limit as nvidia-smi prints them. Needs a
CUDA card; it fails without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from .. import registry
from ..ops import gf, gf_kernel, packet_kernel, write_kernels
from ..osd import fused_transform
from ..utils.cuda_timing import crc_bound, gf_bound, packet_bound, time_ms

K, M, W, N = 8, 3, 8, 131072
PACKET_K, PACKET_M, PACKETSIZE = 10, 4, 2048
ROTATE_BYTES = 256 << 20
OBJECT = 1 << 20
LIBERATION_FAMILY = ({"technique": "liberation", "k": "7", "w": "7"},
                     {"technique": "blaum_roth", "k": "6", "w": "6"},
                     {"technique": "liber8tion", "k": "8"})


def bitmatrices() -> dict[str, np.ndarray]:
    coding = gf.rs_vandermonde_generator(K, M, W)
    avail = (3, 4, 5, 6, 7, 8, 9, 10)
    dec = gf.decode_matrix(coding, K, avail, W)
    full = np.concatenate([dec, gf.gf_matmul(coding, dec, W)])
    return {"encode": gf.generator_to_bitmatrix(coding, W),
            "decode345678910": gf.generator_to_bitmatrix(full, W)}


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


SWEEPS = {"gf": gf_sweep, "packet": packet_sweep, "crc": crc_sweep}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", default="1,2,4,6,8,10,11,12,13,14,16",
                   help="comma-separated batch sizes B")
    p.add_argument("--kernel", choices=tuple(SWEEPS), default="gf")
    args = p.parse_args(argv)
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
    SWEEPS[args.kernel](pool, [int(x) for x in args.batches.split(",")],
                        dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
