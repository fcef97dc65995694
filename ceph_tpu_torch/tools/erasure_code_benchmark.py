"""ceph_erasure_code_benchmark, GPU edition.

Port of ``ceph_tpu/tools/erasure_code_benchmark.py``. CLI and output
contract of the reference harness
(src/test/erasure-code/ceph_erasure_code_benchmark.cc:39-64 options,
:187/:325 output): prints ``<elapsed seconds>\t<iterations * size/1024>``
(KiB processed) on stdout; the caller derives MB/s.

Workloads (reference :150-189 encode, :254-327 decode):
  encode   per iteration, encode the whole buffer
  decode   pre-encode once; per iteration erase chunks (randomly with
           --erasures N, from the fixed --erased list, or exhaustively
           over all combinations with content verification) and decode

Device extensions: ``--device`` names the torch device the codec runs on
(default ``cuda``; the run fails when CUDA is absent unless ``--device cpu``
is given). ``--batch B`` encodes B objects per kernel launch through the
codec's batched API, with the tensors kept on the device — the shape the
per-stripe CPU loop (src/osd/ECUtil.cc:116) cannot express; a batched
decode goes through ``decode_batch`` on the device, with the first k
survivors for an MDS codec and every survivor plus ``want_rows`` for a
locality codec (SHEC, LRC). Default --batch 1 keeps the reference
protocol exactly. A locality codec may have more parity chunks than m
(LRC adds one local parity per group); the chunk count is the codec's.

Run, for the Reed-Solomon main path and the BASELINE's other codecs:

    python -m ceph_tpu_torch.tools.erasure_code_benchmark -p torch_cuda \
        -P k=8 -P m=3 -s 1048576 --batch 16 -i 20
    ... -p torch_cuda -P technique=cauchy_good -P k=10 -P m=4 \
        -P packetsize=2048 -s 1048576 --batch 16 -i 20
    ... -p lrc_cuda -P k=4 -P m=2 -P l=3 -w decode --erased 0 --erased 5 \
        -s 1048576 --batch 16 -i 20
    ... -p shec_cuda -P k=8 -P m=4 -P c=3 -w decode -e 2 \
        -s 1048576 --batch 16 -i 20
"""

from __future__ import annotations

import argparse
import itertools
import random
import sys
import time

import numpy as np
import torch

from .. import registry
from ..device import resolve_device
from ..errors import ErasureCodeError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ceph_erasure_code_benchmark",
        description="benchmark erasure code plugins")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="explain what happens")
    p.add_argument("-s", "--size", type=int, default=1024 * 1024,
                   help="size of the buffer to be encoded")
    p.add_argument("-i", "--iterations", type=int, default=1,
                   help="number of encode/decode runs")
    p.add_argument("-p", "--plugin", default="torch_cuda",
                   help="erasure code plugin name")
    p.add_argument("-w", "--workload", default="encode",
                   choices=("encode", "decode"),
                   help="run either encode or decode")
    p.add_argument("-e", "--erasures", type=int, default=1,
                   help="number of erasures when decoding")
    p.add_argument("--erased", type=int, action="append", default=[],
                   help="erased chunk (repeat if more than one)")
    p.add_argument("-E", "--erasures-generation", default="random",
                   choices=("random", "exhaustive"),
                   help="random: erase --erasures chunks at random per "
                        "iteration; exhaustive: try all combinations and "
                        "verify recovered content")
    p.add_argument("-P", "--parameter", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="add a parameter to the erasure code profile")
    p.add_argument("--batch", type=int, default=1,
                   help="objects per kernel launch (device batching "
                        "extension)")
    p.add_argument("--device", default="cuda",
                   help="torch device the codec runs on (cuda or cpu)")
    return p


def parse_profile(parameters: list[str]) -> dict:
    profile = {}
    for param in parameters:
        parts = param.split("=")
        if len(parts) != 2:
            print("--parameter %s ignored because it does not contain "
                  "exactly one =" % param, file=sys.stderr)
            continue
        profile[parts[0]] = parts[1]
    return profile


class ErasureCodeBench:
    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.profile = parse_profile(args.parameter)
        self.in_size = args.size
        self.max_iterations = args.iterations
        self.plugin = args.plugin
        self.workload = args.workload
        self.erasures = args.erasures
        self.erased = list(args.erased)
        self.exhaustive = args.erasures_generation == "exhaustive"
        self.verbose = args.verbose
        self.batch = max(1, args.batch)
        self.device = resolve_device(args.device)

        self.k = int(self.profile.get("k", "0") or 0)
        self.m = int(self.profile.get("m", "0") or 0)
        if self.k <= 0:
            raise ErasureCodeError(
                22, "parameter k is %d. But k needs to be > 0." % self.k)
        if self.m < 0:
            raise ErasureCodeError(
                22, "parameter m is %d. But m needs to be >= 0." % self.m)

    # ------------------------------------------------------------------

    def _factory(self):
        codec = registry.factory(self.plugin, self.profile,
                                 device=self.device)
        k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
        locality = codec.DECODE_BATCH_ANY and n - k > self.m
        if k != self.k or (n - k != self.m and not locality):
            raise ErasureCodeError(
                22,
                "parameter k is %d/m is %d. But data chunk count is %d/"
                "parity chunk count is %d" % (self.k, self.m, k, n - k))
        return codec

    def _input(self) -> bytes:
        return b"X" * self.in_size

    def _report(self, elapsed: float, objects_per_iter: int = 1) -> None:
        # reference output contract (benchmark .cc:187): utime_t prints
        # seconds with 6-digit microseconds; KiB counts logical objects
        print("%.6f\t%d" % (elapsed,
                            self.max_iterations * objects_per_iter *
                            (self.in_size // 1024)))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- encode --------------------------------------------------------

    def _device_batch(self, codec) -> torch.Tensor:
        return torch.from_numpy(np.stack(
            [codec.encode_prepare(self._input())
             for _ in range(self.batch)])).to(self.device)

    def encode(self) -> int:
        codec = self._factory()
        want = set(range(codec.get_chunk_count()))
        if self.batch == 1:
            raw = self._input()
            t0 = time.perf_counter()
            for _ in range(self.max_iterations):
                codec.encode(want, raw)
            elapsed = time.perf_counter() - t0
        else:
            data = self._device_batch(codec)
            codec.encode_batch(data)  # warmup/build outside the clock
            self._sync()
            t0 = time.perf_counter()
            for _ in range(self.max_iterations):
                codec.encode_batch(data)
            self._sync()
            elapsed = time.perf_counter() - t0
        self._report(elapsed, self.batch)
        return 0

    # -- decode --------------------------------------------------------

    def _display_chunks(self, chunks: dict, chunk_count: int) -> None:
        line = "chunks "
        for c in range(chunk_count):
            line += ("(%d)" % c) if c not in chunks else (" %d " % c)
            line += " "
        print(line + "(X) is an erased chunk")

    def _decode_and_verify(self, codec, all_chunks: dict,
                           chunks: dict) -> int:
        if self.verbose:
            self._display_chunks(chunks, codec.get_chunk_count())
        want = {c for c in range(codec.get_chunk_count())
                if c not in chunks}
        decoded = codec.decode(want, chunks)
        for c in want:
            if c not in all_chunks:
                continue  # erased up-front via --erased: nothing to compare
            if all_chunks[c].shape != decoded[c].shape:
                print("chunk %d length=%d decoded with length=%d"
                      % (c, all_chunks[c].size, decoded[c].size),
                      file=sys.stderr)
                return -1
            if not np.array_equal(all_chunks[c], decoded[c]):
                print("chunk %d content and recovered content are "
                      "different" % c, file=sys.stderr)
                return -1
        return 0

    def _erasure_patterns(self, n: int):
        """The erased chunks of each iteration: the --erased list, every
        combination (exhaustive) or --erasures chunks at random."""
        if self.erased:
            return [tuple(sorted(set(self.erased)))] * self.max_iterations
        if self.exhaustive:
            return list(itertools.combinations(range(n), self.erasures))
        rng = random.Random()
        return [tuple(sorted(rng.sample(range(n), self.erasures)))
                for _ in range(self.max_iterations)]

    def _decode_batched(self, codec) -> int:
        """--batch B: each pattern's survivors of B device-resident
        objects through one decode_batch, the full batch verified."""
        k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
        data = self._device_batch(codec)
        full = torch.cat([data, torch.as_tensor(
            codec.encode_batch(data), device=self.device)], 1)
        calls = []
        for erased in self._erasure_patterns(n):
            survivors = tuple(i for i in range(n) if i not in erased)
            if codec.DECODE_BATCH_ANY:
                calls.append((survivors, tuple(range(n))))
            else:
                calls.append((survivors[:k], None))
        chunks = {a: full[:, list(a)].contiguous() for a, _ in calls}

        def decode(avail, want_rows):
            if want_rows is None:
                return codec.decode_batch(avail, chunks[avail])
            return codec.decode_batch(avail, chunks[avail],
                                      want_rows=want_rows)
        for avail, want_rows in dict.fromkeys(calls):
            if not torch.equal(decode(avail, want_rows), full):
                print("decode of survivors %s differs from the encoded "
                      "chunks" % (avail,), file=sys.stderr)
                return -1
        self._sync()
        t0 = time.perf_counter()
        for avail, want_rows in calls:
            decode(avail, want_rows)
        self._sync()
        elapsed = time.perf_counter() - t0
        print("%.6f\t%d" % (elapsed,
                             len(calls) * self.batch * (self.in_size // 1024)))
        return 0

    def decode(self) -> int:
        codec = self._factory()
        if self.batch > 1:
            return self._decode_batched(codec)
        want = set(range(codec.get_chunk_count()))
        encoded = codec.encode(want, self._input())

        if self.erased:
            for c in self.erased:
                encoded.pop(c, None)
            self._display_chunks(encoded, codec.get_chunk_count())

        rng = random.Random()
        t0 = time.perf_counter()
        for _ in range(self.max_iterations):
            if self.exhaustive:
                code = self._decode_exhaustive(codec, encoded)
                if code:
                    return code
            elif self.erased:
                codec.decode(want, encoded)
            else:
                chunks = dict(encoded)
                for _ in range(self.erasures):
                    while True:
                        erasure = rng.randrange(codec.get_chunk_count())
                        if erasure in chunks:
                            break
                    del chunks[erasure]
                codec.decode(want, chunks)
        elapsed = time.perf_counter() - t0
        self._report(elapsed)
        return 0

    def _decode_exhaustive(self, codec, encoded: dict) -> int:
        # all C(n, erasures) erasure patterns, with content verification
        # (reference decode_erasures recursion, benchmark .cc:205-252)
        n = codec.get_chunk_count()
        for combo in itertools.combinations(range(n), self.erasures):
            chunks = {c: b for c, b in encoded.items() if c not in combo}
            code = self._decode_and_verify(codec, encoded, chunks)
            if code:
                return code
        return 0

    def run(self) -> int:
        if self.workload == "encode":
            return self.encode()
        return self.decode()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return ErasureCodeBench(args).run()
    except ErasureCodeError as e:
        print(e, file=sys.stderr)
        return 1
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
