"""ceph_erasure_code_non_regression: golden encode corpora.

Port of ``ceph_tpu/tools/non_regression.py``, the CLI of Ceph's
src/test/erasure-code/ceph_erasure_code_non_regression.cc: ``--create``
writes <base>/<descriptor>/{content,0..n-1} (random content and its
encoded chunks); ``--check`` re-encodes the stored content and fails
unless every chunk matches byte for byte, then decodes the erasures {0}
and {0, n-1} and checks the recovered chunks. The descriptor directory
is ``plugin=<p> stripe-width=<s> <param>...`` as in the reference, so a
corpus is comparable across versions and packages: the same descriptor
written by one package's ``--create`` passes the other's ``--check``.

``--plugin`` defaults to ``torch_cuda``, the card's codec, where the
reference defaults to ``jerasure`` (the port's host codec, still reached
with ``--plugin jerasure``). ``--device`` names the torch device a card
plugin's codec runs on (default ``cuda``; ``cpu`` only when asked); it is
not part of the descriptor. Run:

    python -m ceph_tpu_torch.tools.non_regression --plugin torch_cuda \
        --base corpus -P k=8 -P m=3 --create
    python -m ceph_tpu_torch.tools.non_regression --plugin torch_cuda \
        --base corpus -P k=8 -P m=3 --check
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np

from .. import registry
from ..errors import ErasureCodeError
from .erasure_code_benchmark import parse_profile


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ceph_erasure_code_non_regression")
    p.add_argument("-s", "--stripe-width", type=int, default=4 * 1024,
                   help="stripe_width, i.e. the size of the buffer "
                        "to be encoded")
    p.add_argument("-p", "--plugin", default="torch_cuda",
                   help="erasure code plugin name")
    p.add_argument("--base", default=".", help="prefix all paths with base")
    p.add_argument("-P", "--parameter", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="add a parameter to the erasure code profile")
    p.add_argument("--create", action="store_true",
                   help="create the erasure coded content in the directory")
    p.add_argument("--check", action="store_true",
                   help="check the content in the directory matches the "
                        "chunks and vice versa")
    p.add_argument("--device", default="cuda",
                   help="torch device a card plugin's codec runs on "
                        "(cuda or cpu)")
    return p


class NonRegression:
    def __init__(self, args: argparse.Namespace):
        self.stripe_width = args.stripe_width
        self.plugin = args.plugin
        self.base = args.base
        self.create = args.create
        self.check = args.check
        self.device = args.device
        self.profile = parse_profile(args.parameter)
        directory = "plugin=%s stripe-width=%d" % (self.plugin,
                                                   self.stripe_width)
        for param in args.parameter:
            directory += " " + param
        self.directory = os.path.join(self.base, directory)

    def content_path(self) -> str:
        return os.path.join(self.directory, "content")

    def chunk_path(self, chunk: int) -> str:
        return os.path.join(self.directory, str(chunk))

    def _factory(self):
        return registry.factory(self.plugin, self.profile,
                                device=self.device)

    def run_create(self) -> int:
        codec = self._factory()
        os.makedirs(self.directory, exist_ok=False)
        # the reference's payload: a 37-byte random string repeated to width
        payload = bytes(random.choice(b"abcdefghijklmnopqrstuvwxyz")
                        for _ in range(37))
        reps = -(-self.stripe_width // len(payload))
        content = (payload * reps)[:self.stripe_width]
        with open(self.content_path(), "wb") as f:
            f.write(content)
        encoded = codec.encode(set(range(codec.get_chunk_count())), content)
        for chunk, buf in encoded.items():
            with open(self.chunk_path(chunk), "wb") as f:
                f.write(np.asarray(buf, dtype=np.uint8).tobytes())
        return 0

    def decode_erasures(self, codec, erasures: set, chunks: dict) -> int:
        available = {c: b for c, b in chunks.items() if c not in erasures}
        decoded = codec.decode(set(erasures), available)
        for erasure in erasures:
            if not np.array_equal(chunks[erasure], decoded[erasure]):
                print("chunk %d incorrectly recovered" % erasure,
                      file=sys.stderr)
                return 1
        return 0

    def run_check(self) -> int:
        codec = self._factory()
        with open(self.content_path(), "rb") as f:
            content = f.read()
        encoded = codec.encode(set(range(codec.get_chunk_count())), content)
        for chunk, buf in encoded.items():
            with open(self.chunk_path(chunk), "rb") as f:
                existing = f.read()
            if existing != np.asarray(buf, dtype=np.uint8).tobytes():
                print("chunk %d encodes differently" % chunk,
                      file=sys.stderr)
                return 1
        # one erasure, then the general two-erasure case
        code = self.decode_erasures(codec, {0}, encoded)
        if code:
            return code
        if codec.get_coding_chunk_count() > 1:
            code = self.decode_erasures(
                codec, {0, codec.get_chunk_count() - 1}, encoded)
            if code:
                return code
        return 0

    def run(self) -> int:
        if not self.check and not self.create:
            print("must specifify either --check, or --create",
                  file=sys.stderr)
            return 1
        if self.create:
            code = self.run_create()
            if code:
                return code
        if self.check:
            code = self.run_check()
            if code:
                return code
        return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return NonRegression(args).run()
    except (ErasureCodeError, RuntimeError) as e:
        print(e, file=sys.stderr)
        return 1
    except OSError as e:
        # the reference prints "mkdir(<dir>): <strerror>" and fails
        # (ceph_erasure_code_non_regression.cc:167-168)
        print("%s(%s): %s" % (e.__class__.__name__,
                              e.filename or "", e.strerror), file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
