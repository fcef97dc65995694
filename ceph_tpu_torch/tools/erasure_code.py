"""ceph_erasure_code: plugin probe and codec information tool.

Port of ``ceph_tpu/tools/erasure_code.py``, the CLI of Ceph's
src/test/erasure-code/ceph_erasure_code.cc: ``--plugin_exists X`` exits
0 iff plugin X loads (else its errno); otherwise it displays the codec
geometry of the profile given by repeated ``--parameter`` (which must
include ``plugin=``), ``--all`` implying every query. Output lines are
``<query>\t<value>``, as in the reference.

``--device`` names the torch device a card plugin's codec is built on
(default ``cuda``; ``cpu`` only when asked), as in
``erasure_code_benchmark``. Run:

    python -m ceph_tpu_torch.tools.erasure_code --plugin_exists torch_cuda
    python -m ceph_tpu_torch.tools.erasure_code --all -P plugin=torch_cuda \
        -P k=8 -P m=3
"""

from __future__ import annotations

import argparse
import sys

from .. import registry
from ..errors import ErasureCodeError
from .erasure_code_benchmark import parse_profile


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ceph_erasure_code")
    p.add_argument("--all", action="store_true",
                   help="implies --get_chunk_size 1024 "
                        "--get_data_chunk_count --get_coding_chunk_count "
                        "--get_chunk_count")
    p.add_argument("--get_chunk_size", type=int, default=None,
                   metavar="OBJECT_SIZE",
                   help="display get_chunk_size(<object size>)")
    p.add_argument("--get_data_chunk_count", action="store_true")
    p.add_argument("--get_coding_chunk_count", action="store_true")
    p.add_argument("--get_chunk_count", action="store_true")
    p.add_argument("-P", "--parameter", action="append", default=[],
                   metavar="KEY=VALUE")
    p.add_argument("--plugin_exists", default=None, metavar="PLUGIN",
                   help="succeeds if the plugin given in argument exists "
                        "and can be loaded")
    p.add_argument("--device", default="cuda",
                   help="torch device a card plugin's codec runs on "
                        "(cuda or cpu)")
    return p


def plugin_exists(name: str) -> int:
    try:
        registry.ErasureCodePluginRegistry.instance().load(name)
        return 0
    except ErasureCodeError as e:
        print(e, file=sys.stderr)
        return e.errno


def display_information(args: argparse.Namespace) -> int:
    profile = parse_profile(args.parameter)
    if "plugin" not in profile:
        print("--parameter plugin=<plugin> is mandatory", file=sys.stderr)
        return 1
    codec = registry.factory(profile["plugin"], profile, device=args.device)
    if args.all or args.get_chunk_size is not None:
        object_size = (args.get_chunk_size
                       if args.get_chunk_size is not None else 1024)
        print("get_chunk_size(%d)\t%d"
              % (object_size, codec.get_chunk_size(object_size)))
    if args.all or args.get_data_chunk_count:
        print("get_data_chunk_count\t%d" % codec.get_data_chunk_count())
    if args.all or args.get_coding_chunk_count:
        print("get_coding_chunk_count\t%d" % codec.get_coding_chunk_count())
    if args.all or args.get_chunk_count:
        print("get_chunk_count\t%d" % codec.get_chunk_count())
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.plugin_exists is not None:
            return plugin_exists(args.plugin_exists)
        return display_information(args)
    except (ErasureCodeError, RuntimeError) as e:
        print(e, file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
