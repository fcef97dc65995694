"""crushtool: build and test CRUSH maps (the port's part).

Port of part of ``ceph_tpu/tools/crushtool.py``, the offline tool of
Ceph's src/tools/crushtool.cc: ``--build`` (``build_map``), the JSON
container of a compiled map (``map_to_json`` / ``map_from_json``) and
the CrushTester-style ``--test`` (``run_test``, ``format_test_report``)
over an input range, through the scalar interpreter or, with
``--batched``, through :func:`ceph_tpu_torch.crush.batched.batched_do_rule`
on the card (``--device cpu`` for the plain version on the host). The
text grammar (``-c`` / ``-d``) is not ported yet.

Usage:
  python -m ceph_tpu_torch.tools.crushtool --build --num-osds 1024 \\
      -o map.json host straw2 16 rack straw2 8 root straw2 0
  python -m ceph_tpu_torch.tools.crushtool -i map.json --test --rule 0 \\
      --num-rep 3 --min-x 0 --max-x 1048575 --batched --show-utilization
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..crush.map import CRUSH_ITEM_NONE, CrushMap, Rule, Tunables
from ..crush.mapper_ref import crush_do_rule

_TUNABLE_FIELDS = (
    "choose_local_tries", "choose_local_fallback_tries",
    "choose_total_tries", "chooseleaf_descend_once",
    "chooseleaf_vary_r", "chooseleaf_stable")


class CompileError(ValueError):
    pass


# ---------------------------------------------------------------------------
# JSON container (the compiled-map format)


def map_to_json(m: CrushMap) -> dict:
    return {
        "tunables": {f: getattr(m.tunables, f) for f in _TUNABLE_FIELDS},
        "types": m.type_names,
        "devices": {str(d): c for d, c in m.device_classes.items()},
        "buckets": [
            {"id": b.id, "alg": b.alg, "type": b.type,
             "items": [int(x) for x in b.items],
             "weights": [int(w) for w in b.weights]}
            for b in m.buckets.values()],
        "bucket_names": m.bucket_names,
        "rules": [
            {"name": r.name, "type": r.type, "min_size": r.min_size,
             "max_size": r.max_size,
             "steps": [list(s) for s in r.steps]}
            for r in m.rules],
        "choose_args": {
            str(idx): {str(bid): arg for bid, arg in args.items()}
            for idx, args in m.choose_args.items()},
    }


def map_from_json(doc: dict) -> CrushMap:
    m = CrushMap()
    m.tunables = Tunables(**doc.get("tunables", {}))
    m.type_names = dict(doc.get("types", {}))
    m.device_classes = {int(d): c
                        for d, c in doc.get("devices", {}).items()}
    for b in doc["buckets"]:
        m.add_bucket(b["alg"], b["type"], b["items"], b["weights"],
                     id=b["id"])
    m.bucket_names = dict(doc.get("bucket_names", {}))
    for r in doc.get("rules", []):
        m.add_rule(Rule(steps=[tuple(s) for s in r["steps"]],
                        name=r["name"], type=r["type"],
                        min_size=r["min_size"], max_size=r["max_size"]))
    for idx, args in doc.get("choose_args", {}).items():
        m.choose_args[int(idx)] = {
            int(bid): {"ids": arg.get("ids"),
                       "weight_set": arg.get("weight_set")}
            for bid, arg in args.items()}
    return m


# ---------------------------------------------------------------------------
# build: quick hierarchical map generation (crushtool --build)


def build_map(num_osds: int, layers: list[tuple[str, str, int]]) -> CrushMap:
    """crushtool --build: bottom-up layers of (type_name, alg, size).

    size = children per bucket at that layer; 0 means one bucket holding
    everything remaining (the root layer).
    """
    m = CrushMap()
    m.type_names = {"osd": 0}
    cur: list[int] = list(range(num_osds))          # item ids
    cur_w = [0x10000] * num_osds
    for depth, (tname, alg, size) in enumerate(layers, start=1):
        m.type_names[tname] = depth
        nxt, nxt_w = [], []
        group = len(cur) if size == 0 else size
        for off in range(0, len(cur), group):
            items = cur[off:off + group]
            ws = cur_w[off:off + group]
            name = "%s%d" % (tname, len(nxt))
            bid = m.add_bucket(alg, depth, items, ws, name=name)
            nxt.append(bid)
            nxt_w.append(sum(ws))
        cur, cur_w = nxt, nxt_w
    if len(cur) != 1:
        raise CompileError(
            "--build layers must converge to one root (got %d)" % len(cur))
    root_id = cur[0]
    root_name = next(n for n, b in m.bucket_names.items() if b == root_id)
    m.bucket_names["default"] = root_id
    m.bucket_names.pop(root_name, None)
    return m


# ---------------------------------------------------------------------------
# test: CrushTester


def run_test(m: CrushMap, ruleno: int, num_rep: int, min_x: int, max_x: int,
             batched: bool = False, weights: list[int] | None = None,
             device=None):
    """Simulate rule `ruleno` over x in [min_x, max_x].

    Returns (per_device_counts, results list). With batched=True the whole
    x-range is one call of ``batched_do_rule`` on `device` (None: the
    card)."""
    xs = np.arange(min_x, max_x + 1, dtype=np.int64)
    if batched:
        from ..crush.batched import batched_do_rule
        res = np.asarray(batched_do_rule(m, ruleno, xs, num_rep, weights,
                                         device=device))
        results = res.tolist()
        flat = res[(res >= 0) & (res != CRUSH_ITEM_NONE)
                   & (res < max(m.max_devices, 1))]
    else:
        results = [crush_do_rule(m, ruleno, int(x), num_rep, weights)
                   for x in xs]
        flat = np.asarray([d for row in results for d in row
                           if 0 <= d != CRUSH_ITEM_NONE
                           and d < max(m.max_devices, 1)], dtype=np.int64)
    counts = np.bincount(flat, minlength=max(m.max_devices, 1))
    return counts.astype(np.int64), results


def format_test_report(m: CrushMap, counts: np.ndarray, results: list,
                       ruleno: int, num_rep: int,
                       show_utilization: bool = False,
                       show_mappings: bool = False,
                       min_x: int = 0) -> str:
    """CrushTester-style output: per-device utilization + stddev summary."""
    out = []
    rule = m.rules[ruleno]
    total = len(results)
    sizes = np.asarray([sum(1 for d in row if d != CRUSH_ITEM_NONE)
                        for row in results])
    if show_mappings:
        for x, row in zip(range(min_x, min_x + total), results):
            out.append("CRUSH rule %d x %d %r" % (ruleno, x, row))
    if show_utilization:
        for dev in range(counts.size):
            if counts[dev]:
                out.append(
                    "  device %d:\t stored : %d\t expected : %.6f"
                    % (dev, counts[dev], counts.sum() / max(
                        1, np.count_nonzero(counts))))
    expected = counts.sum() / max(1, np.count_nonzero(counts))
    nonzero = counts[counts > 0]
    stddev = float(np.sqrt(((nonzero - expected) ** 2).mean())) \
        if nonzero.size else 0.0
    out.append("rule %d (%s) num_rep %d result size == %d:\t%d/%d"
               % (ruleno, rule.name or "?", num_rep,
                  int(sizes.max(initial=0)),
                  int((sizes == num_rep).sum()), total))
    out.append("  placement stddev %.6f (expected %.6f per device)"
               % (stddev, expected))
    return "\n".join(out)


# ---------------------------------------------------------------------------
# CLI


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="crushtool", description="build and test CRUSH maps")
    p.add_argument("-i", "--input", metavar="MAP",
                   help="input compiled map for --test")
    p.add_argument("-o", "--output", metavar="DST", help="output file")
    p.add_argument("--build", action="store_true",
                   help="build a hierarchy: --num-osds N name alg size ...")
    p.add_argument("--num-osds", type=int, default=0)
    p.add_argument("layers", nargs="*",
                   help="--build layer triples: name alg size")
    p.add_argument("--test", action="store_true",
                   help="simulate mappings (CrushTester)")
    p.add_argument("--rule", type=int, default=0)
    p.add_argument("--num-rep", type=int, default=3)
    p.add_argument("--min-x", type=int, default=0)
    p.add_argument("--max-x", type=int, default=1023)
    p.add_argument("--batched", action="store_true",
                   help="map the x-range in one batched_do_rule call")
    p.add_argument("--device", default=None,
                   help="device of --batched (default: the CUDA card; "
                        "cpu for the plain version)")
    p.add_argument("--show-utilization", action="store_true")
    p.add_argument("--show-mappings", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    write = (lambda s: open(args.output, "w").write(s)) if args.output \
        else sys.stdout.write
    try:
        if args.build:
            if args.num_osds <= 0 or len(args.layers) % 3:
                raise CompileError(
                    "--build needs --num-osds and name/alg/size triples")
            layers = [(args.layers[i], args.layers[i + 1],
                       int(args.layers[i + 2]))
                      for i in range(0, len(args.layers), 3)]
            m = build_map(args.num_osds, layers)
            write(json.dumps(map_to_json(m), indent=1) + "\n")
            return 0
        if args.test:
            if not args.input:
                raise CompileError("--test needs -i <compiled map>")
            with open(args.input) as f:
                m = map_from_json(json.load(f))
            counts, results = run_test(
                m, args.rule, args.num_rep, args.min_x, args.max_x,
                batched=args.batched, device=args.device)
            write(format_test_report(
                m, counts, results, args.rule, args.num_rep,
                show_utilization=args.show_utilization,
                show_mappings=args.show_mappings, min_x=args.min_x) + "\n")
            return 0
    except (ValueError, OSError, KeyError, RuntimeError) as e:
        # CompileError and json.JSONDecodeError are ValueErrors; plain
        # ValueError also covers malformed numeric fields (int/float);
        # RuntimeError is a --batched run without CUDA or a failed launch.
        sys.stderr.write("crushtool: %s\n" % e)
        return 1
    build_parser().print_usage(sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
