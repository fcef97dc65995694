"""crushtool: compile, decompile, build and test CRUSH maps.

Port of ``ceph_tpu/tools/crushtool.py``, the offline tool of Ceph's
src/tools/crushtool.cc and CrushCompiler (src/crush/CrushCompiler.cc):
the text grammar (``-c`` / ``compile_text``: tunables, devices, types,
buckets, rules and choose_args weight sets; ``-d`` / ``decompile``), the
JSON container of a compiled map (``map_to_json`` / ``map_from_json``),
``--build`` (``build_map``) and the CrushTester-style ``--test``
(``run_test``, ``format_test_report``) over an input range, through the
scalar interpreter or, with ``--batched``, through
:func:`ceph_tpu_torch.crush.batched.batched_do_rule` on the card
(``--device cpu`` for the plain version on the host).

Usage:
  python -m ceph_tpu_torch.tools.crushtool -c map.txt -o map.json
  python -m ceph_tpu_torch.tools.crushtool -d map.json [-o map.txt]
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

from ..crush.map import (
    ALGS, CRUSH_ITEM_NONE, CrushMap, Rule, Tunables,
    POOL_TYPE_ERASURE, POOL_TYPE_REPLICATED,
    RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP, RULE_CHOOSELEAF_FIRSTN,
    RULE_CHOOSELEAF_INDEP, RULE_EMIT, RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    RULE_SET_CHOOSE_LOCAL_TRIES, RULE_SET_CHOOSE_TRIES,
    RULE_SET_CHOOSELEAF_STABLE, RULE_SET_CHOOSELEAF_TRIES,
    RULE_SET_CHOOSELEAF_VARY_R, weight_fixed)
from ..crush.mapper_ref import crush_do_rule

_TUNABLE_FIELDS = (
    "choose_local_tries", "choose_local_fallback_tries",
    "choose_total_tries", "chooseleaf_descend_once",
    "chooseleaf_vary_r", "chooseleaf_stable")

_SET_STEPS = {
    "set_choose_tries": RULE_SET_CHOOSE_TRIES,
    "set_chooseleaf_tries": RULE_SET_CHOOSELEAF_TRIES,
    "set_choose_local_tries": RULE_SET_CHOOSE_LOCAL_TRIES,
    "set_choose_local_fallback_tries": RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    "set_chooseleaf_vary_r": RULE_SET_CHOOSELEAF_VARY_R,
    "set_chooseleaf_stable": RULE_SET_CHOOSELEAF_STABLE,
}
_SET_STEPS_INV = {v: k for k, v in _SET_STEPS.items()}

_RULE_TYPES = {"replicated": POOL_TYPE_REPLICATED,
               "erasure": POOL_TYPE_ERASURE}
_RULE_TYPES_INV = {v: k for k, v in _RULE_TYPES.items()}


class CompileError(ValueError):
    pass


# ---------------------------------------------------------------------------
# compile: text -> CrushMap


def compile_text(text: str) -> CrushMap:
    """Parse the crushtool text grammar (CrushCompiler::parse)."""
    m = CrushMap()
    m.type_names = {}
    lines = _logical_lines(text)
    i = 0
    while i < len(lines):
        tok = lines[i].split()
        head = tok[0]
        if head == "tunable":
            if len(tok) != 3 or tok[1] not in _TUNABLE_FIELDS:
                raise CompileError("bad tunable line: %r" % lines[i])
            setattr(m.tunables, tok[1], int(tok[2]))
            i += 1
        elif head == "device":
            # device <id> osd.<id> [class <name>]
            if len(tok) < 3:
                raise CompileError("bad device line: %r" % lines[i])
            dev = int(tok[1])
            if tok[2] != "osd.%d" % dev:
                raise CompileError(
                    "device %d must be named osd.%d" % (dev, dev))
            if len(tok) >= 5 and tok[3] == "class":
                m.device_classes[dev] = tok[4]
            i += 1
        elif head == "type":
            if len(tok) != 3:
                raise CompileError("bad type line: %r" % lines[i])
            m.type_names[tok[2]] = int(tok[1])
            i += 1
        elif head == "rule":
            i = _parse_rule(m, lines, i)
        elif head == "choose_args":
            i = _parse_choose_args(m, lines, i)
        elif len(tok) == 3 and tok[2] == "{" and tok[0] in m.type_names:
            i = _parse_bucket(m, lines, i)
        else:
            raise CompileError("unrecognized line: %r" % lines[i])
    return m


def _logical_lines(text: str) -> list[str]:
    out = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if line:
            out.append(line)
    return out


def _parse_bucket(m: CrushMap, lines: list[str], i: int) -> int:
    btype_name, name, _ = lines[i].split()
    btype = m.type_names[btype_name]
    i += 1
    bid = None
    alg = "straw2"
    items: list[int] = []
    weights: list[int] = []
    while i < len(lines) and lines[i] != "}":
        tok = lines[i].split()
        if tok[0] == "id":
            bid = int(tok[1])
        elif tok[0] == "alg":
            if tok[1] not in ALGS:
                raise CompileError("unknown bucket alg %r" % tok[1])
            alg = tok[1]
        elif tok[0] == "hash":
            if int(tok[1]) != 0:
                raise CompileError("only hash 0 (rjenkins1) is supported")
        elif tok[0] == "item":
            # item <name> [weight <float>]
            iname = tok[1]
            w = 0x10000
            if len(tok) == 4 and tok[2] == "weight":
                w = weight_fixed(float(tok[3]))
            elif len(tok) != 2:
                raise CompileError("bad item line: %r" % lines[i])
            if iname.startswith("osd."):
                items.append(int(iname[4:]))
            elif iname in m.bucket_names:
                items.append(m.bucket_names[iname])
            else:
                raise CompileError("item %r not defined before use" % iname)
            weights.append(w)
        else:
            raise CompileError("bad bucket line: %r" % lines[i])
        i += 1
    if i == len(lines):
        raise CompileError("unterminated bucket %r" % name)
    m.add_bucket(alg, btype, items, weights, id=bid, name=name)
    return i + 1


def _parse_rule(m: CrushMap, lines: list[str], i: int) -> int:
    tok = lines[i].split()
    name = tok[1] if len(tok) >= 3 else ""
    i += 1
    rtype = POOL_TYPE_REPLICATED
    min_size, max_size = 1, 10
    steps: list[tuple] = []
    while i < len(lines) and lines[i] != "}":
        tok = lines[i].split()
        if tok[0] == "ruleset":
            pass  # rule index is positional, like the post-luminous reference
        elif tok[0] == "type":
            if tok[1] not in _RULE_TYPES:
                raise CompileError("bad rule type %r" % tok[1])
            rtype = _RULE_TYPES[tok[1]]
        elif tok[0] == "min_size":
            min_size = int(tok[1])
        elif tok[0] == "max_size":
            max_size = int(tok[1])
        elif tok[0] == "step":
            steps.append(_parse_step(m, tok[1:]))
        else:
            raise CompileError("bad rule line: %r" % lines[i])
        i += 1
    if i == len(lines):
        raise CompileError("unterminated rule %r" % name)
    m.add_rule(Rule(steps=steps, name=name, type=rtype,
                    min_size=min_size, max_size=max_size))
    return i + 1


def _collect_bracketed(lines: list[str], i: int,
                       toks: list[str]) -> tuple[list[str], int]:
    """Accumulate logical lines until [ ] brackets balance (the
    reference decompiles weight_set with one row per line)."""
    while toks.count("[") != toks.count("]"):
        i += 1
        if i >= len(lines):
            raise CompileError("unbalanced brackets in choose_args")
        toks += lines[i].split()
    return toks, i


def _parse_choose_args(m: CrushMap, lines: list[str], i: int) -> int:
    """choose_args <id> { { bucket_id <id> [weight_set [...]]
    [ids [...]] } ... } — CrushCompiler::parse_choose_args grammar."""
    tok = lines[i].split()
    if len(tok) != 3 or tok[2] != "{":
        raise CompileError("bad choose_args line: %r" % lines[i])
    idx = int(tok[1])
    args: dict = {}
    i += 1
    while i < len(lines) and lines[i] != "}":
        if lines[i] != "{":
            raise CompileError("expected '{' in choose_args, got %r"
                               % lines[i])
        i += 1
        bid = None
        ids = None
        ws = None
        while i < len(lines) and lines[i] != "}":
            t = lines[i].split()
            if t[0] == "bucket_id":
                bid = int(t[1])
            elif t[0] == "weight_set":
                toks, i = _collect_bracketed(lines, i, t[1:])
                ws = []
                row = None
                depth = 0
                for tk in toks:
                    if tk == "[":
                        depth += 1
                        if depth == 2:
                            row = []
                    elif tk == "]":
                        if depth == 2:
                            ws.append(row)
                            row = None
                        depth -= 1
                    elif depth == 2:
                        # %.6f text: |err| < 1e-6 * 0x10000 < 0.5, so
                        # round() recovers the 16.16 value exactly
                        row.append(int(round(float(tk) * 0x10000)))
                    else:
                        raise CompileError("bad weight_set token %r"
                                           % tk)
            elif t[0] == "ids":
                toks, i = _collect_bracketed(lines, i, t[1:])
                ids = [int(tk) for tk in toks if tk not in ("[", "]")]
            else:
                raise CompileError("bad choose_args entry line: %r"
                                   % lines[i])
            i += 1
        if i >= len(lines):
            raise CompileError("unterminated choose_args block")
        i += 1  # inner '}'
        if bid is None:
            raise CompileError("choose_args entry missing bucket_id")
        args[bid] = {"ids": ids, "weight_set": ws}
    if i >= len(lines):
        raise CompileError("unterminated choose_args")
    m.choose_args[idx] = args
    return i + 1


def _parse_step(m: CrushMap, tok: list[str]) -> tuple:
    op = tok[0]
    if op == "take":
        if tok[1] not in m.bucket_names:
            raise CompileError("take: unknown bucket %r" % tok[1])
        return ("take", m.bucket_names[tok[1]])
    if op == "emit":
        return (RULE_EMIT,)
    if op in _SET_STEPS:
        return (_SET_STEPS[op], int(tok[1]))
    if op in ("choose", "chooseleaf"):
        # step choose(leaf) firstn|indep <n> type <type>
        if len(tok) != 5 or tok[1] not in ("firstn", "indep") \
                or tok[3] != "type":
            raise CompileError("bad choose step: %r" % " ".join(tok))
        if tok[4] not in m.type_names:
            raise CompileError("choose: unknown type %r" % tok[4])
        ops = {("choose", "firstn"): RULE_CHOOSE_FIRSTN,
               ("choose", "indep"): RULE_CHOOSE_INDEP,
               ("chooseleaf", "firstn"): RULE_CHOOSELEAF_FIRSTN,
               ("chooseleaf", "indep"): RULE_CHOOSELEAF_INDEP}
        return (ops[(op, tok[1])], int(tok[2]), m.type_names[tok[4]])
    raise CompileError("unknown step %r" % op)


# ---------------------------------------------------------------------------
# decompile: CrushMap -> text


def decompile(m: CrushMap) -> str:
    id_names = {bid: n for n, bid in m.bucket_names.items()}
    type_of = {v: k for k, v in m.type_names.items()}

    def item_name(i: int) -> str:
        return "osd.%d" % i if i >= 0 else id_names.get(i, "bucket%d" % -i)

    out = ["# begin crush map"]
    for f in _TUNABLE_FIELDS:
        out.append("tunable %s %d" % (f, getattr(m.tunables, f)))
    out += ["", "# devices"]
    # spares (declared devices not yet in any bucket) still carry classes
    ndev = max([m.max_devices] + [d + 1 for d in m.device_classes])
    for dev in range(ndev):
        cls = m.device_classes.get(dev)
        out.append("device %d osd.%d%s"
                   % (dev, dev, " class %s" % cls if cls else ""))
    out += ["", "# types"]
    for tname, tid in sorted(m.type_names.items(), key=lambda kv: kv[1]):
        out.append("type %d %s" % (tid, tname))
    out += ["", "# buckets"]
    # leaves before parents (CrushCompiler emits children first)
    done: set[int] = set()

    def emit_bucket(bid: int) -> None:
        if bid in done:
            return
        b = m.buckets[bid]
        for item in b.items:
            if item < 0:
                emit_bucket(int(item))
        done.add(bid)
        out.append("%s %s {" % (type_of.get(b.type, "type%d" % b.type),
                                item_name(bid)))
        out.append("\tid %d" % bid)
        out.append("\t# weight %.3f" % (b.weight / 0x10000))
        out.append("\talg %s" % b.alg)
        out.append("\thash 0\t# rjenkins1")
        for item, w in zip(b.items, b.weights):
            out.append("\titem %s weight %.3f"
                       % (item_name(int(item)), int(w) / 0x10000))
        out.append("}")

    for bid in sorted(m.buckets, reverse=True):
        emit_bucket(bid)
    out += ["", "# rules"]
    choose_names = {RULE_CHOOSE_FIRSTN: ("choose", "firstn"),
                    RULE_CHOOSE_INDEP: ("choose", "indep"),
                    RULE_CHOOSELEAF_FIRSTN: ("chooseleaf", "firstn"),
                    RULE_CHOOSELEAF_INDEP: ("chooseleaf", "indep")}
    for ruleno, r in enumerate(m.rules):
        out.append("rule %s {" % (r.name or "rule-%d" % ruleno))
        out.append("\truleset %d" % ruleno)
        out.append("\ttype %s" % _RULE_TYPES_INV.get(r.type, "replicated"))
        out.append("\tmin_size %d" % r.min_size)
        out.append("\tmax_size %d" % r.max_size)
        for step in r.steps:
            op = step[0]
            if op == "take":
                out.append("\tstep take %s" % item_name(step[1]))
            elif op == RULE_EMIT:
                out.append("\tstep emit")
            elif op in _SET_STEPS_INV:
                out.append("\tstep %s %d" % (_SET_STEPS_INV[op], step[1]))
            elif op in choose_names:
                kind, mode = choose_names[op]
                out.append("\tstep %s %s %d type %s"
                           % (kind, mode, step[1],
                              type_of.get(step[2], "osd")))
            else:
                raise CompileError("cannot decompile step %r" % (step,))
        out.append("}")
    if m.choose_args:
        out += ["", "# choose_args"]
        for idx in sorted(m.choose_args):
            out.append("choose_args %d {" % idx)
            for bid in sorted(m.choose_args[idx]):
                arg = m.choose_args[idx][bid] or {}
                out.append("  {")
                out.append("    bucket_id %d" % bid)
                ws = arg.get("weight_set")
                if ws:
                    rows = " ".join(
                        "[ %s ]" % " ".join("%.6f" % (w / 0x10000)
                                            for w in row)
                        for row in ws)
                    out.append("    weight_set [ %s ]" % rows)
                ids = arg.get("ids")
                if ids:
                    out.append("    ids [ %s ]"
                               % " ".join(str(i) for i in ids))
                out.append("  }")
            out.append("}")
    out.append("")
    out.append("# end crush map")
    return "\n".join(out) + "\n"


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
        prog="crushtool",
        description="compile, decompile, build and test CRUSH maps")
    p.add_argument("-c", "--compile", metavar="SRC",
                   help="compile text crushmap SRC")
    p.add_argument("-d", "--decompile", metavar="MAP",
                   help="decompile compiled (JSON) map")
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
        if args.compile:
            with open(args.compile) as f:
                m = compile_text(f.read())
            write(json.dumps(map_to_json(m), indent=1) + "\n")
            return 0
        if args.decompile:
            with open(args.decompile) as f:
                m = map_from_json(json.load(f))
            write(decompile(m))
            return 0
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
