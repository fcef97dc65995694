"""osdmaptool: create, inspect and balance OSD maps.

Port of ``ceph_tpu/tools/osdmaptool.py``, the offline tool of Ceph's
src/tools/osdmaptool.cc: ``--createsimple`` builds a map,
``--test-map-pgs`` reports the full PG -> OSD distribution (with
``--batched``, each pool one straw2 launch on the card through
``OSDMapMapping.update``; ``--device cpu`` for the plain version on the
host), ``--test-map-object`` maps one named object, and ``--upmap``
writes the balancer's pg_upmap_items commands (with ``--batched``, its
sweeps on the card). The compiled-map container is JSON, as crushtool's.

Usage:
  python -m ceph_tpu_torch.tools.osdmaptool --createsimple 16 map.json \\
      [--pg-num 256] [--pool-size 3]
  python -m ceph_tpu_torch.tools.osdmaptool map.json --test-map-pgs \\
      [--pool N] [--batched] [--device cpu]
  python -m ceph_tpu_torch.tools.osdmaptool map.json --test-map-object foo \\
      --pool N
  python -m ceph_tpu_torch.tools.osdmaptool map.json --upmap out.txt \\
      [--upmap-pool N] [--upmap-max 10] [--batched]
  python -m ceph_tpu_torch.tools.osdmaptool map.json --mark-down 3 \\
      -o map2.json
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..crush.map import CRUSH_ITEM_NONE, POOL_TYPE_REPLICATED
from ..osd.osd_map import Incremental, OSDMap, OSDMapMapping, PGID, PGPool
from . import crushtool


# ---------------------------------------------------------------------------
# JSON container


def osdmap_to_json(m: OSDMap) -> dict:
    return {
        "epoch": m.epoch,
        "max_osd": m.max_osd,
        "crush": crushtool.map_to_json(m.crush),
        "osd_exists": [bool(v) for v in m.osd_exists],
        "osd_up": [bool(v) for v in m.osd_up],
        "osd_weight": [int(v) for v in m.osd_weight],
        "pools": [
            {"pool_id": p.pool_id, "name": p.name, "type": p.type,
             "size": p.size, "min_size": p.min_size, "pg_num": p.pg_num,
             "pgp_num": p.pgp_num, "crush_rule": p.crush_rule,
             "erasure_code_profile": p.erasure_code_profile,
             "hashpspool": p.hashpspool, "stripe_width": p.stripe_width}
            for p in m.pools.values()],
        "pg_upmap": {str(pg): v for pg, v in m.pg_upmap.items()},
        "pg_upmap_items": {str(pg): [list(t) for t in v]
                           for pg, v in m.pg_upmap_items.items()},
    }


def _parse_pgid(s: str) -> PGID:
    pool, ps = s.split(".")
    return PGID(int(pool), int(ps, 16))


def osdmap_from_json(doc: dict) -> OSDMap:
    m = OSDMap()
    m.epoch = doc["epoch"]
    m.crush = crushtool.map_from_json(doc["crush"])
    m.set_max_osd(doc["max_osd"])
    m.osd_exists = [bool(v) for v in doc["osd_exists"]]
    m.osd_up = [bool(v) for v in doc["osd_up"]]
    m.osd_weight = [int(v) for v in doc["osd_weight"]]
    for p in doc.get("pools", []):
        m.pools[p["pool_id"]] = PGPool(**p)
    m.pg_upmap = {_parse_pgid(k): list(v)
                  for k, v in doc.get("pg_upmap", {}).items()}
    m.pg_upmap_items = {_parse_pgid(k): [tuple(t) for t in v]
                        for k, v in doc.get("pg_upmap_items", {}).items()}
    return m


# ---------------------------------------------------------------------------
# createsimple


def create_simple(num_osds: int, pg_num: int = 128, pool_size: int = 3,
                  hosts: int = 0) -> OSDMap:
    """OSDMap::build_simple: N up+in OSDs under a host layer, one
    replicated pool 'rbd' with a chooseleaf-host rule."""
    hosts = hosts or num_osds
    per_host = -(-num_osds // hosts)
    m = OSDMap()
    crush = crushtool.build_map(
        num_osds, [("host", "straw2", per_host), ("root", "straw2", 0)])
    crush.add_simple_rule("replicated_rule", "default",
                          failure_domain="host", mode="firstn")
    inc = Incremental(1)
    inc.new_max_osd = num_osds
    inc.new_crush = crush
    for osd in range(num_osds):
        inc.new_up[osd] = ("127.0.0.1", 6800 + osd)
        inc.new_weight[osd] = 0x10000
    inc.new_pools[0] = PGPool(pool_id=0, name="rbd",
                              type=POOL_TYPE_REPLICATED, size=pool_size,
                              min_size=max(1, pool_size - 1), pg_num=pg_num,
                              crush_rule=0)
    m.apply_incremental(inc)
    return m


# ---------------------------------------------------------------------------
# test-map-pgs


def test_map_pgs(m: OSDMap, pool_filter: int | None = None,
                 batched: bool = False, device=None) -> str:
    """The per-OSD report of a full remap; with `batched`, each pool one
    sweep on `device` (None: the card)."""
    mapping = OSDMapMapping()
    mapping.update(m, batched=batched, device=device)
    out = []
    counts = np.zeros(m.max_osd, dtype=np.int64)
    primaries = np.zeros(m.max_osd, dtype=np.int64)
    firsts = np.zeros(m.max_osd, dtype=np.int64)
    total_pgs = 0
    for pgid, (up, up_p, acting, acting_p) in sorted(
            mapping.by_pg.items(), key=lambda kv: (kv[0].pool, kv[0].ps)):
        if pool_filter is not None and pgid.pool != pool_filter:
            continue
        total_pgs += 1
        for osd in acting:
            if osd != CRUSH_ITEM_NONE and 0 <= osd < m.max_osd:
                counts[osd] += 1
        if acting and 0 <= acting[0] < m.max_osd \
                and acting[0] != CRUSH_ITEM_NONE:
            firsts[acting[0]] += 1
        if 0 <= acting_p < m.max_osd and acting_p != CRUSH_ITEM_NONE:
            primaries[acting_p] += 1
    # per-osd table, then the reference's summary lines
    crush_wt = {}
    for b in m.crush.buckets.values():
        for item, w in zip(b.items, b.weights):
            if item >= 0:
                crush_wt[int(item)] = int(w) / 0x10000
    out.append("#osd\tcount\tfirst\tprimary\tc wt\twt")
    for osd in range(m.max_osd):
        out.append("osd.%d\t%d\t%d\t%d\t%.4f\t%.4f"
                   % (osd, counts[osd], firsts[osd], primaries[osd],
                      crush_wt.get(osd, 0.0), m.osd_weight[osd] / 0x10000))
    nonzero = counts[np.asarray(
        [m.is_in(o) for o in range(m.max_osd)], dtype=bool)]
    avg = float(nonzero.mean()) if nonzero.size else 0.0
    dev = float(nonzero.std()) if nonzero.size else 0.0
    out.append(" avg %.2f stddev %.2f" % (avg, dev))
    if counts.size:
        out.append(" min osd.%d %d"
                   % (int(np.argmin(counts)), int(counts.min())))
        out.append(" max osd.%d %d"
                   % (int(np.argmax(counts)), int(counts.max())))
    out.append("total %d pgs" % total_pgs)
    return "\n".join(out)


def test_map_object(m: OSDMap, name: str, pool_id: int) -> str:
    pgid = m.object_to_pg(pool_id, name)
    up, up_p, acting, acting_p = m.pg_to_up_acting_osds(pgid)
    return (" object '%s' -> %s -> up (%r, p%d) acting (%r, p%d)"
            % (name, pgid, up, up_p, acting, acting_p))


# ---------------------------------------------------------------------------
# upmap balancer (OSDMap::calc_pg_upmaps)


def calc_pg_upmaps(m: OSDMap, pool_filter: int | None = None,
                   max_changes: int = 10, max_deviation: float = 1.0,
                   use_device: bool = True, device=None):
    """A rebalance proposal from ``osd.balancer.calc_pg_upmaps``, each
    sweep on `device` with `use_device` (else the scalar path on the
    host); max_deviation is in PGs. Returns the BalancerResult."""
    from ..osd.balancer import calc_pg_upmaps as _calc
    pools = {pool_filter} if pool_filter is not None else None
    return _calc(m, max_deviation=max_deviation, max_changes=max_changes,
                 pools=pools, use_device=use_device, device=device)


# ---------------------------------------------------------------------------
# CLI


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="osdmaptool", description="manipulate OSD cluster maps")
    p.add_argument("mapfile", nargs="?", help="compiled (JSON) osdmap")
    p.add_argument("--createsimple", type=int, metavar="N")
    p.add_argument("--pg-num", type=int, default=128)
    p.add_argument("--pool-size", type=int, default=3)
    p.add_argument("--hosts", type=int, default=0)
    p.add_argument("-o", "--output", metavar="DST")
    p.add_argument("--print", dest="print_map", action="store_true")
    p.add_argument("--test-map-pgs", action="store_true")
    p.add_argument("--test-map-object", metavar="NAME")
    p.add_argument("--pool", type=int, default=None)
    p.add_argument("--batched", action="store_true",
                   help="map each pool's PGs in one batched sweep")
    p.add_argument("--device", default=None,
                   help="device of --batched (default: the CUDA card; "
                        "cpu for the plain version)")
    p.add_argument("--upmap", metavar="OUT",
                   help="write pg-upmap-items rebalance commands")
    p.add_argument("--upmap-pool", type=int, default=None)
    p.add_argument("--upmap-max", type=int, default=10)
    p.add_argument("--upmap-deviation", type=float, default=1,
                   help="stop when the fullest osd is within this "
                        "many PGs of its target")
    p.add_argument("--mark-down", type=int, metavar="OSD", default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.createsimple:
            m = create_simple(args.createsimple, pg_num=args.pg_num,
                              pool_size=args.pool_size, hosts=args.hosts)
            dst = args.output or args.mapfile
            if not dst:
                raise ValueError("--createsimple needs an output mapfile")
            with open(dst, "w") as f:
                json.dump(osdmap_to_json(m), f, indent=1)
            sys.stdout.write("osdmaptool: wrote epoch %d to %s\n"
                             % (m.epoch, dst))
            return 0
        if not args.mapfile:
            build_parser().print_usage(sys.stderr)
            return 1
        with open(args.mapfile) as f:
            m = osdmap_from_json(json.load(f))
        if args.mark_down is not None:
            inc = Incremental(m.epoch + 1)
            inc.new_down.append(args.mark_down)
            m.apply_incremental(inc)
            with open(args.output or args.mapfile, "w") as f:
                json.dump(osdmap_to_json(m), f, indent=1)
            sys.stdout.write("osdmaptool: marked osd.%d down (epoch %d)\n"
                             % (args.mark_down, m.epoch))
            return 0
        if args.print_map:
            sys.stdout.write(
                "epoch %d\nmax_osd %d\npools %s\n"
                % (m.epoch, m.max_osd,
                   ", ".join("%d '%s' size %d pg_num %d"
                             % (p.pool_id, p.name, p.size, p.pg_num)
                             for p in m.pools.values())))
            return 0
        if args.test_map_pgs:
            sys.stdout.write(test_map_pgs(
                m, pool_filter=args.pool, batched=args.batched,
                device=args.device) + "\n")
            return 0
        if args.test_map_object:
            if args.pool is None or args.pool not in m.pools:
                raise ValueError("--test-map-object needs a valid --pool")
            sys.stdout.write(test_map_object(
                m, args.test_map_object, args.pool) + "\n")
            return 0
        if args.upmap:
            res = calc_pg_upmaps(
                m, pool_filter=args.upmap_pool, max_changes=args.upmap_max,
                max_deviation=args.upmap_deviation,
                use_device=args.batched, device=args.device)
            with open(args.upmap, "w") as f:
                for pgid in res.old_pg_upmap_items:
                    if pgid in res.new_pg_upmap_items:
                        continue
                    f.write("ceph osd rm-pg-upmap-items %s\n" % pgid)
                for pgid, pairs in sorted(
                        res.new_pg_upmap_items.items(),
                        key=lambda kv: (kv[0].pool, kv[0].ps)):
                    f.write("ceph osd pg-upmap-items %s %s\n"
                            % (pgid, " ".join("%d %d" % t for t in pairs)))
            sys.stdout.write(
                "osdmaptool: wrote %d upmap commands to %s "
                "(deviation %.2f -> %.2f, %d sweeps)\n"
                % (res.num_changed, args.upmap, res.start_deviation,
                   res.end_deviation, res.sweeps))
            return 0
    except (ValueError, OSError, KeyError, RuntimeError) as e:
        # json.JSONDecodeError is a ValueError; RuntimeError is a
        # --batched run without CUDA or a failed launch
        sys.stderr.write("osdmaptool: %s\n" % e)
        return 1
    build_parser().print_usage(sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
