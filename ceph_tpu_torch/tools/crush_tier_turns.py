"""Device time of the CRUSH sweeps and of the tier's rebuild, for turns.

    python3 ceph_tpu_torch/tools/crush_tier_turns.py [--tree DIR]
        [--parts crush,crossing,crossover,tier] [--split]
        [--groups 1,2,...] [--tag NAME]

Times, on one CUDA card, the port's two placement and recovery kernels at
the sizes ``chip_smoke.py`` phases 9 and 10 drive them, for the tree at
``--tree`` (default: the checkout this file lies in), so that two trees
unpacked side by side (``git archive``) are compared on one card, in
turns (A, B, B, A):

``--parts crush``: the six straw2 sweeps of phase 9 (the bench's map at
65,536 seeds; the 1024-OSD cluster's EC rule, indep 12, and replicated
rule, firstn 3, at 8,192 and 2^20 seeds, under a rebalance's reweights;
the EC rule with a two-position weight set at 65,536): each sweep's
median device time (``utils/cuda_timing.time_ms``, seeds on the card,
tables cached), its bound from the draws the kernel counts, and its
result's digest, which must agree across trees. With ``--split``, where
the tree's kernel takes ``clocks``: one profiled sweep of each, the
per-warp clock split (cycles, draw steps, the lanes active at them) and
the SM clock that ``nvidia-smi`` reads during a loop of the 2^20 EC
sweep; and the per-seed draw counts per warp of seeds. With
``--groups 1,2,4``, where the tree's kernel takes ``group``: each sweep
timed at those lanes a seed as well. ``chip_smoke.py`` phase 9 drives
the same six cases (:func:`crush_cases`).

``--parts crossing``: the same measurements on maps whose tables fit the
kernel's 64 KiB of shared memory without the weights' reciprocals and
not with them (:func:`crossing_cases`), with the design each tree takes.

``--parts crossover`` (this tree's kernel only): the bench map and the
cluster's two rules at 1,024 to 65,536 seeds (powers of two), each at
the lanes a seed in ``--groups`` (default 4, 8, 16), beside the group
the kernel picks.

``--parts tier``: the device chunk tier's batched rebuild
(``HbmChunkTier.reconstruct_batch``, RS k=8, m=3) at phase 10's sizes
(``TIER_A``, ``TIER_B``, ``TIER_C``, which ``chip_smoke.py`` reads from
here): (a) 3 upload batches of 16 objects of 1 MiB, (b) 48 objects of
4 MiB adopted one by one (48 upload batches) and (c) 1024 objects of
4 MiB in upload batches of 16: the rebuild's device time and wall time, its operands' device
time (what the tree does before the per-lane kernel), the kernel's
device time, and the rebuild's peak device memory above what was
allocated before it (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``), with every rebuilt shard checked against
the resident original.

One JSON line per measurement on standard output, each with the tree,
``--tag`` and the card's name and power limit, also appended to
``chiprun_out/crush_tier_turns.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parents[2]


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "not read"


class _Out:
    def __init__(self, tree: Path, tag: str):
        self.common = {"tree": str(tree), "tag": tag, "card": _card()}
        path = _HERE / "chiprun_out"
        path.mkdir(exist_ok=True)
        self.file = open(path / "crush_tier_turns.jsonl", "a")

    def __call__(self, part: str, **fields) -> None:
        line = json.dumps({"part": part, **fields, **self.common})
        print(line, flush=True)
        self.file.write(line + "\n")
        self.file.flush()


# phase 10's sizes (chip_smoke.py drives them; _tier_cases imitates them
# here): (a) rounds, objects a round, object bytes (bench.py's resident
# pipeline); (b) stripes and chunk of a 4 MiB write at stripe_unit 4096,
# writer threads, writes a thread; (c) objects, objects an upload batch,
# object bytes
TIER_A = (3, 16, 1 << 20)
TIER_B = (128, 4096, 8, 8)
TIER_C = (1024, 16, 4 << 20)
CLUSTER_LAYERS = [("host", "straw2", 16), ("rack", "straw2", 8),
                  ("root", "straw2", 0)]


def crush_bench_map(np):
    """bench.py:820 _crush_bench_map in the port's classes: 8 hosts of 4
    OSDs (straw2, weights from seed 7070), rule 0 chooseleaf indep 5 over
    hosts, OSD 3 reweighted to 0. Returns the map and its reweights."""
    from ceph_tpu_torch.crush import map as cm_mod
    from ceph_tpu_torch.crush.map import CrushMap, Rule

    rng = np.random.default_rng(7070)
    weights = rng.integers(0x8000, 3 * 0x10000, size=32, dtype=np.uint32)
    m = CrushMap()
    m.type_names = {"osd": 0, "host": 1, "root": 2}
    hids, hw = [], []
    for h in range(8):
        items = [h * 4 + i for i in range(4)]
        w = [int(weights[i]) for i in items]
        hids.append(m.add_bucket("straw2", 1, items, w, id=-2 - h))
        hw.append(sum(w))
    m.add_bucket("straw2", 2, hids, hw, id=-1, name="default")
    m.add_rule(Rule(steps=[(cm_mod.RULE_TAKE, -1),
                           (cm_mod.RULE_CHOOSELEAF_INDEP, 5, 1),
                           (cm_mod.RULE_EMIT,)]))
    reweight = np.full(32, 0x10000, dtype=np.int64)
    reweight[3] = 0
    return m, reweight


def cluster_reweight(np, osds: int):
    """A rebalance: every 97th OSD out, every 89th from OSD 5 at half
    weight."""
    rw = np.full(osds, 0x10000, dtype=np.int64)
    rw[::97] = 0
    rw[5::89] = 0x8000
    return rw


def crush_cases(np, cluster=None):
    """Phase 9's six sweeps: [(name, map, rule, result_max, reweight,
    choose_args, seeds)]. `cluster` is the 1024-OSD map of 16 OSDs a
    host and 8 hosts a rack (``crushtool --build``; built here when
    None); its EC rule (indep 12 over hosts) and replicated rule (firstn
    3) are added to it. The weight-set map is its copy with a
    two-position weight set on five hosts (the balancer's path)."""
    from ceph_tpu_torch.tools import crushtool

    if cluster is None:
        cluster = crushtool.build_map(1024, CLUSTER_LAYERS)
    ec = cluster.add_simple_rule("ec", "default", "host", mode="indep")
    rep = cluster.add_simple_rule("rep", "default", "host")
    weighted = crushtool.map_from_json(crushtool.map_to_json(cluster))
    weighted.create_choose_args(0, positions=2)
    for host in (3, 17, 29, 42, 58):
        weighted.choose_args_adjust_item_weight(
            0, -1 - host, host * 16 + 4, [0x4000, 0xC000])
    c_rw = cluster_reweight(np, 1024)
    bench, b_rw = crush_bench_map(np)
    return [  # name, map, rule, result_max, reweight, choose_args, seeds
        ("bench_65536", bench, 0, 5, b_rw, None, 65536),
        ("cluster_ec_8192", cluster, ec, 12, c_rw, None, 8192),
        ("cluster_rep_8192", cluster, rep, 3, c_rw, None, 8192),
        ("cluster_ec_weight_sets_65536", weighted, ec, 12, c_rw, 0, 65536),
        ("cluster_ec_1048576", cluster, ec, 12, c_rw, None, 1 << 20),
        ("cluster_rep_1048576", cluster, rep, 3, c_rw, None, 1 << 20),
    ]


def crossing_cases(np):
    """Maps whose tables fit 64 KiB without the weights' reciprocals and
    not with them: one straw2 bucket of 3,000 OSDs (the GPU tests' flat
    map: weights 0x8000 + (7919 i mod 0x20000), every 13th OSD out,
    every 17th from OSD 1 at 0x9000) under indep 6, and a 2,560-OSD
    cluster of 16 OSDs a host and 8 hosts a rack under its EC and
    replicated rules, at the PGs Ceph's (OSDs x 100) / size rule gives
    a pool (16,384 for 12 shards, 65,536 for 3 replicas)."""
    from ceph_tpu_torch.crush import map as cm_mod
    from ceph_tpu_torch.crush.map import CrushMap, Rule
    from ceph_tpu_torch.tools import crushtool

    flat = CrushMap()
    flat.type_names = {"osd": 0, "root": 1}
    flat.add_bucket("straw2", 1, list(range(3000)),
                    [0x8000 + (i * 7919) % 0x20000 for i in range(3000)],
                    id=-1, name="default")
    flat.add_rule(Rule(steps=[(cm_mod.RULE_TAKE, -1),
                              (cm_mod.RULE_CHOOSE_INDEP, 6, 0),
                              (cm_mod.RULE_EMIT,)]))
    f_rw = np.full(3000, 0x10000, dtype=np.int64)
    f_rw[::13] = 0
    f_rw[1::17] = 0x9000
    big = crushtool.build_map(2560, CLUSTER_LAYERS)
    ec = big.add_simple_rule("ec", "default", "host", mode="indep")
    rep = big.add_simple_rule("rep", "default", "host")
    b_rw = cluster_reweight(np, 2560)
    return [
        ("flat_3000_65536", flat, 0, 6, f_rw, None, 65536),
        ("cluster2560_ec_16384", big, ec, 12, b_rw, None, 16384),
        ("cluster2560_rep_65536", big, rep, 3, b_rw, None, 65536),
    ]


def sm_clocks(fn, seconds: float) -> list[int]:
    """The SM clock (MHz) that nvidia-smi reads every 20 ms while fn runs
    in a loop for about `seconds`."""
    import torch
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "20"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    return [int(v) for v in out.split() if v.strip().isdigit()]


def crush_part(out: _Out, cases, split: bool, groups: list[int]) -> None:
    import inspect

    import numpy as np
    import torch

    from ceph_tpu_torch.crush import batched
    from ceph_tpu_torch.ops import crush_kernel
    from ceph_tpu_torch.utils.cuda_timing import crush_bound, time_ms

    dev = torch.device("cuda")
    params = inspect.signature(crush_kernel.crush_sweep).parameters
    profiled = "clocks" in params
    group = getattr(crush_kernel, "kernel_group", None)
    for name, m, rule, rmax, rw, args, n in cases(np):
        cargs = m.choose_args_get_with_fallback(args) \
            if args is not None else None
        cm = batched.compile_map(m, cargs)
        plan = batched.plan_rule(m, rule, rmax)
        wvec = batched.reweight_vector(rw, cm.max_devices)
        xs = torch.arange(n, dtype=torch.int64, device=dev)
        res = crush_kernel.crush_sweep(cm, plan, xs, wvec)
        work = torch.zeros((n, 2), dtype=torch.int32, device=dev)
        crush_kernel.crush_sweep(cm, plan, xs, wvec, work=work)
        bound_ms, bound_by = crush_bound(work, rmax)
        ms = time_ms(lambda x: crush_kernel.crush_sweep(cm, plan, x, wvec),
                     [xs], 20 if n <= 65536 else 5)
        draws = work[:, 0].to(torch.int64)
        rec = dict(case=name, seeds=n, ms=ms, bound_ms=bound_ms,
                   bound_by=bound_by, share_of_bound=bound_ms / ms,
                   draws=int(draws.sum()), draws_per_seed=float(
                       draws.double().mean()),
                   hashes=int(work[:, 1].to(torch.int64).sum()),
                   design=crush_kernel.kernel_design(cm, plan, wvec.size),
                   table_bytes=int(crush_kernel.pack_tables(
                       cm, wvec).nbytes),
                   result_digest=int((res * torch.arange(
                       1, rmax + 1, device=dev)).sum() % (1 << 61)),
                   group=group(cm, plan, wvec.size, n) if group else 1)
        for g in (32, 16, 8):   # draws' mean over max per g seeds
            d = draws[: n // g * g].view(-1, g).double()
            rec["draws_mean_over_max_per_%d_seeds" % g] = float(
                d.mean(dim=1).sum() / d.max(dim=1).values.sum())
        if split and profiled:
            rows = crush_kernel.clock_rows(cm, plan, wvec.size, n)
            clk = torch.zeros((rows, 4), dtype=torch.int64, device=dev)
            crush_kernel.crush_sweep(cm, plan, xs, wvec, clocks=clk)
            prof_ms = time_ms(lambda x: crush_kernel.crush_sweep(
                cm, plan, x, wvec, clocks=clk), [xs], 5)
            c = clk[clk[:, 0] > 0].double()
            steps, lanes = float(c[:, 1].sum()), float(c[:, 2].sum())
            per_sm = torch.bincount(c[:, 3].long())
            rec.update(
                profiled_ms=prof_ms, warps=int(c.shape[0]),
                warp_cycles_mean=float(c[:, 0].mean()),
                warp_cycles_max=float(c[:, 0].max()),
                draw_steps=steps, lane_draws=lanes,
                cycles_per_draw_step=float(c[:, 0].sum()) / steps,
                active_lane_share=lanes / (32 * steps),
                sms_used=int((per_sm > 0).sum()),
                warps_per_sm_max=int(per_sm.max()))
            if name == "cluster_ec_1048576":
                clocks = sm_clocks(lambda: crush_kernel.crush_sweep(
                    cm, plan, xs, wvec), 3.0)
                rec["sm_clock_mhz"] = [min(clocks), max(clocks)] \
                    if clocks else "not read"
        if groups and "group" in params:
            rec["ms_by_group"] = {g: time_ms(
                lambda x, g=g: crush_kernel.crush_sweep(cm, plan, x, wvec,
                                                        group=g),
                [xs], 20 if n <= 65536 else 5) for g in groups}
        out("crush", **rec)


def crossover_part(out: _Out, groups: list[int]) -> None:
    """The bench map and the cluster's EC and replicated rules at 1,024
    to 65,536 seeds, each at the lanes a seed in `groups`: where the G
    that fills the card gives way to the smaller one."""
    import numpy as np
    import torch

    from ceph_tpu_torch.crush import batched
    from ceph_tpu_torch.ops import crush_kernel
    from ceph_tpu_torch.utils.cuda_timing import time_ms

    dev = torch.device("cuda")
    cases = {c[0]: c for c in crush_cases(np)}
    for base in ("bench_65536", "cluster_ec_8192", "cluster_rep_8192"):
        _, m, rule, rmax, rw, _, _ = cases[base]
        cm = batched.compile_map(m)
        plan = batched.plan_rule(m, rule, rmax)
        wvec = batched.reweight_vector(rw, cm.max_devices)
        for n in (1024, 2048, 4096, 8192, 16384, 32768, 65536):
            xs = torch.arange(n, dtype=torch.int64, device=dev)
            out("crossover", case=base.rsplit("_", 1)[0], seeds=n,
                group=crush_kernel.kernel_group(cm, plan, wvec.size, n),
                ms_by_group={g: time_ms(
                    lambda x, g=g: crush_kernel.crush_sweep(
                        cm, plan, x, wvec, group=g), [xs], 20)
                    for g in groups})


def _tier_cases(torch, codec, dev):
    """(name, tier, names, lost) of (a), (b) and (c) at phase 10's sizes,
    data on the card: (a) put_encode a round, (b) the store-mode three
    quarters of phase 10's writes adopted one by one, (c) put_encode an
    upload batch."""
    from ceph_tpu_torch.osd.hbm_tier import HbmChunkTier

    g = torch.Generator(device=dev).manual_seed(20261017)
    k, nn = codec.get_data_chunk_count(), codec.get_chunk_count()

    def rand(*shape):
        return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8,
                             device=dev)
    rounds, per_a, obj_a = TIER_A
    tier_a = HbmChunkTier(codec, capacity_objects=rounds * per_a + 1)
    names_a = []
    for r in range(rounds):
        names = ["a%d-%d" % (r, i) for i in range(per_a)]
        tier_a.put_encode(names, rand(per_a, k, obj_a // k))
        names_a += names
    lost_a = [(i + r) % nn for r in range(rounds) for i in range(per_a)]
    yield "a_bench", tier_a, names_a, lost_a
    del tier_a
    stripes, chunk_b, threads, per_thread = TIER_B
    n_b = threads * per_thread * 3 // 4
    tier_b = HbmChunkTier(codec, capacity_objects=threads * per_thread)
    names_b = ["b%d" % i for i in range(n_b)]
    for nm in names_b:
        data = rand(stripes, k, chunk_b)
        tier_b.adopt_encode(nm, data, codec.encode_batch(data), codec)
    yield "b_store", tier_b, names_b, [i % nn for i in range(n_b)]
    del tier_b
    n_c, per_c, obj_c = TIER_C
    tier_c = HbmChunkTier(codec, capacity_objects=n_c)
    names_c = ["c%d" % i for i in range(n_c)]
    for b in range(n_c // per_c):
        tier_c.put_encode(names_c[b * per_c:(b + 1) * per_c],
                          rand(per_c, k, obj_c // k))
    yield "c_osd_tier", tier_c, names_c, [(i * 7) % nn for i in
                                          range(n_c)]


def tier_part(out: _Out) -> None:
    import torch

    from ceph_tpu_torch import registry
    from ceph_tpu_torch.ops import gf_kernel
    from ceph_tpu_torch.utils.cuda_timing import time_ms

    dev = torch.device("cuda")
    codec = registry.factory("torch_cuda", {
        "technique": "reed_sol_van", "k": "8", "m": "3", "w": "8"})
    rows_api = hasattr(gf_kernel, "matrix_encode_multi_rows")
    for name, tier, names, lost in _tier_cases(torch, codec, dev):
        def operands():
            return tier._rebuild_operands(names, lost)
        if rows_api:            # bitmatrices, then the survivors' table
            from ceph_tpu_torch.ops import row_table

            def operands_all():
                bm, parts, rows, w = operands()
                return bm, row_table.row_table(parts, rows), w

            def kernel(ops):
                bm, (table, n, _), w = ops
                return gf_kernel._multi_rows(bm, table, n, w)
        else:                   # bitmatrices, then the survivors' gather
            operands_all = operands

            def kernel(ops):
                bm, surv, w = ops
                return gf_kernel.matrix_encode_multi(bm, surv[:, None], w)
        ops = operands_all()
        got = kernel(ops).reshape(len(names), -1)
        for i, nm in enumerate(names):
            if not torch.equal(got[i], tier.get(nm)[lost[i]]):
                raise RuntimeError("%s: rebuilt shard of %s differs"
                                   % (name, nm))
        torch.cuda.synchronize()
        reps = 3 if len(names) > 64 else 10
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            tier.reconstruct_batch(names, lost)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        again = tier.reconstruct_batch(names, lost)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if not torch.equal(again.reshape(got.shape), got):
            raise RuntimeError("%s: reconstruct_batch differs" % name)
        del again, got
        out("tier", case=name, objects=len(names),
            chunk=int(tier.get(names[0]).shape[1]), api="row table"
            if rows_api else "gather",
            rebuild_ms=time_ms(lambda _: tier.reconstruct_batch(names, lost),
                               [None], reps),
            rebuild_wall_ms=walls,
            operands_ms=time_ms(lambda _: operands_all(), [None], reps),
            kernel_ms=time_ms(lambda _: kernel(ops), [None], 10),
            peak_bytes_above=int(peak), resident_bytes=int(
                tier.stats()["resident_bytes"]))
        del ops
        torch.cuda.empty_cache()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=str(_HERE),
                   help="checkout whose ceph_tpu_torch is timed")
    p.add_argument("--parts", default="crush,tier",
                   help="of crush, crossing, crossover, tier")
    p.add_argument("--split", action="store_true",
                   help="the CRUSH kernel's clock split, where it has one")
    p.add_argument("--groups", default="",
                   help="lanes a seed to time each sweep at, e.g. 1,4,16")
    p.add_argument("--tag", default="")
    a = p.parse_args(argv)
    tree = Path(a.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("crush_tier_turns: needs a CUDA card", file=sys.stderr)
        return 2
    import ceph_tpu_torch
    if Path(ceph_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError("imported %s, not the tree's package"
                           % ceph_tpu_torch.__file__)
    out = _Out(tree, a.tag)
    parts = a.parts.split(",")
    groups = [int(g) for g in a.groups.split(",") if g]
    if "crush" in parts:
        crush_part(out, crush_cases, a.split, groups)
    if "crossing" in parts:
        crush_part(out, crossing_cases, False, groups)
    if "crossover" in parts:
        crossover_part(out, groups or [4, 8, 16])
    if "tier" in parts:
        tier_part(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
