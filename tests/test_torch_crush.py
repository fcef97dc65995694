"""The port's CRUSH primitives, scalar mapper and crushtool against the JAX
package's, on the CPU.

The port keeps its own copies of ``ceph_tpu/crush/`` (``ceph_tpu_torch/
crush/``): the rjenkins hashes and crush_ln in numpy and in torch int64,
the straw2 division, the scalar interpreter ``mapper_ref`` on every map
shape of tests/test_crush.py (flat and two-level, straw2, uniform and
list leaves, indep and firstn, choose and chooseleaf, the legacy
tunables, choose_args), and ``crushtool --build`` / ``--test``.
Inputs come from numpy seeds; tolerance: none, every value equal.
"""

import json

import numpy as np
import pytest
import torch

from ceph_tpu.crush import hashing as jhashing
from ceph_tpu.crush import ln as jln
from ceph_tpu.crush import map as jmap
from ceph_tpu.crush import mapper_ref as jmapper
from ceph_tpu.tools import crushtool as jcrushtool
from ceph_tpu_torch.crush import hashing, ln
from ceph_tpu_torch.crush import map as tmap
from ceph_tpu_torch.crush import mapper_ref
from ceph_tpu_torch.tools import crushtool

from .torch_util import one_torch_thread  # noqa: F401

EDGES = np.array([0, 1, 2, 0x7FFF, 0x8000, 0xFFFF, 0x10000, 0x7FFFFFFE,
                  0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 dtype=np.uint32)


def words(n_cols, seed):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 1 << 32, size=(n_cols, 4096), dtype=np.uint64)
    cols = cols.astype(np.uint32)
    for c in range(n_cols):          # every edge value in every column
        cols[c, c:c + EDGES.size] = np.roll(EDGES, c)
    return cols


@pytest.mark.parametrize("n", [2, 3, 4])
def test_hashes_equal_the_reference(n):
    cols = words(n, n)
    fn = {2: "hash32_2", 3: "hash32_3", 4: "hash32_4"}[n]
    ref = getattr(jhashing, fn)(*cols)
    np.testing.assert_array_equal(getattr(hashing, fn)(*cols), ref)
    if n < 4:       # the torch form, from int64 values and from signed ones
        t = getattr(hashing, fn + "_t")
        got = t(*[torch.from_numpy(c.astype(np.int64)) for c in cols])
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
        signed = t(*[torch.from_numpy(c.view(np.int32).astype(np.int64))
                     for c in cols])
        np.testing.assert_array_equal(signed.numpy(), ref.astype(np.int64))


def test_crush_ln_whole_domain():
    u = np.arange(0x10000, dtype=np.int64)
    ref = jln.crush_ln(u)
    np.testing.assert_array_equal(ln.crush_ln(u), ref)
    np.testing.assert_array_equal(ln.crush_ln_t(torch.from_numpy(u)).numpy(),
                                  ref)
    # the one input whose RH*x product wraps in int64 (x = 0x10000)
    assert ln.crush_ln_t(torch.tensor([0xFFFF])).item() == int(ref[-1])


def test_straw2_division_at_the_extremes():
    lns = np.array([0, -1, -0x10000, -(1 << 44), -(1 << 48) + 1, -(1 << 48)],
                   dtype=np.int64)
    ws = np.array([1, 2, 3, 0x10000, 0xFFFFFFFF, 0x7FFFFFFF], dtype=np.int64)
    a, b = np.meshgrid(lns, ws)
    ref = jln.straw2_draw_divide(a, b)
    np.testing.assert_array_equal(ln.straw2_draw_divide(a, b), ref)
    got = ln.straw2_draw_divide_t(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), ref)


# -- the scalar interpreter on the maps of tests/test_crush.py ----------------

def make_flat(mod, ndev, weights, alg="straw2"):
    m = mod.CrushMap()
    m.type_names = {"osd": 0, "host": 1}
    m.add_bucket(alg, 1, list(range(ndev)), [int(w) for w in weights],
                 id=-1, name="default")
    return m


def make_two_level(mod, hosts, per, weights, alg="straw2"):
    m = mod.CrushMap()
    m.type_names = {"osd": 0, "host": 1, "root": 2}
    hids, hw = [], []
    for h in range(hosts):
        items = [h * per + i for i in range(per)]
        w = [int(weights[i]) for i in items]
        hids.append(m.add_bucket(alg, 1, items, w, id=-2 - h))
        hw.append(sum(w))
    m.add_bucket("straw2", 2, hids, hw, id=-1, name="default")
    return m


SCALAR_CASES = [
    # (name, two-level, leaf alg, step op, numrep, type, result_max)
    ("flat_choose_indep", False, "straw2", "choose_indep", 4, 0, 4),
    ("flat_choose_firstn", False, "straw2", "choose_firstn", 3, 0, 3),
    ("flat_numrep_past_result_max", False, "straw2", "choose_indep", 6, 0,
     4),
    ("leaf_indep_straw2", True, "straw2", "chooseleaf_indep", 4, 1, 4),
    ("leaf_firstn_straw2", True, "straw2", "chooseleaf_firstn", 3, 1, 3),
    ("leaf_indep_list", True, "list", "chooseleaf_indep", 4, 1, 4),
    ("leaf_indep_uniform", True, "uniform", "chooseleaf_indep", 4, 1, 4),
    ("leaf_firstn_uniform", True, "uniform", "chooseleaf_firstn", 3, 1, 3),
    ("choose_hosts_firstn", True, "straw2", "choose_firstn", 2, 1, 2),
]


def build_case(mod, two_level, alg, op, numrep, typ, legacy=False):
    rng = np.random.default_rng(11)
    if two_level:
        weights = rng.integers(1, 3 * 0x10000, size=24, dtype=np.uint32)
        m = make_two_level(mod, 6, 4, weights, alg)
    else:
        weights = rng.integers(1, 3 * 0x10000, size=10, dtype=np.uint32)
        m = make_flat(mod, 10, weights, alg)
    if legacy:
        m.tunables = mod.Tunables(choose_local_tries=2,
                                  choose_local_fallback_tries=5,
                                  chooseleaf_vary_r=0, chooseleaf_stable=0,
                                  chooseleaf_descend_once=0)
    m.add_rule(mod.Rule(steps=[(mod.RULE_TAKE, -1), (op, numrep, typ),
                               (mod.RULE_EMIT,)]))
    reweight = np.full(len(weights), 0x10000, dtype=np.int64)
    reweight[1] = 0
    reweight[7] = 0x8000
    return m, list(reweight)


@pytest.mark.parametrize("case", SCALAR_CASES, ids=[c[0] for c in SCALAR_CASES])
def test_mapper_ref_equals_the_reference(case):
    _, two, alg, op, numrep, typ, rmax = case
    jm, rw = build_case(jmap, two, alg, op, numrep, typ)
    tm, _ = build_case(tmap, two, alg, op, numrep, typ)
    for x in list(range(-20, 60)) + [2**31 - 1, 2**31, 2**32 - 1]:
        assert mapper_ref.crush_do_rule(tm, 0, x, rmax, rw) == \
            jmapper.crush_do_rule(jm, 0, x, rmax, rw), x


@pytest.mark.parametrize("op", ["chooseleaf_firstn", "chooseleaf_indep"])
def test_mapper_ref_legacy_tunables(op):
    jm, rw = build_case(jmap, True, "straw2", op, 3, 1, legacy=True)
    tm, _ = build_case(tmap, True, "straw2", op, 3, 1, legacy=True)
    for x in range(80):
        assert mapper_ref.crush_do_rule(tm, 0, x, 3, rw) == \
            jmapper.crush_do_rule(jm, 0, x, 3, rw), x


@pytest.mark.parametrize("positions,with_ids", [(1, False), (3, True)])
def test_mapper_ref_choose_args(positions, with_ids):
    rng = np.random.default_rng(31 + positions)
    ws = rng.integers(0x2000, 4 * 0x10000, size=(positions, 6))
    host_ws = rng.integers(0x2000, 4 * 0x10000, size=(positions, 4))
    cargs = {-1: {"weight_set": ws.tolist(),
                  "ids": [int(i) + 50 for i in rng.permutation(6)]
                  if with_ids else None},
             -3: {"weight_set": host_ws.tolist(), "ids": None}}
    for op in ("chooseleaf_firstn", "chooseleaf_indep"):
        jm, rw = build_case(jmap, True, "straw2", op, 3, 1)
        tm, _ = build_case(tmap, True, "straw2", op, 3, 1)
        for x in range(60):
            assert mapper_ref.crush_do_rule(tm, 0, x, 3, rw,
                                            choose_args=cargs) == \
                jmapper.crush_do_rule(jm, 0, x, 3, rw, choose_args=cargs)


def test_choose_args_helpers_equal_the_reference():
    maps = [make_two_level(mod, 3, 2, [0x10000] * 6) for mod in (jmap, tmap)]
    for m in maps:
        m.create_choose_args(0, positions=2)
        m.choose_args_adjust_item_weight(0, -2, 0, 0)
        m.choose_args_adjust_item_weight(0, -3, 3, [0x8000, 0x4000, 0x2000])
    assert maps[0].choose_args == maps[1].choose_args


# -- crushtool --------------------------------------------------------------

LAYERS = [("host", "straw2", 16), ("rack", "straw2", 8),
          ("root", "straw2", 0)]


def test_build_equals_the_reference_bucket_for_bucket(tmp_path):
    out = tmp_path / "map.json"
    assert crushtool.main(["--build", "--num-osds", "1024", "-o", str(out),
                           *[str(v) for layer in LAYERS for v in layer]]) \
        == 0
    got = crushtool.map_from_json(json.loads(out.read_text()))
    ref = jcrushtool.build_map(1024, LAYERS)
    assert len(got.buckets) == len(ref.buckets) == 73
    for bid, b in ref.buckets.items():
        mine = got.buckets[bid]
        assert (mine.alg, mine.type) == (b.alg, b.type)
        np.testing.assert_array_equal(mine.items, b.items)
        np.testing.assert_array_equal(mine.weights, b.weights)
    assert got.bucket_names == ref.bucket_names
    assert got.type_names == ref.type_names
    assert crushtool.map_to_json(got) == jcrushtool.map_to_json(ref)


def test_test_report_equals_the_reference(tmp_path, capsys):
    m = crushtool.build_map(64, [("host", "straw2", 4), ("root", "straw2", 0)])
    m.add_simple_rule("rep", "default", "host")
    path = tmp_path / "map.json"
    path.write_text(json.dumps(crushtool.map_to_json(m)))
    args = ["-i", str(path), "--test", "--rule", "0", "--num-rep", "3",
            "--min-x", "0", "--max-x", "199", "--show-utilization"]
    assert crushtool.main(args + ["--batched", "--device", "cpu"]) == 0
    batched = capsys.readouterr().out
    assert crushtool.main(args) == 0
    scalar = capsys.readouterr().out
    jm = jcrushtool.map_from_json(json.loads(path.read_text()))
    counts, results = jcrushtool.run_test(jm, 0, 3, 0, 199)
    ref = jcrushtool.format_test_report(jm, counts, results, 0, 3,
                                        show_utilization=True) + "\n"
    assert scalar == ref
    assert batched == ref
    assert "device 0:" in ref
