"""The port's crushtool text grammar and osdmaptool against the JAX
package's.

``ceph_tpu_torch.tools.crushtool`` (``compile_text``, ``decompile``, the
``-c`` / ``-d`` CLI) and ``ceph_tpu_torch.tools.osdmaptool`` against
``ceph_tpu.tools``' on tests/test_map_tools.py's inputs: the compiled
maps as JSON, the decompiled text, the compile errors (class and
message), choose_args weight sets through text, the CrushTester reports,
and osdmaptool's maps, reports, object lookups and upmap proposals. The
port's batched paths run the plain version (``device="cpu"``).
Tolerance: none.
"""

import json

import numpy as np
import pytest

from ceph_tpu.crush import map as jcmap
from ceph_tpu.tools import crushtool as jcrush
from ceph_tpu.tools import osdmaptool as jtool
from ceph_tpu_torch.crush import map as pcmap
from ceph_tpu_torch.osd.osd_map import PGID
from ceph_tpu_torch.tools import crushtool
from ceph_tpu_torch.tools import osdmaptool

from .torch_util import one_torch_thread  # noqa: F401
from .test_torch_osd_map import PORT, REF, build_map, by_pg, rows

# the plain version's many small ops run on one torch thread a worker
pytestmark = pytest.mark.usefixtures("one_torch_thread")

SAMPLE_MAP = """
# begin crush map
tunable choose_local_tries 0
tunable choose_total_tries 50
tunable chooseleaf_vary_r 1

# devices
device 0 osd.0
device 1 osd.1 class ssd
device 2 osd.2
device 3 osd.3

# types
type 0 osd
type 1 host
type 2 root

# buckets
host host0 {
\tid -2
\talg straw2
\thash 0
\titem osd.0 weight 1.000
\titem osd.1 weight 2.000
}
host host1 {
\tid -3
\talg straw2
\thash 0
\titem osd.2 weight 1.000
\titem osd.3 weight 1.000
}
root default {
\tid -1
\talg straw2
\thash 0
\titem host0 weight 3.000
\titem host1 weight 2.000
}

# rules
rule replicated_rule {
\truleset 0
\ttype replicated
\tmin_size 1
\tmax_size 10
\tstep take default
\tstep chooseleaf firstn 0 type host
\tstep emit
}
rule ec_rule {
\truleset 1
\ttype erasure
\tmin_size 3
\tmax_size 4
\tstep set_chooseleaf_tries 5
\tstep take default
\tstep chooseleaf indep 0 type osd
\tstep emit
}
# end crush map
"""

CHOOSE_ARGS_TEXT = """
type 0 osd
type 1 host
type 2 root
host h0 {
\titem osd.0 weight 0.500
\titem osd.1
}
host h1 {
\tid -7
\talg list
\titem osd.2 weight 1.250
}
root default {
\titem h0 weight 1.500
\titem h1 weight 1.250
}
rule r {
\tstep set_choose_tries 100
\tstep take default
\tstep choose firstn 2 type host
\tstep chooseleaf indep 1 type osd
\tstep emit
}
choose_args 3 {
  {
    bucket_id -1
    weight_set [
      [ 1.500000 1.250000 ]
      [ 0.000015 2.000000 ]
    ]
    ids [ 11 12 ]
  }
  {
    bucket_id -2
    weight_set [ [ 0.250000 1.000000 ] ]
  }
}
"""


def compile_both(text):
    return jcrush.compile_text(text), crushtool.compile_text(text)


def canonical(doc):
    """A compiled map's JSON with its buckets in id order."""
    doc = json.loads(json.dumps(doc))
    doc["buckets"] = sorted(doc["buckets"], key=lambda b: b["id"])
    return doc


# -- crushtool: the text grammar ---------------------------------------------

@pytest.mark.parametrize("text", [SAMPLE_MAP, CHOOSE_ARGS_TEXT],
                         ids=["sample", "choose_args"])
def test_compile_and_decompile_match_reference(text):
    ref, mine = compile_both(text)
    assert crushtool.map_to_json(mine) == jcrush.map_to_json(ref)
    assert mine.choose_args == ref.choose_args
    assert crushtool.decompile(mine) == jcrush.decompile(ref)


def test_compile_basics():
    m = crushtool.compile_text(SAMPLE_MAP)
    assert set(m.bucket_names) == {"host0", "host1", "default"}
    assert m.max_devices == 4 and m.device_classes == {1: "ssd"}
    assert m.tunables.choose_total_tries == 50
    assert m.rules[1].type == crushtool.POOL_TYPE_ERASURE
    assert m.rules[1].steps[0] == (crushtool.RULE_SET_CHOOSELEAF_TRIES, 5)
    b = m.buckets[m.bucket_names["host0"]]
    assert list(b.items) == [0, 1] and list(b.weights) == [0x10000, 0x20000]


@pytest.mark.parametrize("text", [SAMPLE_MAP, CHOOSE_ARGS_TEXT],
                         ids=["sample", "choose_args"])
def test_decompile_compile_roundtrip_maps_alike(text):
    m1 = crushtool.compile_text(text)
    m2 = crushtool.compile_text(crushtool.decompile(m1))
    assert canonical(crushtool.map_to_json(m2)) == \
        canonical(crushtool.map_to_json(m1))
    ref = jcrush.compile_text(text)
    for ruleno in range(len(m1.rules)):
        for x in range(32):
            want = jcrush.crush_do_rule(ref, ruleno, x, 3)
            assert crushtool.crush_do_rule(m2, ruleno, x, 3) == want


def test_weight_sets_roundtrip_through_text():
    """tests/test_map_tools.py:250: compile -> decompile -> compile keeps
    choose_args exact (the %.6f text recovers 16.16 under round)."""
    maps = []
    for cmap in (jcmap, pcmap):
        rng = np.random.default_rng(51)
        weights = rng.integers(0x10000, 3 * 0x10000, size=6,
                               dtype=np.uint32)
        m = cmap.CrushMap()
        m.type_names = {"osd": 0, "host": 1, "root": 2}
        hosts = [m.add_bucket("straw2", 1, [2 * h, 2 * h + 1],
                              [int(weights[2 * h]), int(weights[2 * h + 1])],
                              id=-2 - h, name="host%d" % h)
                 for h in range(3)]
        m.add_bucket("straw2", 2, hosts, [0x10000] * 3, id=-1,
                     name="default")
        m.choose_args[0] = {
            -1: {"ids": [11, 12, 13],
                 "weight_set": [[0x18000, 0x10000, 0x2ABCD],
                                [0x10000, 0x20000, 0x00001]]},
            -2: {"ids": None, "weight_set": [[0x8000, 0x1777]]}}
        maps.append(m)
    text = crushtool.decompile(maps[1])
    assert text == jcrush.decompile(maps[0])
    assert "choose_args 0 {" in text
    assert crushtool.compile_text(text).choose_args == maps[1].choose_args
    assert crushtool.map_from_json(crushtool.map_to_json(
        maps[1])).choose_args == maps[1].choose_args


@pytest.mark.parametrize("bad", [
    "tunable bogus 1",
    "tunable choose_total_tries",
    "device 0 osd.1",
    "device 0",
    "type host",
    "rule r {\nstep fly\n}",
    "rule r {\nsize 3\n}",
    "rule r {\ntype sideways\n}",
    "rule r {\nstep take nowhere\n}",
    "type 1 host\nrule r {\nstep choose firstn 0 type rack\n}",
    "type 1 host\nrule r {\nstep choose sometimes 0 type host\n}",
    "rule r {\nstep emit\n",
    "type 1 host\nhost h {\nitem osd.0\nalg nope\n}",
    "type 1 host\nhost h {\nid -1\nalg straw2\n",
    "type 1 host\nhost h {\nhash 2\n}",
    "type 1 host\nhost h {\nitem other\n}",
    "type 1 host\nhost h {\nitem osd.0 weight\n}",
    "type 1 host\nhost h {\ncolour blue\n}",
    "choose_args 0\n",
    "choose_args 0 {\nbucket_id -1\n}",
    "choose_args 0 {\n{\nweight_set [ [ 1.0 ]\n",
    "choose_args 0 {\n{\nweight_set [ [ 1.0 ] ] x\n}\n}",
    "choose_args 0 {\n{\nids [ 1 ]\n}\n}",
    "choose_args 0 {\n{\nbucket_id -1\nflavour x\n}\n}",
    "choose_args 0 {\n{\nbucket_id -1\n}\n",
    "cookie jar",
])
def test_compile_errors_match_reference(bad):
    with pytest.raises(jcrush.CompileError) as ref:
        jcrush.compile_text(bad)
    with pytest.raises(crushtool.CompileError) as mine:
        crushtool.compile_text(bad)
    assert str(mine.value) == str(ref.value)


def test_decompile_refuses_an_unknown_step():
    m = crushtool.compile_text(SAMPLE_MAP)
    m.rules[0].steps.append(("sideways", 1))
    with pytest.raises(crushtool.CompileError, match="cannot decompile"):
        crushtool.decompile(m)


# -- crushtool: build, test and the CLI ---------------------------------------

def test_build_and_tester_reports_match_reference():
    layers = [("host", "straw2", 2), ("root", "straw2", 0)]
    ref, mine = jcrush.build_map(8, layers), crushtool.build_map(8, layers)
    assert crushtool.map_to_json(mine) == jcrush.map_to_json(ref)
    ref, mine = compile_both(SAMPLE_MAP)
    for rule, rep, batched in ((0, 2, False), (1, 4, False), (1, 4, True)):
        c_ref, r_ref = jcrush.run_test(ref, rule, rep, 0, 63)
        c, r = crushtool.run_test(mine, rule, rep, 0, 63, batched=batched,
                                  device="cpu")
        assert r == r_ref and list(c) == list(c_ref)
        assert crushtool.format_test_report(
            mine, c, r, rule, rep, show_utilization=True) == \
            jcrush.format_test_report(ref, c_ref, r_ref, rule, rep,
                                      show_utilization=True)


def _cli(tool, argv, capsys):
    capsys.readouterr()
    rc = tool.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_crushtool_cli_matches_reference(tmp_path, capsys):
    src = tmp_path / "map.txt"
    src.write_text(CHOOSE_ARGS_TEXT)
    got = {}
    for tool in (jcrush, crushtool):
        name = tool.__name__.replace(".", "_")
        cmp_file = tmp_path / ("%s.json" % name)
        assert tool.main(["-c", str(src), "-o", str(cmp_file)]) == 0
        got[tool] = [cmp_file.read_text(),
                     _cli(tool, ["-d", str(cmp_file)], capsys),
                     _cli(tool, ["-i", str(cmp_file), "--test", "--rule",
                                 "0", "--num-rep", "2", "--max-x", "63",
                                 "--show-utilization"], capsys),
                     _cli(tool, ["-d", str(tmp_path / "nope.json")],
                          capsys)[0],
                     _cli(tool, ["-c", str(tmp_path / "map.json")],
                          capsys)[0]]
    assert got[crushtool] == got[jcrush]
    assert got[crushtool][1][0] == 0 and "step take default" in \
        got[crushtool][1][1]
    assert got[crushtool][3] == got[crushtool][4] == 1


def test_compile_error_through_the_cli(tmp_path, capsys):
    src = tmp_path / "bad.txt"
    src.write_text("rule r {\nstep fly\n}\n")
    assert _cli(crushtool, ["-c", str(src)], capsys)[:2] == (1, "")
    assert _cli(jcrush, ["-c", str(src)], capsys)[:2] == (1, "")


# -- osdmaptool ---------------------------------------------------------------

def test_createsimple_and_json_match_reference():
    for args in ((8, 64, 3, 4), (6, 32, 3, 0), (5, 16, 2, 5)):
        ref = jtool.create_simple(*args)
        mine = osdmaptool.create_simple(*args)
        assert osdmaptool.osdmap_to_json(mine) == jtool.osdmap_to_json(ref)
    doc = json.loads(json.dumps(jtool.osdmap_to_json(ref)))
    doc["pg_upmap"] = {"0.3": [1, 2]}
    doc["pg_upmap_items"] = {"0.a": [[0, 4]]}
    back = osdmaptool.osdmap_from_json(doc)
    assert osdmaptool.osdmap_to_json(back) == \
        jtool.osdmap_to_json(jtool.osdmap_from_json(doc))
    assert back.pg_upmap_items == {PGID(0, 10): [(0, 4)]}
    assert rows(back, PORT, pools=(0,)) == \
        rows(jtool.osdmap_from_json(doc), REF, pools=(0,))


@pytest.mark.parametrize("batched,pool", [(False, None), (True, None),
                                          (True, 1), (True, 7)])
def test_test_map_pgs_report_matches_reference(batched, pool):
    maps = [build_map(mods, pg_num=64) for mods in (REF, PORT)]
    for m in maps:
        m.pools[1].pgp_num = 48
    want = jtool.test_map_pgs(maps[0], pool_filter=pool)
    assert osdmaptool.test_map_pgs(maps[1], pool_filter=pool,
                                   batched=batched, device="cpu") == want


def test_test_map_object_matches_reference():
    maps = [build_map(mods, pg_num=16) for mods in (REF, PORT)]
    for name in ("foo", "rbd_header.1", "obj-17", ""):
        assert osdmaptool.test_map_object(maps[1], name, 1) == \
            jtool.test_map_object(maps[0], name, 1)


def test_upmap_balances_like_reference():
    ref = jtool.create_simple(5, pg_num=32, pool_size=2, hosts=5)
    mine = osdmaptool.create_simple(5, pg_num=32, pool_size=2, hosts=5)
    a = jtool.calc_pg_upmaps(ref, max_changes=6, use_device=False)
    b = osdmaptool.calc_pg_upmaps(mine, max_changes=6, device="cpu")
    assert b.num_changed == a.num_changed > 0
    assert {(p.pool, p.ps): v for p, v in b.new_pg_upmap_items.items()} == \
        {(p.pool, p.ps): v for p, v in a.new_pg_upmap_items.items()}
    for r, m, mods in ((a, ref, REF), (b, mine, PORT)):
        inc = mods[1].Incremental(m.epoch + 1)
        r.apply_to(inc)
        m.apply_incremental(inc)
    mapping = osdmaptool.OSDMapMapping()
    mapping.update(mine, device="cpu")
    want = jtool.OSDMapMapping()
    want.update(ref, batched=False)
    assert by_pg(mapping) == by_pg(want)


def test_osdmaptool_cli_flow_matches_reference(tmp_path, capsys):
    outs = {}
    for tool in (jtool, osdmaptool):
        mapfile = tmp_path / ("%s.json" % tool.__name__.replace(".", "_"))
        seq = [["--createsimple", "8", str(mapfile), "--pg-num", "32"],
               [str(mapfile), "--print"],
               [str(mapfile), "--test-map-pgs"],
               [str(mapfile), "--test-map-object", "foo", "--pool", "0"],
               [str(mapfile), "--test-map-object", "foo"],
               [str(mapfile), "--mark-down", "3", "-o", str(mapfile)],
               [str(mapfile), "--test-map-pgs", "--pool", "0"],
               [],
               [str(tmp_path / "missing.json"), "--print"],
               ["--createsimple", "4"]]
        outs[tool] = [_cli(tool, argv, capsys) for argv in seq]
        for i, (rc, out, err) in enumerate(outs[tool]):
            # the port's usage also lists --device
            err = "usage" if err.startswith("usage:") else err
            outs[tool][i] = (rc, out.replace(str(mapfile), "MAP"),
                             err.replace(str(tmp_path), "TMP"))
    assert outs[osdmaptool][1:] == outs[jtool][1:]
    assert [o[0] for o in outs[osdmaptool]] == [0, 0, 0, 0, 1, 0, 0, 1, 1, 1]
    mine = tmp_path / "ceph_tpu_torch_tools_osdmaptool.json"
    assert _cli(osdmaptool, [str(mine), "--test-map-pgs", "--batched",
                             "--device", "cpu"], capsys) == \
        (0, outs[jtool][6][1], "")


def test_pool_choose_args_index_matches_reference():
    """tests/test_map_tools.py's test_osdmap_pool_choose_args_index: a
    default weight set zeroing osd.0 remaps the pool's PGs off it, base
    weights untouched, on the port's sweep as on the reference's."""
    maps = [build_map(mods, num_hosts=3) for mods in (REF, PORT)]
    for m, cmap in zip(maps, (jcmap, pcmap)):
        m.crush.create_choose_args(cmap.DEFAULT_CHOOSE_ARGS)
        for bid, b in m.crush.buckets.items():
            if 0 in list(b.items):
                m.crush.choose_args_adjust_item_weight(
                    cmap.DEFAULT_CHOOSE_ARGS, bid, 0, 0)
    assert rows(maps[1], PORT) == rows(maps[0], REF)
    mine = osdmaptool.OSDMapMapping()
    mine.update(maps[1], device="cpu")
    want = jtool.OSDMapMapping()
    want.update(maps[0], batched=False)
    assert by_pg(mine) == by_pg(want)
    assert not any(0 in row[0] for row in mine.by_pg.values())
