"""CRUSH maps shared by the port's CPU tests, built in either package's
classes (``mod`` is ``ceph_tpu.crush.map`` or ``ceph_tpu_torch.crush.map``,
``mod_crushtool`` either package's ``tools.crushtool``), so that the port
and the JAX package map the same map.
"""

import numpy as np

SEEDS = np.arange(256)


def bench_map(mod):
    """bench.py:820 _crush_bench_map, with a second rule (firstn, 3)."""
    rng = np.random.default_rng(7070)
    weights = rng.integers(0x8000, 3 * 0x10000, size=32, dtype=np.uint32)
    m = mod.CrushMap()
    m.type_names = {"osd": 0, "host": 1, "root": 2}
    hids, hw = [], []
    for h in range(8):
        items = [h * 4 + i for i in range(4)]
        w = [int(weights[i]) for i in items]
        hids.append(m.add_bucket("straw2", 1, items, w, id=-2 - h))
        hw.append(sum(w))
    m.add_bucket("straw2", 2, hids, hw, id=-1, name="default")
    m.add_rule(mod.Rule(steps=[(mod.RULE_TAKE, -1),
                               (mod.RULE_CHOOSELEAF_INDEP, 5, 1),
                               (mod.RULE_EMIT,)]))
    m.add_rule(mod.Rule(steps=[(mod.RULE_TAKE, -1),
                               (mod.RULE_CHOOSELEAF_FIRSTN, 3, 1),
                               (mod.RULE_EMIT,)]))
    return m


def bench_reweight(kind):
    w = np.full(32, 0x10000, dtype=np.int64)
    w[3] = 0
    if kind == "half":
        w[9] = 0x8000
        w[17] = 0x8000
    if kind == "short":
        w = w[:29]              # devices 29-31 past the vector: out
    return w


def cluster_map(mod_crushtool):
    m = mod_crushtool.build_map(1024, [("host", "straw2", 16),
                                       ("rack", "straw2", 8),
                                       ("root", "straw2", 0)])
    m.add_simple_rule("ec", "default", "host", mode="indep")
    m.add_simple_rule("rep", "default", "host")
    return m


def cluster_reweight():
    w = np.full(1024, 0x10000, dtype=np.int64)
    w[::97] = 0
    w[5::89] = 0x8000
    return w
