"""CRUSH map model: buckets, rules, tunables.

The port's copy of ``ceph_tpu/crush/map.py`` (pure Python and numpy,
unchanged). A compact in-memory rendition of struct crush_map (Ceph's
src/crush/crush.h) plus the pieces of CrushWrapper the
framework needs (named buckets/types, add_simple_rule for
ErasureCode.create_rule — CrushWrapper.h:1433, ErasureCode.cc:55-74).
Weights are 16.16 fixed point throughout, like the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

CRUSH_ITEM_UNDEF = 0x7FFFFFFE
CRUSH_ITEM_NONE = 0x7FFFFFFF

ALG_UNIFORM = 1
ALG_LIST = 2
ALG_TREE = 3
ALG_STRAW = 4
ALG_STRAW2 = 5
ALGS = {"uniform": ALG_UNIFORM, "list": ALG_LIST, "tree": ALG_TREE,
        "straw": ALG_STRAW, "straw2": ALG_STRAW2}

# rule step ops (crush.h:55-69)
RULE_TAKE = "take"
RULE_CHOOSE_FIRSTN = "choose_firstn"
RULE_CHOOSE_INDEP = "choose_indep"
RULE_CHOOSELEAF_FIRSTN = "chooseleaf_firstn"
RULE_CHOOSELEAF_INDEP = "chooseleaf_indep"
RULE_EMIT = "emit"
RULE_SET_CHOOSE_TRIES = "set_choose_tries"
RULE_SET_CHOOSELEAF_TRIES = "set_chooseleaf_tries"
RULE_SET_CHOOSE_LOCAL_TRIES = "set_choose_local_tries"
RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES = "set_choose_local_fallback_tries"
RULE_SET_CHOOSELEAF_VARY_R = "set_chooseleaf_vary_r"
RULE_SET_CHOOSELEAF_STABLE = "set_chooseleaf_stable"

POOL_TYPE_REPLICATED = 1
POOL_TYPE_ERASURE = 3


def weight_fixed(w: float) -> int:
    """float weight -> 16.16 fixed point."""
    return int(round(w * 0x10000))


@dataclass
class Bucket:
    id: int                    # negative
    alg: str
    type: int
    items: np.ndarray          # int32 item ids (devices >= 0, buckets < 0)
    weights: np.ndarray        # uint32 16.16 per item
    hash: int = 0              # CRUSH_HASH_RJENKINS1

    def __post_init__(self):
        self.items = np.asarray(self.items, dtype=np.int64)
        self.weights = np.asarray(self.weights, dtype=np.int64)
        assert self.id < 0
        assert len(self.items) == len(self.weights)

    @property
    def size(self) -> int:
        return len(self.items)

    @property
    def weight(self) -> int:
        return int(self.weights.sum())

    @property
    def sum_weights(self) -> np.ndarray:
        """Cumulative weights for list buckets (crush.h list bucket)."""
        return np.cumsum(self.weights)


@dataclass
class Rule:
    steps: list
    name: str = ""
    type: int = POOL_TYPE_REPLICATED
    min_size: int = 1
    max_size: int = 10


@dataclass
class Tunables:
    """Jewel-era optimal tunables (the reference's defaults for new maps)."""
    choose_total_tries: int = 50
    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1


#: choose_args set id the mapping falls back to when a pool-specific
#: set is absent (CrushWrapper::DEFAULT_CHOOSE_ARGS)
DEFAULT_CHOOSE_ARGS = -1


@dataclass
class CrushMap:
    buckets: dict = field(default_factory=dict)      # id -> Bucket
    rules: list = field(default_factory=list)
    tunables: Tunables = field(default_factory=Tunables)
    bucket_names: dict = field(default_factory=dict)  # name -> id
    type_names: dict = field(default_factory=dict)    # name -> type id
    device_classes: dict = field(default_factory=dict)  # device id -> class
    # choose_args sets (crush.h:273-292 crush_choose_arg_map; the
    # Luminous balancer's weight-set mechanism): set id -> {bucket_id
    # -> {"ids": [int]|None, "weight_set": [[w 16.16]*size]*positions}}
    choose_args: dict = field(default_factory=dict)

    @property
    def max_devices(self) -> int:
        mx = -1
        for b in self.buckets.values():
            devs = b.items[b.items >= 0]
            if devs.size:
                mx = max(mx, int(devs.max()))
        return mx + 1

    @property
    def max_buckets(self) -> int:
        return max((-1 - bid for bid in self.buckets), default=-1) + 1

    def add_bucket(self, alg: str, type: int, items, weights,
                   id: int | None = None, name: str | None = None) -> int:
        if id is None:
            id = -1
            while id in self.buckets:
                id -= 1
        if id in self.buckets:
            raise ValueError("bucket id %d exists" % id)
        if alg not in ALGS:
            raise ValueError("unknown bucket alg %r" % alg)
        self.buckets[id] = Bucket(id=id, alg=alg, type=type,
                                  items=items, weights=weights)
        if name is not None:
            self.bucket_names[name] = id
        return id

    def choose_args_get_with_fallback(self, index) -> dict | None:
        """CrushWrapper::choose_args_get_with_fallback — pool set if
        present, else the default set, else no substitution."""
        args = self.choose_args.get(index)
        if args is None:
            args = self.choose_args.get(DEFAULT_CHOOSE_ARGS)
        return args

    def create_choose_args(self, index: int, positions: int = 1) -> dict:
        """CrushWrapper::create_choose_args: weight-sets seeded from
        every straw2 bucket's base weights — the balancer then adjusts
        copies without touching the base weights."""
        args = self.choose_args.setdefault(index, {})
        for bid, b in self.buckets.items():
            if b.alg != "straw2" or bid in args:
                continue
            args[bid] = {"ids": None,
                         "weight_set": [[int(w) for w in b.weights]
                                        for _ in range(positions)]}
        return args

    def _parent_of(self, child_id: int) -> int | None:
        for bid, b in self.buckets.items():
            if child_id in [int(i) for i in b.items]:
                return bid
        return None

    def choose_args_adjust_item_weight(self, index: int, bucket_id: int,
                                       item: int, weights) -> None:
        """Set item's weight in the bucket's weight-set and propagate
        the bucket's new per-position totals into every ancestor's
        weight-set (CrushWrapper::choose_args_adjust_item_weightf
        walks the parents the same way): the balancer's write path.

        weights: an int applies to EVERY position; a list sets one
        weight per position (growing the weight-set as needed)."""
        args = self.choose_args.setdefault(index, {})

        def entry(bid, npos):
            arg = args.setdefault(bid, {"ids": None,
                                        "weight_set": None})
            b = self.buckets[bid]
            if arg["weight_set"] is None:
                arg["weight_set"] = [[int(w) for w in b.weights]
                                     for _ in range(npos)]
            while len(arg["weight_set"]) < npos:
                arg["weight_set"].append(list(arg["weight_set"][-1]))
            return arg

        b = self.buckets[bucket_id]
        pos = list(b.items).index(item)
        if isinstance(weights, int):
            npos = len((args.get(bucket_id) or {}).get("weight_set")
                       or [0])
            weights = [weights] * max(npos, 1)
        arg = entry(bucket_id, len(weights))
        for p, w in enumerate(weights):
            arg["weight_set"][p][pos] = int(w)
        # ancestors: the adjusted bucket's per-position totals replace
        # its weight in each parent's weight-set, recursively
        child = bucket_id
        while True:
            parent = self._parent_of(child)
            if parent is None:
                break
            totals = [sum(row) for row in args[child]["weight_set"]]
            parg = entry(parent, len(totals))
            cpos = [int(i) for i in self.buckets[parent].items
                    ].index(child)
            for p, t in enumerate(totals):
                parg["weight_set"][p][cpos] = int(t)
            child = parent

    def add_rule(self, rule: Rule) -> int:
        self.rules.append(rule)
        return len(self.rules) - 1

    def rule_by_name(self, name: str) -> int | None:
        for i, r in enumerate(self.rules):
            if r.name == name:
                return i
        return None

    def add_simple_rule(self, name: str, root_name: str,
                        failure_domain: str = "", device_class: str = "",
                        mode: str = "firstn",
                        rule_type: int = POOL_TYPE_REPLICATED) -> int:
        """take root -> choose(leaf) over failure domain -> emit
        (CrushWrapper::add_simple_rule semantics; ErasureCode.create_rule
        passes mode="indep" and TYPE_ERASURE)."""
        if self.rule_by_name(name) is not None:
            raise FileExistsError(name)
        if root_name not in self.bucket_names:
            raise KeyError("root %s does not exist" % root_name)
        if device_class:
            raise NotImplementedError("device-class shadow trees not yet")
        root = self.bucket_names[root_name]
        steps = [(RULE_TAKE, root)]
        if failure_domain:
            ftype = self.type_names[failure_domain]
            op = (RULE_CHOOSELEAF_FIRSTN if mode == "firstn"
                  else RULE_CHOOSELEAF_INDEP)
            steps.append((op, 0, ftype))
        else:
            op = (RULE_CHOOSE_FIRSTN if mode == "firstn"
                  else RULE_CHOOSE_INDEP)
            steps.append((op, 0, 0))
        steps.append((RULE_EMIT,))
        return self.add_rule(Rule(steps=steps, name=name, type=rule_type))
