"""A dry run of the multi-device paths, held against one device.

The counterpart of the reference's ``__graft_entry__.dryrun_multichip``
(``__graft_entry__.py:27``): over a mesh of the given devices it runs
the sharded Reed-Solomon k=8, m=3 encode with its checksum, the sharded
decode of a read with rows 1, 5 and 9 erased, and the flat-mesh CRUSH
sweep, each held against the single-device path:

    python -c "from ceph_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(['cuda:0'] * 4)"

``devices`` is a list of devices (which may repeat one) or a count of
visible CUDA devices. Raises AssertionError on any disagreement and
returns a summary.
"""

from __future__ import annotations

import numpy as np

from .. import registry
from ..crush import batched, mapper_ref
from ..crush import map as cmap_mod
from ..crush.map import CrushMap, Rule
from . import mesh as pmesh

__all__ = ["dryrun_multichip"]


def _sweep_map() -> CrushMap:
    """The reference dry run's map: 4 hosts of 3 OSDs, chooseleaf indep 4
    over hosts."""
    cm = CrushMap()
    cm.type_names = {"osd": 0, "host": 1, "root": 2}
    host_ids, host_w = [], []
    for h in range(4):
        items = [h * 3 + i for i in range(3)]
        w = [0x10000 + 0x1000 * i for i in items]
        host_ids.append(cm.add_bucket("straw2", 1, items, w, id=-2 - h))
        host_w.append(sum(w))
    cm.add_bucket("straw2", 2, host_ids, host_w, id=-1, name="default")
    cm.add_rule(Rule(steps=[(cmap_mod.RULE_TAKE, -1),
                            (cmap_mod.RULE_CHOOSELEAF_INDEP, 4, 1),
                            (cmap_mod.RULE_EMIT,)]))
    return cm


def dryrun_multichip(devices) -> dict:
    grid = pmesh.mesh_devices(devices) if isinstance(devices, int) \
        else pmesh.mesh_devices(devices=devices)
    n_devices = grid.size
    mesh = pmesh.make_mesh(devices=list(grid))
    home = grid[0]
    codec = registry.factory(
        "torch_cuda",
        {"technique": "reed_sol_van", "k": "8", "m": "3", "w": "8"},
        device=home)
    a, b = mesh.devices.shape
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(2 * a, 8, 256 * b), dtype=np.uint8)

    parity = pmesh.encode_sharded(codec, data, mesh)
    ref = codec.encode_batch(data)
    np.testing.assert_array_equal(parity, ref)
    checksum = pmesh.mesh_checksum(parity, mesh)
    assert checksum == int(ref.astype(np.uint64).sum()) % (1 << 32)

    full = np.concatenate([data, ref], axis=1)
    avail = (0, 2, 3, 4, 6, 7, 8, 10)     # rows 1, 5, 9 erased
    dec = pmesh.decode_sharded(codec, avail, full[:, list(avail), :], mesh)
    np.testing.assert_array_equal(dec, full)

    cm = _sweep_map()
    reweight = np.full(12, 0x10000, dtype=np.int64)
    xs = np.arange(16 * n_devices)
    flat = batched.make_batch_mesh(devices=list(grid))
    got = batched.mesh_do_rule(cm, 0, xs, 4, reweight, mesh=flat)
    one = batched.batched_do_rule(cm, 0, xs, 4, reweight, device=home)
    np.testing.assert_array_equal(got, one)
    for x in xs[:32]:
        assert list(got[x]) == mapper_ref.crush_do_rule(
            cm, 0, int(x), 4, list(reweight)), x
    return {"n_devices": n_devices, "mesh": dict(mesh.shape),
            "parity": list(parity.shape), "checksum": checksum,
            "decoded": list(dec.shape), "crush_seeds": int(xs.size)}
