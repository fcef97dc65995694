"""The port's MSR codec inside the JAX package's MiniCluster.

A reference-side plugin, ``msr_cuda_port``, builds the port's
``msr_cuda`` codec (``device="cpu"``, the GF kernel's plain version) for
the reference's ECBackend, so an EC pool's writes, reads and scrub repair
run the port's encode, decode and beta-fraction repair, and the
reference's ``msr`` pool of the same profile is the comparison. One
cluster serves the module.
"""

from __future__ import annotations

import numpy as np
import pytest

from ceph_tpu import registry as jregistry
from ceph_tpu_torch import registry
from ceph_tpu_torch.models.msr import MsrProductMatrix

from .cluster_util import MiniCluster, wait_until
from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PLUGIN = "msr_cuda_port"
FAST = {"osd_heartbeat_interval": 0.1, "osd_heartbeat_grace": 0.6,
        "mon_osd_down_out_interval": 1.0,
        "paxos_propose_interval": 0.02,
        # the helper-fraction rebuild, not the resident fast path
        "osd_hbm_tier_enable": False}


class _PortMsrPlugin(jregistry.ErasureCodePlugin):
    """The reference registry's face of the port's msr_cuda."""

    def factory(self, profile, errors=None):
        return registry.factory("msr_cuda", profile, errors, device="cpu")


PROFILE = {"plugin": PLUGIN, "technique": "msr", "k": "3", "m": "2"}


def _register_once():
    reg = jregistry.ErasureCodePluginRegistry.instance()
    if reg.get(PLUGIN) is None:
        reg.add(PLUGIN, _PortMsrPlugin())
    # the first build imports and caches what the monitor's own builds
    # would otherwise pay for inside its command handler
    jregistry.factory(PLUGIN, dict(PROFILE))


def _wait_quiet_map(cluster, settle=10):
    """Waits until the monitor's OSD map has no pending incremental and
    its epoch held still for `settle` polls. The reference monitor
    numbers a new incremental from the committed epoch
    (``OSDMonitor._pend``), so a pool created while another incremental
    is in flight (the profile's, proposed 20 ms after its command
    returned) gets that one's epoch and is skipped at commit; and it
    fills the pending incremental after building the codec, which the
    proposal timer may encode first. So each command waits for a quiet
    map, and the codec's first build happens before the cluster's."""
    mon = cluster.mons[0]
    last, still = -1, 0

    def quiet():
        nonlocal last, still
        epoch = mon.osdmon.osdmap.epoch
        still = still + 1 if epoch == last and \
            not mon.osdmon.have_pending() else 0
        last = epoch
        return still >= settle

    assert wait_until(quiet, interval=0.05), "the OSD map never settled"


@pytest.fixture(scope="module")
def cluster():
    _register_once()
    c = MiniCluster(num_mons=1, num_osds=5, conf_overrides=FAST).start()
    try:
        client = c.client()
        _wait_quiet_map(c)
        res, outs, _ = client.mon_command({
            "prefix": "osd erasure-code-profile set",
            "name": "portmsr-profile", "profile": dict(PROFILE)})
        assert res == 0, outs
        _wait_quiet_map(c)
        res, outs, _ = client.mon_command({
            "prefix": "osd pool create", "pool": "portmsr",
            "pool_type": "erasure",
            "erasure_code_profile": "portmsr-profile", "pg_num": 4})
        assert res == 0, outs
        c._wait_pool(client, "portmsr")
        yield c, client
    finally:
        c.stop()


def _ec_target(client, pool_name, oid):
    m = client.osdmap
    pool_id = client.pool_id(pool_name)
    pgid = m.pools[pool_id].raw_pg_to_pg(m.object_to_pg(pool_id, oid))
    _, _, acting, primary = m.pg_to_up_acting_osds(pgid)
    return pgid, acting, primary


def _repair_counters(cluster):
    out = {"read": 0, "shipped": 0, "saved": 0}
    for osd in cluster.osds.values():
        for lane in out:
            out[lane] += osd.perf.get("l_osd_repair_bytes_" + lane)
    return out


def test_pool_codec_is_the_port(cluster):
    c, client = cluster
    pgid, acting, primary = _ec_target(client, "portmsr", "probe")
    osd = c.osds[primary]
    assert wait_until(lambda: pgid in osd.pgs), "pg %s never created" % pgid
    codec = osd.pgs[pgid].backend.codec
    assert isinstance(codec, MsrProductMatrix)
    assert codec.device.type == "cpu" and codec.d == 4


@pytest.mark.parametrize("size", [1, 4095, 40000, 262144])
def test_round_trip(cluster, size):
    _, client = cluster
    ioctx = client.open_ioctx("portmsr")
    payload = bytes(np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8))
    oid = "obj%d" % size
    ioctx.write_full(oid, payload)
    assert ioctx.read(oid) == payload


def test_scrub_repair_heals_bitrot_through_fractions(cluster):
    """Bit-rot one shard; scrub repair rebuilds it from d = 4 helper
    fractions of chunk/alpha bytes each, computed by the port's codec
    (shipped × alpha == read)."""
    c, client = cluster
    ioctx = client.open_ioctx("portmsr")
    payload = bytes(np.random.default_rng(5).integers(
        0, 256, 40000, dtype=np.uint8))
    ioctx.write_full("mobj", payload)
    pgid, acting, primary = _ec_target(client, "portmsr", "mobj")
    victim = c.osds[acting[1]]
    cid = ("pg", str(pgid), 1)
    good = victim.store.read(cid, "mobj")
    before = _repair_counters(c)
    victim.store.faults.mark_bitrot(cid, "mobj")

    osd = c.osds[primary]
    pg = osd.pgs[pgid]
    assert osd.scrub_pg(pgid, deep=True, repair=True)
    assert wait_until(
        lambda: pg.scrub_stats.get("state") == "clean"
        and pg.scrub_stats.get("repaired", 0) >= 1, 30), pg.scrub_stats
    assert wait_until(lambda: victim.store.read(cid, "mobj") == good, 15)
    assert ioctx.read("mobj") == payload

    after = _repair_counters(c)
    shipped = after["shipped"] - before["shipped"]
    alpha = 2                      # k=3
    assert shipped > 0
    assert after["read"] - before["read"] == shipped * alpha
    assert after["saved"] - before["saved"] > 0
