"""The PyTorch port stands alone and never falls back to the CPU by itself.

Every module under ceph_tpu_torch/ and chip_smoke.py is walked as an AST:
no import of jax or of the ceph_tpu package (the port keeps its own
copies). And the entry points that default to CUDA raise on a host
without it instead of running on the CPU.
"""

import ast
import json
import zlib
from pathlib import Path

import pytest
import torch

from ceph_tpu_torch import registry
from ceph_tpu_torch.crush import batched as crush_batched
from ceph_tpu_torch.tools import crushtool
from ceph_tpu_torch.osd import fused_transform
from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher
from ceph_tpu_torch.osd.hbm_tier import HbmChunkTier
from ceph_tpu_torch.tools import erasure_code_benchmark as bench

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "ceph_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
PROFILE = {"technique": "reed_sol_van", "k": "8", "m": "3", "w": "8"}


def forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "ceph_tpu")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and forbidden(node.module):
                bad.append(node.module)
    assert bad == []


def test_the_walk_covers_the_tier_and_its_kernels():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"ceph_tpu_torch/osd/hbm_tier.py",
            "ceph_tpu_torch/ops/digest_kernel.py",
            "ceph_tpu_torch/ops/gf_kernel.py",
            "ceph_tpu_torch/osd/gpu_dispatch.py",
            "ceph_tpu_torch/osd/ec_util.py",
            "ceph_tpu_torch/compressor/__init__.py",
            "ceph_tpu_torch/compressor/base.py",
            "ceph_tpu_torch/compressor/plugins.py",
            "ceph_tpu_torch/compressor/registry.py",
            "ceph_tpu_torch/models/msr.py",
            "ceph_tpu_torch/models/xor_example.py",
            "ceph_tpu_torch/ops/xor_mm.py",
            "ceph_tpu_torch/parallel/__init__.py",
            "ceph_tpu_torch/parallel/dryrun.py",
            "ceph_tpu_torch/parallel/mesh.py",
            "ceph_tpu_torch/parallel/placement.py",
            "ceph_tpu_torch/parallel/rateless.py",
            "ceph_tpu_torch/registry.py",
            "ceph_tpu_torch/osd/osd_map.py",
            "ceph_tpu_torch/osd/balancer.py",
            "ceph_tpu_torch/tools/osdmaptool.py",
            "ceph_tpu_torch/tools/crushtool.py",
            "ceph_tpu_torch/native.py",
            "ceph_tpu_torch/tools/erasure_code.py",
            "ceph_tpu_torch/tools/non_regression.py",
            "ceph_tpu_torch/common/bounded.py",
            "ceph_tpu_torch/common/interval_set.py",
            "ceph_tpu_torch/common/lockdep.py",
            "ceph_tpu_torch/common/workqueue.py",
            "ceph_tpu_torch/store/object_store.py",
            "ceph_tpu_torch/store/faults.py",
            "ceph_tpu_torch/store/mem_store.py",
            "ceph_tpu_torch/osd/pg_transaction.py",
            "ceph_tpu_torch/osd/pg_log.py",
            "ceph_tpu_torch/osd/extent_cache.py",
            "ceph_tpu_torch/osd/ec_transaction.py",
            "ceph_tpu_torch/msg/message.py",
            "ceph_tpu_torch/osd/ec_backend.py",
            "ceph_tpu_torch/encoding.py",
            "ceph_tpu_torch/common/reserver.py",
            "ceph_tpu_torch/osd/replicated_backend.py",
            "ceph_tpu_torch/osd/objclass.py",
            "ceph_tpu_torch/osd/tiering.py",
            "ceph_tpu_torch/osd/pg.py"} <= names


def test_native_build_reads_nothing_of_the_reference():
    """The native build's inputs are native/'s sources and the port's own
    files; its crush_ln header comes from the port's ln_tables.py and
    equals what native/tools/gen_crush_tables.py prints from the
    reference's LL_TBL and RH_LH_TBL."""
    import subprocess
    import sys

    from ceph_tpu_torch import native
    inputs = [p.resolve() for p in native._inputs()]
    assert not [p for p in inputs if (ROOT / "ceph_tpu") in p.parents]
    assert {p.parent for p in inputs} >= {
        ROOT / "native" / "src", ROOT / "ceph_tpu_torch" / "crush"}
    ref = subprocess.run(
        [sys.executable, str(ROOT / "native" / "tools" /
                             "gen_crush_tables.py")],
        capture_output=True, text=True, check=True).stdout
    assert native.ln_tables_header() == ref


def test_two_runtimes_in_one_process_both_orders():
    """Each order in a fresh process: both packages' jerasure codecs
    create and encode alike, each loads its own plugin, each bridge moves
    only its own library's batch count, and the port's library exports
    no symbol of the rename set (each under the port's prefix)."""
    import subprocess
    import sys

    import ceph_tpu.native as ref_native
    from ceph_tpu_torch import native
    native.build()
    ref_native.lib()           # built here, not by both children at once
    script = str(ROOT / "tests" / "torch_native_pair.py")
    procs = {order: subprocess.Popen([sys.executable, script, order],
                                     stdout=subprocess.PIPE, text=True)
             for order in ("ref_first", "port_first")}
    for order, proc in procs.items():
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, order
        got = json.loads(out.strip().splitlines()[-1])
        assert got["port_equals_ref"] and got["port_parity_ok"] and \
            got["ref_parity_ok"], got
        assert got["after_port_bridge"] == [0, 1], got
        assert got["after_ref_bridge"] == [1, 0], got
        assert got["ref_dispatcher_calls"] == 1
        assert got["renamed"] > 0 and got["exported_renamed"] == [] and \
            got["prefixed_missing"] == [], got
        assert got["ref_plugin_mapped"] and got["port_plugin_mapped"], got


def test_forbidden_names():
    assert forbidden("jax.numpy") and forbidden("ceph_tpu.ops.gf")
    assert not forbidden("ceph_tpu_torch.ops.gf")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_factory_without_device_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.factory("torch_cuda", dict(PROFILE))
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.factory("torch_cuda", dict(PROFILE), device="cuda")
    assert registry.factory("torch_cuda", dict(PROFILE),
                            device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("plugin,profile", [
    ("torch_cuda", {"technique": "cauchy_good", "k": "10", "m": "4",
                    "packetsize": "2048"}),
    ("shec_cuda", {"k": "8", "m": "4", "c": "3"}),
    ("lrc_cuda", {"k": "4", "m": "2", "l": "3"}),
    ("msr_cuda", {"k": "8", "m": "7"}),
], ids=["cauchy_good", "shec_cuda", "lrc_cuda", "msr_cuda"])
def test_new_codecs_without_device_raise(no_cuda, plugin, profile):
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.factory(plugin, dict(profile))
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.factory(plugin, dict(profile), device="cuda")
    codec = registry.factory(plugin, dict(profile), device="cpu")
    assert codec.device == torch.device("cpu")
    for layer in getattr(codec, "layers", ()):
        assert layer.codec.device == torch.device("cpu")


def test_dispatcher_without_device_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        GpuDispatcher()


def test_device_crc32_without_device_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_transform.device_crc32(b"scrub")
    assert fused_transform.device_crc32(b"scrub", device="cpu") == \
        zlib.crc32(b"scrub")


def test_benchmark_without_device_fails(no_cuda, capsys):
    assert bench.main(["-P", "k=8", "-P", "m=3"]) == 1
    assert "CUDA" in capsys.readouterr().err


def test_crush_sweep_without_device_raises(no_cuda, tmp_path, capsys):
    m = crushtool.build_map(16, [("host", "straw2", 4), ("root", "straw2", 0)])
    m.add_simple_rule("rep", "default", "host")
    with pytest.raises(RuntimeError, match="CUDA"):
        crush_batched.batched_do_rule(m, 0, [1, 2, 3], 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        crush_batched.batched_do_rule(m, 0, [1, 2, 3], 3, device="cuda")
    assert crush_batched.batched_do_rule(m, 0, [1, 2, 3], 3,
                                         device="cpu").shape == (3, 3)
    path = tmp_path / "map.json"
    path.write_text(json.dumps(crushtool.map_to_json(m)))
    assert crushtool.main(["-i", str(path), "--test", "--batched"]) == 1
    assert "CUDA" in capsys.readouterr().err


def test_tier_without_device_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        HbmChunkTier()
    with pytest.raises(RuntimeError, match="CUDA"):
        HbmChunkTier(device="cuda")
    assert HbmChunkTier(device="cpu").stats()["device"] == "cpu:0"


def test_mesh_and_rateless_without_device_raise(no_cuda):
    """No device given means the cards: with none, every multi-device
    entry point raises, and the process-global pieces stand down."""
    from ceph_tpu_torch.parallel import dryrun, mesh, placement, rateless
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh(devices=["cuda"] * 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        crush_batched.make_batch_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        rateless.RatelessDispatcher()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(2)
    m = crushtool.build_map(16, [("host", "straw2", 4), ("root", "straw2", 0)])
    m.add_simple_rule("rep", "default", "host")
    with pytest.raises(RuntimeError, match="CUDA"):
        crush_batched.mesh_do_rule(m, 0, [1, 2, 3], 3)
    assert placement.PLACEMENT.resolve(0) is None
    placement.PLACEMENT.forget(0)
    assert rateless.get_dispatcher(create=False) is None


def test_placement_control_plane_without_device_raises(no_cuda, tmp_path,
                                                       capsys):
    """The full remap, the balancer and osdmaptool --batched default to
    the card: without CUDA they raise (or the CLI fails), and only
    device="cpu" takes the plain version."""
    from ceph_tpu_torch.osd import balancer
    from ceph_tpu_torch.osd.osd_map import OSDMapMapping
    from ceph_tpu_torch.tools import osdmaptool
    m = osdmaptool.create_simple(8, pg_num=16, hosts=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        OSDMapMapping().update(m)
    with pytest.raises(RuntimeError, match="CUDA"):
        OSDMapMapping().update(m, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        balancer.calc_pg_upmaps(m, max_changes=1)
    mapping = OSDMapMapping()
    mapping.update(m, device="cpu")
    assert len(mapping.by_pg) == 16
    path = tmp_path / "map.json"
    path.write_text(json.dumps(osdmaptool.osdmap_to_json(m)))
    capsys.readouterr()
    assert osdmaptool.main([str(path), "--test-map-pgs", "--batched"]) == 1
    assert "CUDA" in capsys.readouterr().err
    assert osdmaptool.main([str(path), "--upmap", str(tmp_path / "u.txt"),
                            "--batched"]) == 1
    assert "CUDA" in capsys.readouterr().err
    assert osdmaptool.main([str(path), "--test-map-pgs", "--batched",
                            "--device", "cpu"]) == 0
