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
            "ceph_tpu_torch/registry.py"} <= names


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
