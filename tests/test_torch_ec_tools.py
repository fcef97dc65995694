"""The port's ceph_erasure_code and ceph_erasure_code_non_regression CLIs
against the JAX package's.

``ceph_tpu_torch.tools.erasure_code`` / ``non_regression`` against
``ceph_tpu.tools.erasure_code`` / ``non_regression`` on the cases of
tests/test_tools.py (``TestProbeTool``, ``TestNonRegression``): the
same stdout lines and exit codes, the reference's ``jax_tpu`` standing
beside the port's ``torch_cuda`` on ``--device cpu``. A corpus written by
one package's ``--create`` passes the other's ``--check``: ``jerasure``
in both packages, and ``torch_cuda`` on the CPU against the reference's
``jerasure`` (the descriptor directory copied to the other plugin's
name, since it names the plugin). Tolerance: none.
"""

import shutil

import pytest
import torch

from ceph_tpu.tools import erasure_code as jec
from ceph_tpu.tools import non_regression as jnr
from ceph_tpu_torch.tools import erasure_code as pec
from ceph_tpu_torch.tools import non_regression as pnr

from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = ["--device", "cpu"]
RS = ["technique=reed_sol_van", "k=2", "m=2"]


def run(main, argv, capsys):
    capsys.readouterr()
    code = main(argv)
    out = capsys.readouterr()
    return code, out.out, out.err


# -- ceph_erasure_code --------------------------------------------------------

@pytest.mark.parametrize("ref_plugin,plugin", [
    ("jerasure", "jerasure"), ("jax_tpu", "torch_cuda"), ("shec", "shec"),
    ("no_such_plugin", "no_such_plugin")])
def test_plugin_exists(capsys, ref_plugin, plugin):
    ref = run(jec.main, ["--plugin_exists", ref_plugin], capsys)
    mine = run(pec.main, ["--plugin_exists", plugin], capsys)
    assert mine[:2] == ref[:2]
    if plugin == "no_such_plugin":
        assert mine[0] != 0 and "libec_no_such_plugin" in mine[2]


@pytest.mark.parametrize("args", [
    ["--all", "-P", "plugin=jerasure"] + [a for p in RS for a in ("-P", p)],
    ["--get_chunk_size", "4096", "--get_chunk_count", "-P",
     "plugin=jerasure", "-P", "technique=cauchy_good", "-P", "k=4", "-P",
     "m=2", "-P", "packetsize=64"],
    ["--get_data_chunk_count", "--get_coding_chunk_count", "-P",
     "plugin=shec", "-P", "k=4", "-P", "m=3", "-P", "c=2"],
    ["--all", "-P", "plugin=lrc", "-P", "k=4", "-P", "m=2", "-P", "l=3"],
    ["--all"],
], ids=["all_rs", "chunk_size_cauchy", "counts_shec", "all_lrc",
        "plugin_mandatory"])
def test_display_matches_reference(capsys, args):
    ref = run(jec.main, args, capsys)
    mine = run(pec.main, args + CPU, capsys)
    assert mine[:2] == ref[:2]
    if args == ["--all"]:
        assert mine[0] == 1 and "plugin=<plugin> is mandatory" in mine[2]


def test_display_card_plugin_like_reference(capsys):
    params = ["-P", "technique=reed_sol_van", "-P", "k=8", "-P", "m=3"]
    ref = run(jec.main, ["--all", "-P", "plugin=jax_tpu"] + params, capsys)
    mine = run(pec.main, ["--all", "-P", "plugin=torch_cuda"] + params + CPU,
               capsys)
    assert mine[:2] == ref[:2] and ref[0] == 0
    assert "get_chunk_count\t11" in mine[1]


def test_card_plugin_needs_cuda_unless_cpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, out, err = run(pec.main, ["--all", "-P", "plugin=torch_cuda",
                                    "-P", "k=8", "-P", "m=3"], capsys)
    assert code == 1 and out == "" and "CUDA" in err


# -- ceph_erasure_code_non_regression -----------------------------------------

PROFILES = [
    ("jerasure", "jerasure", RS),
    ("jerasure", "jerasure", ["technique=cauchy_good", "k=4", "m=2",
                              "packetsize=64"]),
    ("jax_tpu", "torch_cuda", ["technique=reed_sol_van", "k=8", "m=3"]),
    ("shec", "shec", ["k=4", "m=3", "c=2"]),
    ("lrc", "lrc", ["k=4", "m=2", "l=3"]),
]


def nr_argv(plugin, params, base, width=3181):
    argv = ["--plugin", plugin, "--base", str(base), "--stripe-width",
            str(width)]
    for p in params:
        argv += ["--parameter", p]
    return argv


@pytest.mark.parametrize("plugin,params", [(p, q) for _, p, q in PROFILES],
                         ids=[p[1] + "_" + p[2][0] for p in PROFILES])
def test_create_then_check(tmp_path, plugin, params, capsys):
    argv = nr_argv(plugin, params, tmp_path) + CPU
    assert run(pnr.main, argv + ["--create"], capsys)[:2] == (0, "")
    assert run(pnr.main, argv + ["--check"], capsys)[:2] == (0, "")


def test_default_plugin_is_the_card(tmp_path, capsys):
    args = pnr.build_parser().parse_args([])
    assert (args.plugin, args.device) == ("torch_cuda", "cuda")
    argv = ["--base", str(tmp_path), "--stripe-width", "3181",
            "-P", "k=2", "-P", "m=1"] + CPU
    assert run(pnr.main, argv + ["--create"], capsys)[:2] == (0, "")
    assert [d.name for d in tmp_path.iterdir()] == [
        "plugin=torch_cuda stripe-width=3181 k=2 m=1"]


def _descriptor(nr_mod, argv):
    return nr_mod.NonRegression(nr_mod.build_parser().parse_args(argv))


@pytest.mark.parametrize("writer,checker", [
    ("ref:jerasure", "port:jerasure"), ("port:jerasure", "ref:jerasure"),
    ("ref:jerasure", "port:torch_cuda"), ("port:torch_cuda", "ref:jerasure")])
@pytest.mark.parametrize("params", [["technique=reed_sol_van", "k=8",
                                     "m=3"], RS], ids=["k8m3", "k2m2"])
def test_corpus_crosses_packages(tmp_path, capsys, writer, checker, params):
    mods = {"ref": (jnr, []), "port": (pnr, CPU)}
    (wpkg, wplugin), (cpkg, cplugin) = (s.split(":") for s in (writer,
                                                             checker))
    wmod, wextra = mods[wpkg]
    cmod, cextra = mods[cpkg]
    wargv = nr_argv(wplugin, params, tmp_path)
    cargv = nr_argv(cplugin, params, tmp_path)
    assert run(wmod.main, wargv + wextra + ["--create"], capsys)[0] == 0
    src = _descriptor(wmod, wargv).directory
    dst = _descriptor(cmod, cargv).directory
    if src != dst:
        shutil.copytree(src, dst)
    assert run(cmod.main, cargv + cextra + ["--check"], capsys)[:2] == (0, "")


@pytest.mark.parametrize("case", ["corrupt", "no_corpus", "create_twice",
                                  "neither"])
def test_failures_match_reference(tmp_path, capsys, case):
    outs = []
    for mod, extra in ((jnr, []), (pnr, CPU)):
        base = tmp_path / mod.__name__
        argv = nr_argv("jerasure", RS, base, width=4096) + extra
        if case == "corrupt":
            assert mod.main(argv + ["--create"]) == 0
            path = _descriptor(mod, argv).chunk_path(1)
            buf = bytearray(open(path, "rb").read())
            buf[0] ^= 0xFF
            open(path, "wb").write(bytes(buf))
            outs.append(run(mod.main, argv + ["--check"], capsys))
        elif case == "no_corpus":
            outs.append(run(mod.main, argv + ["--check"], capsys))
        elif case == "create_twice":
            assert mod.main(argv + ["--create"]) == 0
            outs.append(run(mod.main, argv + ["--create"], capsys))
        else:
            outs.append(run(mod.main, argv, capsys))
    ref, mine = outs
    assert mine[:2] == ref[:2] and mine[0] == 1
    frag = {"corrupt": "chunk 1 encodes differently",
            "no_corpus": "FileNotFoundError",
            "create_twice": "FileExistsError",
            "neither": "must specifify either --check, or --create"}[case]
    assert frag in ref[2] and frag in mine[2]
