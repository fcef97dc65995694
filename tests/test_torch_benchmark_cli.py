"""The port's ceph_erasure_code_benchmark on the CPU device.

Same CLI and ``<seconds>\\t<KiB>`` output contract as the reference tool
(ceph_tpu/tools/erasure_code_benchmark.py); on the CPU it is a smoke test.
"""

import re

import pytest

from ceph_tpu_torch.tools import erasure_code_benchmark as bench

from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPORT = re.compile(r"^\d+\.\d{6}\t(\d+)$")


def run(capsys, *argv):
    rc = bench.main(["-p", "torch_cuda", "-P", "k=8", "-P", "m=3",
                     "--device", "cpu", *argv])
    return rc, capsys.readouterr()


@pytest.mark.parametrize("batch", ["1", "4"])
def test_encode_reports_seconds_and_kib(capsys, batch):
    rc, cap = run(capsys, "-s", "65536", "-i", "3", "--batch", batch)
    assert rc == 0, cap.err
    match = REPORT.match(cap.out.strip().splitlines()[-1])
    assert match and int(match.group(1)) == 3 * int(batch) * 64


def test_exhaustive_decode_verifies_every_pattern(capsys):
    rc, cap = run(capsys, "-s", "32768", "-w", "decode", "-E", "exhaustive",
                  "-e", "3", "-i", "1")
    assert rc == 0, cap.err
    assert REPORT.match(cap.out.strip().splitlines()[-1])


BASELINE_CODECS = {
    "cauchy_good": ["-p", "torch_cuda", "-P", "technique=cauchy_good",
                    "-P", "k=10", "-P", "m=4", "-P", "packetsize=64"],
    "lrc": ["-p", "lrc_cuda", "-P", "k=4", "-P", "m=2", "-P", "l=3"],
    "shec": ["-p", "shec_cuda", "-P", "k=8", "-P", "m=4", "-P", "c=3"],
}
DECODES = {"cauchy_good": ["-e", "4"], "lrc": ["--erased", "0", "--erased",
                                                "5"], "shec": ["-e", "2"]}


@pytest.mark.parametrize("batch", ["1", "2"])
@pytest.mark.parametrize("workload", ["encode", "decode"])
@pytest.mark.parametrize("codec", sorted(BASELINE_CODECS))
def test_baseline_codecs_encode_and_decode(capsys, codec, workload, batch):
    """The BASELINE's other codecs through the CLI; a batched decode
    checks every reconstruction against the encoded chunks."""
    argv = [*BASELINE_CODECS[codec], "--device", "cpu", "-s", "65536",
            "-i", "2", "--batch", batch, "-w", workload]
    if workload == "decode":
        argv += DECODES[codec]
    rc = bench.main(argv)
    cap = capsys.readouterr()
    assert rc == 0, cap.err
    match = REPORT.match(cap.out.strip().splitlines()[-1])
    assert match and int(match.group(1)) == 2 * int(batch) * 64


def test_random_decode_and_bad_parameters(capsys):
    rc, cap = run(capsys, "-s", "8192", "-w", "decode", "-e", "2", "-i", "4")
    assert rc == 0 and REPORT.match(cap.out.strip())
    rc = bench.main(["-p", "torch_cuda", "-P", "k=0", "--device", "cpu"])
    assert rc == 1
    assert "k needs to be > 0" in capsys.readouterr().err
