"""Build the port's CUDA sources on first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into
``build/lib<name>.so`` (a plain C interface, no PyTorch headers, so a
build takes seconds) and loaded with :mod:`ctypes`. A library is rebuilt
when its source, or a shared ``csrc/*.cuh`` header, is newer. :func:`build` starts one compiler per stale
source, all at once, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build %s" % CSRC)


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def lib_path(name: str) -> Path:
    return BUILD / ("lib%s.so" % name)


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    ``csrc/*.cuh`` header the sources share."""
    lib = lib_path(name)
    if not lib.exists():
        return True
    inputs = [CSRC / (name + ".cu"), *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build(names=None) -> dict[str, float]:
    """Compile the stale sources among `names` (default: all) in parallel.

    Returns {name: seconds} for the sources compiled; the compiler's
    output (with ptxas' register and spill report) goes to
    ``build/<name>.log``. Raises if any compile fails."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = BUILD / ("lib%s.so.%d.tmp" % (name, os.getpid()))
        log = open(BUILD / (name + ".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / (name + ".cu"))],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    seconds, failed = {}, []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        logs = "\n".join((BUILD / (n + ".log")).read_text() for n in failed)
        raise RuntimeError("nvcc failed for %s:\n%s" % (failed, logs))
    return seconds


def ptxas_report(name: str) -> dict[str, dict]:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads",
    "stack", "smem"}} from ptxas' report in ``build/<name>.log``, one
    entry per kernel instantiation; "smem" is its static shared memory in
    bytes."""
    report: dict[str, dict] = {}
    current = None
    for line in (BUILD / (name + ".log")).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = report.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            current.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            current["smem"] = int(m.group(1)) if m else 0
    return report


def launch_failure(lib) -> str:
    """": <text>" of the library's last shared-memory refusal on this
    thread (``launch_common_error``, naming the sizes), or ""."""
    fn = lib.launch_common_error
    fn.restype = ctypes.c_char_p
    text = fn().decode()
    return ": " + text if text else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(lib_path(name)))
        return _libs[name]
