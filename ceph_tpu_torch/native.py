"""ctypes bindings for the native C++ runtime, built by the port.

Port of ``ceph_tpu/native.py``, the Python<->C++ seam: the runtime in
``native/`` carries the dlopen plugin registry and the CPU codecs
(``native/src/registry.cc``, ``matrix_codec.cc``), the GF region kernels
with their runtime ISA dispatch (``gf.cc``), the host CRUSH mapper
(``crush.cc``) and the batching bridge that coalesces native threads'
encode calls into one device batch (``tpu_bridge.cc``). This module
builds it, drives codecs through its flat C API
(``native/include/ectpu/c_api.h``), runs the host mapper over the port's
``crush.map.CrushMap``, and installs a dispatcher into the bridge that
runs each batch as one ``torch_cuda`` ``encode_batch`` on the card.

The build (:func:`build`) compiles ``native/``'s sources, read-only, into
``ceph_tpu_torch/build/native/`` with the C++ compiler (``$CXX``, else
``c++`` or ``g++``), one process a source, all at once: the core
``libectpu_torch.so``, the ``jerasure`` plugin, the four broken-plugin
fixtures and ``ec_benchmark``. ``crush_ln_tables.gen.h`` is generated
from the port's own ``crush/ln_tables.py``.

The reference's copy of the same runtime may be loaded in the same
process, with ``RTLD_GLOBAL``, and its plugins register through a global
symbol (``ectpu_registry_add``). So the port's copy is kept apart: its
own file name and SONAME, ``-Wl,-Bsymbolic`` on the core, every symbol
that a plugin, fixture or ``ec_benchmark`` imports from the core renamed
in every object with ``objcopy --redefine-syms`` (the set computed with
``nm``; the two entry points the registry looks up with ``dlsym`` on a
plugin's handle keep their names), a version script that exports only the
C API and the renamed symbols, and the core opened ``RTLD_LOCAL``.
``lib()`` resolves the C API through the renames, so each package's
calls, codecs and bridge reach only its own runtime.
"""

from __future__ import annotations

import ctypes
import errno
import fcntl
import os
import shutil
import subprocess
import threading
import time
import weakref
import zlib
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "build" / "native"
LIB_NAME = "libectpu_torch.so"
LIB_PATH = BUILD_DIR / LIB_NAME
RENAMES_PATH = BUILD_DIR / "renamed_symbols.txt"
SYMBOL_PREFIX = "ectpu_torch_"
# native/Makefile's CXXFLAGS (no -march: gf.cc picks its ISA at load)
CXXFLAGS = ["-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-pthread"]
CORE_SOURCES = ("gf", "erasure_code", "matrix_codec", "registry",
                "tpu_bridge", "c_api", "crush")
FIXTURES = ("missing_version", "missing_entry_point", "fail_to_initialize",
            "fail_to_register")
# looked up with dlsym on the plugin's own handle (registry.cc): never
# renamed
DLSYM_NAMES = frozenset({"__erasure_code_init", "__erasure_code_version"})

_lib = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# the build


def _units() -> dict[str, tuple[Path, str]]:
    """{object stem: (source, artifact)}: the core's objects map to the
    core library, each plugin and fixture to its libec_<name>.so."""
    units = {"core_" + n: (NATIVE_DIR / "src" / (n + ".cc"), LIB_NAME)
             for n in CORE_SOURCES}
    units["jerasure"] = (NATIVE_DIR / "plugins" / "ec_jerasure.cc",
                         "libec_jerasure.so")
    for name in FIXTURES:
        units[name] = (NATIVE_DIR / "test_fixtures" / ("ec_%s.cc" % name),
                       "libec_%s.so" % name)
    units["ec_benchmark"] = (NATIVE_DIR / "tools" / "ec_benchmark.cc",
                             "ec_benchmark")
    return units


def _inputs() -> list[Path]:
    from .crush import ln_tables
    return [src for src, _ in _units().values()] + \
        sorted((NATIVE_DIR / "include" / "ectpu").glob("*.h")) + \
        [Path(ln_tables.__file__), Path(__file__)]


def artifacts() -> list[Path]:
    """Every file the build leaves in :data:`BUILD_DIR`."""
    names = sorted({art for _, art in _units().values()})
    return [BUILD_DIR / n for n in names] + [RENAMES_PATH]


def _stale() -> bool:
    outs = artifacts()
    if not all(p.exists() for p in outs):
        return True
    newest_in = max(p.stat().st_mtime for p in _inputs())
    return min(p.stat().st_mtime for p in outs) < newest_in


def ln_tables_header() -> str:
    """``crush_ln_tables.gen.h`` from the port's ``crush/ln_tables.py``:
    the text ``native/tools/gen_crush_tables.py`` prints."""
    from .crush.ln_tables import LL_TBL, RH_LH_TBL
    lines = ["/* generated by tools/gen_crush_tables.py -- do not edit */"]
    for name, arr in (("CRUSH_RH_LH_TBL", RH_LH_TBL),
                      ("CRUSH_LL_TBL", LL_TBL)):
        lines.append("static const long long %s[%d] = {" % (name, len(arr)))
        vals = ["%dLL" % int(v) for v in arr]
        for i in range(0, len(vals), 4):
            lines.append("  " + ", ".join(vals[i:i + 4]) + ",")
        lines.append("};")
    return "\n".join(lines) + "\n"


def _tool(env: str | None, *names: str) -> str:
    cand = os.environ.get(env) if env else None
    for name in ((cand,) if cand else ()) + names:
        path = shutil.which(name)
        if path:
            return path
    raise NativeUnavailable("no %s found to build the native runtime"
                            % " or ".join(((cand,) if cand else ()) + names))


def _run_all(cmds: dict[str, list[str]], work: Path, what: str) -> None:
    """Run every command at once; raise NativeUnavailable with the logs
    of those that failed."""
    procs = {}
    for name, cmd in cmds.items():
        log = open(work / ("%s.%s.log" % (name, what)), "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log)
    failed = []
    for name, (proc, log) in procs.items():
        if proc.wait() != 0:
            failed.append(name)
        log.close()
    if failed:
        logs = "\n".join("%s: %s\n%s" % (n, " ".join(cmds[n]), (
            work / ("%s.%s.log" % (n, what))).read_text()) for n in failed)
        raise NativeUnavailable("native %s failed for %s:\n%s"
                                % (what, failed, logs))


def _symbols(nm: str, obj: Path, flag: str) -> set[str]:
    out = subprocess.run([nm, flag, str(obj)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise NativeUnavailable("nm %s %s failed:\n%s"
                                % (flag, obj, out.stderr))
    return {line.split()[-1] for line in out.stdout.splitlines()
            if line.strip()}


def rename_set(nm: str, objects: dict[str, Path]) -> list[str]:
    """The symbols that the plugins, fixtures and ec_benchmark import and
    the core defines, without the two the registry finds by dlsym."""
    defined, imported = set(), set()
    for stem, obj in objects.items():
        if stem.startswith("core_"):
            defined |= _symbols(nm, obj, "--defined-only")
        else:
            imported |= _symbols(nm, obj, "--undefined-only")
    return sorted((defined & imported) - DLSYM_NAMES)


def _build_into(work: Path) -> dict:
    cxx = _tool("CXX", "c++", "g++")
    objcopy = _tool(None, "objcopy")
    nm = _tool(None, "nm")
    include = str(NATIVE_DIR / "include")
    (work / "crush_ln_tables.gen.h").write_text(ln_tables_header())
    units = _units()
    objects = {stem: work / (stem + ".o") for stem in units}
    t0 = time.perf_counter()
    _run_all({stem: [cxx, *CXXFLAGS, "-I" + include, "-I" + str(work), "-c",
                     str(src), "-o", str(objects[stem])]
              for stem, (src, _) in units.items()}, work, "compile")
    t_compile = time.perf_counter() - t0
    renames = rename_set(nm, objects)
    table = work / "redefine.txt"
    table.write_text("".join("%s %s%s\n" % (s, SYMBOL_PREFIX, s)
                             for s in renames))
    _run_all({stem: [objcopy, "--redefine-syms=" + str(table), str(obj)]
              for stem, obj in objects.items()}, work, "objcopy")
    # the core exports its C API and the renamed symbols, nothing else
    script = work / "exports.map"
    script.write_text("{\n  global:\n    ec_*;\n    %s*;\n  local: *;\n};\n"
                      % SYMBOL_PREFIX)
    core_objs = [str(objects["core_" + n]) for n in CORE_SOURCES]
    _run_all({"core": [cxx, *CXXFLAGS, "-shared", *core_objs, "-o",
                       str(work / LIB_NAME), "-ldl",
                       "-Wl,-soname," + LIB_NAME, "-Wl,-Bsymbolic",
                       "-Wl,--version-script=" + str(script)]},
             work, "link")
    linked = {}
    for stem, (_, art) in units.items():
        if stem.startswith("core_"):
            continue
        shared = [] if art == "ec_benchmark" else ["-shared"]
        linked[stem] = [cxx, *CXXFLAGS, *shared, str(objects[stem]), "-o",
                        str(work / art), "-L" + str(work), "-lectpu_torch",
                        "-Wl,-rpath,$ORIGIN"]
    _run_all(linked, work, "link")
    (work / RENAMES_PATH.name).write_text("".join(s + "\n" for s in renames))
    return {"seconds": time.perf_counter() - t0, "compile_s": t_compile,
            "renamed": len(renames), "compiler": cxx}


def build() -> dict | None:
    """Build the runtime into :data:`BUILD_DIR` when any input is newer
    than an artifact. Several processes may call it at
    once: an ``fcntl`` lock makes one build and the others wait, and each
    artifact is moved into place with ``os.replace``. Returns the build's
    {"seconds", "compile_s", "renamed", "compiler"}, or None when every
    artifact was up to date. Raises NativeUnavailable when a tool is
    missing or fails, with its log."""
    if not _stale():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not _stale():
                return None
            work = BUILD_DIR / (".work.%d" % os.getpid())
            shutil.rmtree(work, ignore_errors=True)
            work.mkdir()
            try:
                info = _build_into(work)
                for art in artifacts():
                    os.replace(work / art.name, art)
            finally:
                shutil.rmtree(work, ignore_errors=True)
            return info
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def renamed_symbols() -> list[str]:
    """The symbols the build renamed (each exported as
    ``SYMBOL_PREFIX + name``)."""
    return RENAMES_PATH.read_text().split()


class _Runtime:
    """The loaded core: an attribute is the C function of that name, or of
    its renamed name where the build renamed it."""

    def __init__(self, cdll: ctypes.CDLL, renames):
        self._cdll = cdll
        self._renames = {s: SYMBOL_PREFIX + s for s in renames}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        fn = getattr(self._cdll, self._renames.get(name, name))
        setattr(self, name, fn)
        return fn


def lib() -> _Runtime:
    """The port's runtime, built first if stale, opened ``RTLD_LOCAL``.
    ``CDLL`` (not ``PyDLL``): every call releases the GIL, which the
    bridge's collector thread needs to run its Python callback."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            build()
            L = _Runtime(ctypes.CDLL(str(LIB_PATH), mode=ctypes.RTLD_LOCAL),
                         renamed_symbols())
            _configure_symbols(L)
            _lib = L
    return _lib


def _configure_symbols(L) -> None:
    L.ec_codec_create.restype = ctypes.c_void_p
    L.ec_codec_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_size_t]
    L.ec_codec_destroy.argtypes = [ctypes.c_void_p]
    L.ec_codec_k.argtypes = [ctypes.c_void_p]
    L.ec_codec_m.argtypes = [ctypes.c_void_p]
    L.ec_codec_chunk_size.restype = ctypes.c_uint
    L.ec_codec_chunk_size.argtypes = [ctypes.c_void_p, ctypes.c_uint]
    L.ec_codec_profile.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    L.ec_codec_chunk_mapping.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    L.ec_codec_minimum_to_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    L.ec_codec_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
    L.ec_codec_encode_chunks.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
    L.ec_codec_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_char_p]
    L.ec_codec_decode_chunks.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    for name in ("ec_tpu_batches_dispatched", "ec_tpu_requests_dispatched"):
        getattr(L, name).restype = ctypes.c_uint64
    L.ec_tpu_register_dispatcher.argtypes = [
        _DISPATCH_CFUNC, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32]
    L.ec_tpu_register_dispatcher.restype = None
    L.ec_tpu_unregister_dispatcher.restype = None
    L.ec_tpu_encode.argtypes = [ctypes.POINTER(_ECRequest)]
    L.ec_gf_isa.restype = ctypes.c_char_p
    L.ec_gf_isa.argtypes = []
    L.ec_gf_set_isa.argtypes = [ctypes.c_char_p]
    L.ec_gf_region_madd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
        ctypes.c_size_t, ctypes.c_int]
    LL = ctypes.POINTER(ctypes.c_longlong)
    L.ec_crush_ln.restype = ctypes.c_longlong
    L.ec_crush_ln.argtypes = [ctypes.c_uint]
    L.ec_crush_hash32_2.restype = ctypes.c_uint
    L.ec_crush_hash32_2.argtypes = [ctypes.c_uint] * 2
    L.ec_crush_hash32_3.restype = ctypes.c_uint
    L.ec_crush_hash32_3.argtypes = [ctypes.c_uint] * 3
    L.ec_crush_map_create.restype = ctypes.c_void_p
    L.ec_crush_map_create.argtypes = [LL, LL, LL, LL, ctypes.c_int, LL, LL]
    L.ec_crush_map_destroy.argtypes = [ctypes.c_void_p]
    L.ec_crush_do_rule_map.restype = ctypes.c_int
    L.ec_crush_do_rule_map.argtypes = [
        ctypes.c_void_p, LL, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    L.ec_crush_do_rule_batch.restype = ctypes.c_int
    L.ec_crush_do_rule_batch.argtypes = [
        ctypes.c_void_p, LL, ctypes.c_int,
        LL, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    L.ec_crush_map_set_choose_args.restype = ctypes.c_int
    L.ec_crush_map_set_choose_args.argtypes = [
        ctypes.c_void_p, LL, ctypes.c_int, LL, LL, LL, LL, LL]
    L.ec_crush_map_clear_choose_args.argtypes = [ctypes.c_void_p]


# ---------------------------------------------------------------------------
# GF region kernels' ISA dispatch (runtime cpuid selection in gf.cc)


def gf_isa() -> str:
    """The ISA the GF region kernels are dispatched to: 'avx2' | 'ssse3'
    | 'scalar'."""
    return lib().ec_gf_isa().decode()


def gf_set_isa(name: str) -> bool:
    """Force a lower-or-equal kernel ISA; False if unknown or unsupported
    on this host. Process-global (for the port's runtime)."""
    return lib().ec_gf_set_isa(name.encode()) == 0


def gf_region_madd(dst, src, g: int, w: int = 8) -> None:
    """dst[i] ^= g * src[i] through the dispatched native kernel; dst and
    src are equal-length contiguous uint8 numpy arrays, dst mutated."""
    if not (isinstance(dst, np.ndarray) and dst.flags["C_CONTIGUOUS"]):
        raise ValueError("dst must be a contiguous ndarray (mutated "
                         "in place)")
    src = np.ascontiguousarray(src)
    if dst.nbytes != src.nbytes:
        raise ValueError("dst/src length mismatch")
    r = lib().ec_gf_region_madd(
        dst.ctypes.data, src.ctypes.data, g, dst.nbytes, w)
    if r != 0:
        raise ValueError("gf_region_madd failed: %d" % r)


# ---------------------------------------------------------------------------
# the host CRUSH mapper (ectpu::crush_do_rule_flat over a serialized map)

_STEP_OPS = {
    "take": 1, "choose_firstn": 2, "choose_indep": 3, "emit": 4,
    "chooseleaf_firstn": 6, "chooseleaf_indep": 7,
    "set_choose_tries": 8, "set_chooseleaf_tries": 9,
    "set_choose_local_tries": 10, "set_choose_local_fallback_tries": 11,
    "set_chooseleaf_vary_r": 12, "set_chooseleaf_stable": 13,
}
_ALGS = {"uniform": 1, "list": 2, "straw2": 5}
_LLp = ctypes.POINTER(ctypes.c_longlong)


def _map_fingerprint(cmap) -> int:
    """crc32 over everything placement-visible: bucket ids, algs, types,
    item and weight vectors (order-sensitive), rule steps; the tunables
    ride with each call."""
    crc = 0
    for bid in sorted(cmap.buckets):
        b = cmap.buckets[bid]
        crc = zlib.crc32(("%d|%s|%d" % (b.id, b.alg, b.type)).encode(), crc)
        crc = zlib.crc32(b.items.tobytes(), crc)
        crc = zlib.crc32(b.weights.tobytes(), crc)
    for rule in cmap.rules:
        crc = zlib.crc32(repr(rule.steps).encode(), crc)
    return crc


class _NativeMapHandle:
    """Owns one C-side map (ec_crush_map_create / destroy)."""

    def __init__(self, L, flat):
        self._L = L
        self._cargs_crc = None
        self.ptr = L.ec_crush_map_create(
            flat["bids"].ctypes.data_as(_LLp),
            flat["algs"].ctypes.data_as(_LLp),
            flat["types"].ctypes.data_as(_LLp),
            flat["offs"].ctypes.data_as(_LLp),
            len(flat["bids"]),
            flat["items"].ctypes.data_as(_LLp),
            flat["weights"].ctypes.data_as(_LLp))
        if not self.ptr:
            raise NativeUnavailable("native crush rejected the map")

    def __del__(self):
        ptr, self.ptr = getattr(self, "ptr", None), None
        if ptr:
            try:
                self._L.ec_crush_map_destroy(ptr)
            except Exception:
                pass


# Kept off the map object (a handle holding the library would make the
# map un-deepcopyable), keyed by id() with a weakref finalizer evicting
# the entry when the map dies, and checked against the map's fingerprint.
_flat_cache: dict = {}


def _flatten_map(cmap, L):
    """Serialize a CrushMap once: flat arrays and a persistent C-side map
    handle, invalidated by a content crc over buckets, items, weights and
    rules."""
    key = id(cmap)
    fingerprint = _map_fingerprint(cmap)
    cached = _flat_cache.get(key)
    if cached is not None and cached[0] == fingerprint:
        return cached[1]
    bids, algs, types, offs = [], [], [], [0]
    items, weights = [], []
    for bid in sorted(cmap.buckets):
        b = cmap.buckets[bid]
        if b.alg not in _ALGS:
            raise NativeUnavailable(
                "native crush does not support bucket alg %r" % b.alg)
        bids.append(b.id)
        algs.append(_ALGS[b.alg])
        types.append(b.type)
        items.extend(int(i) for i in b.items)
        weights.extend(int(w) for w in b.weights)
        offs.append(len(items))
    rule_steps = []
    for rule in cmap.rules:
        steps = []
        for step in rule.steps:
            op = _STEP_OPS.get(step[0])
            if op is None:
                raise NativeUnavailable(
                    "native crush does not support step %r" % (step[0],))
            steps.extend([op, int(step[1]) if len(step) > 1 else 0,
                          int(step[2]) if len(step) > 2 else 0])
        rule_steps.append(np.asarray(steps, dtype=np.int64))

    def arr(vals):
        return np.asarray(vals, dtype=np.int64)

    flat = {"bids": arr(bids), "algs": arr(algs), "types": arr(types),
            "offs": arr(offs), "items": arr(items),
            "weights": arr(weights), "rule_steps": rule_steps}
    flat["handle"] = _NativeMapHandle(L, flat)
    if key not in _flat_cache:
        weakref.finalize(cmap, _flat_cache.pop, key, None)
    _flat_cache[key] = (fingerprint, flat)
    return flat


def _apply_choose_args(L, handle, cmap, choose_args) -> None:
    """Install (or clear) a choose_args set on the C-side map, skipped
    when the handle already carries the same set (content crc)."""
    if isinstance(choose_args, int):
        choose_args = cmap.choose_args_get_with_fallback(choose_args)
    if not choose_args:
        if handle._cargs_crc is not None:
            L.ec_crush_map_clear_choose_args(handle.ptr)
            handle._cargs_crc = None
        return
    crc = zlib.crc32(repr(sorted(
        (bid, (arg or {}).get("ids"), (arg or {}).get("weight_set"))
        for bid, arg in choose_args.items())).encode())
    if handle._cargs_crc == crc:
        return
    bids, ids_flat, ids_offs = [], [], [0]
    ws_flat, ws_offs, ws_pos = [], [0], []
    for bid in sorted(choose_args):
        arg = choose_args[bid] or {}
        if bid not in cmap.buckets:
            continue
        bids.append(bid)
        ids = arg.get("ids")
        if ids:
            ids_flat.extend(int(i) for i in ids)
        ids_offs.append(len(ids_flat))
        ws = arg.get("weight_set")
        if ws:
            for row in ws:
                ws_flat.extend(int(w) for w in row)
            ws_pos.append(len(ws))
        else:
            ws_pos.append(0)
        ws_offs.append(len(ws_flat))

    def arr(v):
        return np.asarray(v if v else [0], dtype=np.int64)

    keep = [arr(v) for v in (bids, ids_flat, ids_offs, ws_flat, ws_offs,
                             ws_pos)]
    rc = L.ec_crush_map_set_choose_args(
        handle.ptr, keep[0].ctypes.data_as(_LLp), len(bids),
        *[a.ctypes.data_as(_LLp) for a in keep[1:]])
    if rc != 0:
        raise NativeUnavailable("native crush rejected choose_args")
    handle._cargs_crc = crc


def _rule_call_args(cmap, ruleno, weight, choose_args):
    L = lib()
    flat = _flatten_map(cmap, L)
    _apply_choose_args(L, flat["handle"], cmap, choose_args)
    if weight is None:
        weight = [0x10000] * cmap.max_devices
    t = cmap.tunables
    tun = np.asarray([t.choose_total_tries, t.choose_local_tries,
                      t.choose_local_fallback_tries,
                      t.chooseleaf_descend_once, t.chooseleaf_vary_r,
                      t.chooseleaf_stable], dtype=np.int32)
    return (L, flat, flat["rule_steps"][ruleno],
            np.asarray(weight, dtype=np.uint32), tun)


def crush_do_rule_native(cmap, ruleno: int, x: int, result_max: int,
                         weight=None, choose_args=None) -> list[int]:
    """One rule through the native mapper; the contract (and the result)
    of ``crush.mapper_ref.crush_do_rule``. Raises NativeUnavailable for
    bucket algs or steps the native side does not implement."""
    if ruleno < 0 or ruleno >= len(cmap.rules):
        return []
    L, flat, steps, rw, tun = _rule_call_args(cmap, ruleno, weight,
                                              choose_args)
    res = np.zeros(max(result_max, 1), dtype=np.int32)
    n = L.ec_crush_do_rule_map(
        flat["handle"].ptr, steps.ctypes.data_as(_LLp), len(steps) // 3,
        x, result_max,
        rw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)), len(rw),
        tun.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        res.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if n < 0:
        raise NativeUnavailable("native crush rejected the map (%d)" % n)
    return [int(v) for v in res[:n]]


def crush_do_rule_batch_arrays(cmap, ruleno: int, xs, result_max: int,
                               weight=None, choose_args=None):
    """Every seed of `xs` in one C call, as arrays: ``results`` int32
    ``[len(xs), max(result_max, 1)]`` (zero past a row's length),
    ``lengths`` int32 ``[len(xs)]``, and the C call's own wall seconds
    (the mapper alone, without the arguments' marshalling)."""
    L, flat, steps, rw, tun = _rule_call_args(cmap, ruleno, weight,
                                              choose_args)
    a_xs = np.ascontiguousarray(xs, dtype=np.int64)
    results = np.zeros((len(a_xs), max(result_max, 1)), dtype=np.int32)
    lengths = np.zeros(len(a_xs), dtype=np.int32)
    t0 = time.perf_counter()
    rc = L.ec_crush_do_rule_batch(
        flat["handle"].ptr, steps.ctypes.data_as(_LLp), len(steps) // 3,
        a_xs.ctypes.data_as(_LLp), len(a_xs), result_max,
        rw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)), len(rw),
        tun.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        results.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    mapper_s = time.perf_counter() - t0
    if rc < 0:
        raise NativeUnavailable("native crush batch failed (%d)" % rc)
    return results, lengths, mapper_s


def crush_do_rule_batch_native(cmap, ruleno: int, xs, result_max: int,
                               weight=None, choose_args=None):
    """Every seed of `xs` in one C call (the host side of Ceph's
    ParallelPGMapper): a list of per-seed result lists, each equal to
    ``crush_do_rule``'s."""
    if ruleno < 0 or ruleno >= len(cmap.rules):
        return [[] for _ in xs]
    results, lengths, _ = crush_do_rule_batch_arrays(
        cmap, ruleno, list(xs), result_max, weight, choose_args)
    return [row[:n].tolist() for row, n in zip(results, lengths.tolist())]


# ---------------------------------------------------------------------------
# the native codec


class NativeCodec:
    """A codec instance living in the port's native runtime."""

    def __init__(self, plugin: str, profile: dict,
                 directory: str | os.PathLike = BUILD_DIR):
        L = lib()
        kv = " ".join("%s=%s" % (k, v) for k, v in profile.items())
        err = ctypes.create_string_buffer(512)
        self._h = L.ec_codec_create(plugin.encode(),
                                    os.fsencode(directory), kv.encode(),
                                    err, 512)
        if not self._h:
            raise OSError(err.value.decode() or "codec create failed")
        self._L = L
        self.k = L.ec_codec_k(self._h)
        self.m = L.ec_codec_m(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._L.ec_codec_destroy(self._h)
            self._h = None

    def get_profile(self) -> dict:
        buf = ctypes.create_string_buffer(4096)
        self._L.ec_codec_profile(self._h, buf, 4096)
        return dict(line.split("=", 1)
                    for line in buf.value.decode().splitlines()
                    if "=" in line)

    def get_chunk_size(self, object_size: int) -> int:
        return self._L.ec_codec_chunk_size(self._h, object_size)

    def chunk_mapping(self) -> list:
        arr = (ctypes.c_int * (self.k + self.m))()
        self._L.ec_codec_chunk_mapping(self._h, arr)
        return list(arr)

    def minimum_to_decode(self, want, avail) -> list:
        w = (ctypes.c_int * len(want))(*want)
        a = (ctypes.c_int * len(avail))(*avail)
        out = (ctypes.c_int * (self.k + self.m))()
        nmin = ctypes.c_int()
        r = self._L.ec_codec_minimum_to_decode(
            self._h, w, len(want), a, len(avail), out, ctypes.byref(nmin))
        if r:
            raise OSError(-r, os.strerror(-r))
        return list(out[: nmin.value])

    def encode(self, data: bytes) -> dict:
        bs = self.get_chunk_size(len(data))
        n = self.k + self.m
        out = ctypes.create_string_buffer(n * bs)
        r = self._L.ec_codec_encode(self._h, data, len(data), out)
        if r:
            raise OSError(-r, os.strerror(-r))
        raw = out.raw
        return {i: raw[i * bs:(i + 1) * bs] for i in range(n)}

    def encode_chunks(self, data, parity) -> None:
        """Chunk-level encode without copies: `data` a C-contiguous uint8
        [k, blocksize] array, `parity` a writable [m, blocksize]."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if not parity.flags["C_CONTIGUOUS"]:
            raise ValueError("parity must be C-contiguous")
        r = self._L.ec_codec_encode_chunks(
            self._h, data.ctypes.data_as(ctypes.c_char_p),
            parity.ctypes.data_as(ctypes.c_char_p), data.shape[1])
        if r:
            raise OSError(-r, os.strerror(-r))

    def decode_chunks(self, avail_rows, chunks, out) -> None:
        """Reconstruction of all k+m rows: `chunks` is [len(avail_rows),
        blocksize] (ascending logical rows), `out` a writable
        [k+m, blocksize]."""
        chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
        if not out.flags["C_CONTIGUOUS"]:
            raise ValueError("out must be C-contiguous")
        rows = (ctypes.c_int * len(avail_rows))(*avail_rows)
        r = self._L.ec_codec_decode_chunks(
            self._h, rows, len(avail_rows),
            chunks.ctypes.data_as(ctypes.c_void_p), chunks.shape[1],
            out.ctypes.data_as(ctypes.c_void_p))
        if r:
            raise OSError(-r, os.strerror(-r))

    def decode(self, available: dict, want=None) -> dict:
        ids = sorted(available)
        bs = len(available[ids[0]])
        if any(len(available[i]) != bs for i in ids):
            # the C side reads navail * blocksize contiguous bytes
            raise ValueError("all available chunks must be equal length")
        if want is None:
            want = list(range(self.k + self.m))
        a = (ctypes.c_int * len(ids))(*ids)
        w = (ctypes.c_int * len(want))(*want)
        chunks = b"".join(available[i] for i in ids)
        out = ctypes.create_string_buffer(len(want) * bs)
        r = self._L.ec_codec_decode(self._h, a, len(ids), chunks, bs, w,
                                    len(want), out)
        if r:
            raise OSError(-r, os.strerror(-r))
        raw = out.raw
        return {wid: raw[j * bs:(j + 1) * bs] for j, wid in enumerate(want)}


# ---------------------------------------------------------------------------
# the batching bridge's dispatcher on the card

_DISPATCH_CFUNC = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_uint32, ctypes.c_void_p)
# every thunk ever installed stays alive (the collector thread copies the
# function pointer and calls it unlocked, so a replaced thunk may still be
# running); the last one is the bridge's dispatcher
_installed_dispatchers: list = []


class _ECRequest(ctypes.Structure):
    _fields_ = [
        ("k", ctypes.c_uint32), ("m", ctypes.c_uint32),
        ("w", ctypes.c_uint32),
        ("technique", ctypes.c_char_p),
        ("blocksize", ctypes.c_uint64),
        ("data", ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))),
        ("parity", ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))),
    ]


class _BridgeDispatch:
    """One batch of the bridge as one ``torch_cuda`` ``encode_batch``: the
    requests' k data chunks gathered by ``memmove`` into one pinned
    [count, k, blocksize] tensor, one upload, one GF kernel launch, the
    parity back into pinned memory, a synchronise, and each parity row
    moved to its request. On "cpu" the same steps run the plain version
    in host memory."""

    def __init__(self, device):
        import torch

        from .device import resolve_device
        self.torch = torch
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.codecs: dict = {}
        self.batches = 0
        self.error = ""            # the last failed batch's exception
        # host seconds of the batches' stages: the gather into the staging
        # tensor, the device leg (upload, kernel, download, synchronise),
        # the scatter of the parity
        self.seconds = {"gather": 0.0, "device": 0.0, "scatter": 0.0}

    def codec(self, r0):
        from . import registry
        key = (r0.k, r0.m, r0.w, r0.technique)
        codec = self.codecs.get(key)
        if codec is None:
            codec = self.codecs[key] = registry.factory("torch_cuda", {
                "technique": (r0.technique or b"reed_sol_van").decode(),
                "k": str(r0.k), "m": str(r0.m), "w": str(r0.w)},
                device=self.device)
        return codec

    def __call__(self, reqs_ptr, count, _user) -> int:
        try:
            self.run(ctypes.cast(
                reqs_ptr, ctypes.POINTER(_ECRequest * count)).contents)
            return 0
        except Exception as e:        # every request of the batch fails
            self.error = "%s: %s" % (type(e).__name__, e)
            return -errno.EIO

    def run(self, reqs) -> None:
        torch = self.torch
        r0 = reqs[0]
        codec = self.codec(r0)
        k, m, bs = int(r0.k), int(r0.m), int(r0.blocksize)
        count = len(reqs)
        t0 = time.perf_counter()
        host = torch.empty((count, k, bs), dtype=torch.uint8,
                           pin_memory=self.cuda)
        base = host.data_ptr()
        for i, req in enumerate(reqs):
            for j in range(k):
                ctypes.memmove(base + (i * k + j) * bs, req.data[j], bs)
        t1 = time.perf_counter()
        if self.cuda:
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                parity = codec.encode_batch(
                    host.to(self.device, non_blocking=True))
                out = torch.empty(parity.shape, dtype=torch.uint8,
                                  pin_memory=True)
                out.copy_(parity, non_blocking=True)
                self.stream.synchronize()
        else:
            out = codec.encode_batch(host)
        t2 = time.perf_counter()
        out = out.contiguous()
        base = out.data_ptr()
        for i, req in enumerate(reqs):
            for j in range(m):
                ctypes.memmove(req.parity[j], base + (i * m + j) * bs, bs)
        self.batches += 1
        for stage, t in (("gather", t1 - t0), ("device", t2 - t1),
                         ("scatter", time.perf_counter() - t2)):
            self.seconds[stage] += t


def install_cuda_dispatcher(max_batch: int = 64, max_delay_us: int = 200,
                            *, device=None) -> _BridgeDispatch:
    """Register the card's encode dispatcher into the native bridge
    (counterpart of the reference's ``install_jax_dispatcher``).

    Native threads calling ``ec_tpu_encode`` block while the bridge
    coalesces concurrent requests (up to `max_batch`, waiting up to
    `max_delay_us` for more); each homogeneous batch runs as one
    ``torch_cuda`` ``encode_batch`` on `device` (None: the card, raising
    where CUDA is absent; "cpu": the plain version). A failed batch
    returns -EIO to every request in it, and no path computes the parity
    on the host instead. Returns the dispatcher (its ``batches``,
    ``codecs``, per-stage host ``seconds`` and last ``error``)."""
    dispatch = _BridgeDispatch(device)
    L = lib()
    thunk = _DISPATCH_CFUNC(dispatch)
    _installed_dispatchers.append((thunk, dispatch))
    L.ec_tpu_register_dispatcher(thunk, None, max_batch, max_delay_us)
    return dispatch


def uninstall_dispatcher() -> None:
    """Clear the bridge's dispatcher and stop its collector thread; a
    request still queued fails with -EAGAIN."""
    if _lib is not None:
        _lib.ec_tpu_unregister_dispatcher()


def bridge_encode(k: int, m: int, w: int, technique: str,
                  data_chunks: list) -> list:
    """Blocking encode through the native batching bridge (the path a
    native OSD thread takes). Returns the m parity chunks; raises OSError
    without a dispatcher (EAGAIN) or when the dispatch failed (EIO, with
    the dispatcher's error text)."""
    L = lib()
    # the chunks are read where they lie (bytes or contiguous arrays)
    rows = [np.ascontiguousarray(c).view(np.uint8).reshape(-1)
            if isinstance(c, np.ndarray) else np.frombuffer(c, np.uint8)
            for c in data_chunks]
    if len(rows) != k or len({r.size for r in rows}) != 1:
        raise ValueError("bridge_encode needs k chunks of one length")
    bs = rows[0].size
    parity = np.empty((m, bs), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    dptr = (u8p * k)(*[ctypes.cast(r.ctypes.data, u8p) for r in rows])
    pptr = (u8p * m)(*[ctypes.cast(p.ctypes.data, u8p) for p in parity])
    req = _ECRequest(k=k, m=m, w=w, technique=technique.encode(),
                     blocksize=bs, data=dptr, parity=pptr)
    r = L.ec_tpu_encode(ctypes.byref(req))
    if r:
        text = os.strerror(-r)
        if r == -errno.EIO and _installed_dispatchers:
            text += ": " + _installed_dispatchers[-1][1].error
        raise OSError(-r, text)
    return [p.tobytes() for p in parity]
