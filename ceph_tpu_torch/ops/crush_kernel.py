"""Wrapper of the batched CRUSH straw2 kernel (``csrc/crush_straw2.cu``).

Port of the XLA program of ``ceph_tpu/crush/batched.py`` (``_straw2_choose``
:128, ``_descend`` :173, ``_make_indep`` :217, ``_make_firstn`` :305).
:func:`crush_sweep` launches the kernel once for seeds on a CUDA device and
runs :func:`ceph_tpu_torch.crush.batched.map_plain` only for seeds on the
CPU; it never falls back.

The kernel maps a seed with a group of G lanes (:func:`kernel_group`:
from the largest bucket and the number of seeds) and reads one int32
buffer of tables (:func:`pack_tables`, with each weight's reciprocal for
its division); the device copy is cached per (table bytes, reweight
vector, device), so a sweep uploads a map once (:func:`device_tables`,
:func:`clear_tables`; ``UPLOADS`` counts the uploads).
``LAUNCHES`` counts the wrapper's launches; :func:`launches_by_design`
reads the counts that the C entry point keeps per design ("shared": the
tables, reciprocals included, staged in shared memory; "global": read
from device memory), and :func:`reset_launches` sets all of them and
``UPLOADS`` to 0. A seed's working slots live in shared memory, or in a
scratch of device memory the wrapper allocates where a rule's replicas
(``out_size``) exceed what a block holds.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..crush.batched import CompiledMap, RulePlan, map_plain
from ..crush.ln_tables import LL_TBL, RH_LH_TBL
from . import _build

__all__ = ["crush_sweep", "pack_tables", "device_tables", "clear_tables",
           "kernel_design", "launches_by_design", "reset_launches",
           "clock_rows", "kernel_group", "reciprocals",
           "LAUNCHES", "UPLOADS", "DESIGNS"]

_SOURCE = "crush_straw2"

DESIGNS = ("shared", "global")  # by the C entry point's number

LAUNCHES = 0
UPLOADS = 0
_count_lock = threading.Lock()
_lib = None
_table_cache: dict = {}
_table_lock = threading.Lock()
_TABLE_CACHE_MAX = 16


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        p = ctypes.c_void_p
        lib.crush_straw2_map.argtypes = [p, p, p, ctypes.c_int, p,
                                         ctypes.c_longlong, p, p, p, p, p]
        lib.crush_straw2_map.restype = ctypes.c_int
        lib.crush_straw2_design.argtypes = [p, p]
        lib.crush_straw2_design.restype = ctypes.c_int
        lib.crush_straw2_group.argtypes = [p, p, ctypes.c_longlong]
        lib.crush_straw2_group.restype = ctypes.c_int
        lib.crush_straw2_scratch.argtypes = [p, p, ctypes.c_int,
                                             ctypes.c_longlong]
        lib.crush_straw2_scratch.restype = ctypes.c_longlong
        lib.crush_straw2_launches.argtypes = [ctypes.c_int]
        lib.crush_straw2_launches.restype = ctypes.c_longlong
        lib.crush_straw2_reset_launches.argtypes = []
        lib.crush_straw2_reset_launches.restype = None
        _lib = lib
    return _lib


def reciprocals(weights: np.ndarray) -> np.ndarray:
    """uint64 floor((2^64 - 1) / d) of each weight d (0 for d = 0): the
    kernel divides by d as a multiply-high by it and one correction."""
    d = np.asarray(weights, dtype=np.uint64).reshape(-1)
    m = np.zeros(d.shape, dtype=np.uint64)
    nz = d != 0
    m[nz] = np.uint64(0xFFFFFFFFFFFFFFFF) // d[nz]
    return m


def pack_tables(cm: CompiledMap, wvec: np.ndarray) -> np.ndarray:
    """The kernel's table buffer, int32: the ln tables (RH_LH, then LL, as
    uint64 words), items [NB, S], hash ids [NB, S] (their low 32 bits, as
    the hash reads them), weight sets [NB, P, S] (uint32 bits), size [NB],
    type [NB], the reweight vector [NW] (values in [0, 0x10000]), a zero
    word where that ends on an odd word, and the weight sets'
    reciprocals [NB, P, S] (uint64, two words each: :func:`reciprocals`).
    ``compile_map`` has checked that every value fits."""
    ln = np.concatenate([RH_LH_TBL, LL_TBL]).astype(np.int64)
    head = [
        cm.items.reshape(-1).astype(np.int32),
        (cm.ids.reshape(-1) & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
        cm.wsets.reshape(-1).astype(np.uint32).view(np.int32),
        cm.size.astype(np.int32),
        cm.btype.astype(np.int32),
        np.asarray(wvec, dtype=np.int32).reshape(-1)]
    pad = sum(a.size for a in head) % 2
    return np.concatenate([
        ln.view(np.int32), *head, np.zeros(pad, dtype=np.int32),
        reciprocals(cm.wsets).view(np.int32)])


def _geometry(cm: CompiledMap, plan: RulePlan, nw: int):
    nb, s = cm.items.shape
    geo = (ctypes.c_int * 5)(nb, s, cm.npos, nw, cm.max_devices)
    rule = (ctypes.c_int * 10)(
        plan.root, int(plan.firstn), int(plan.chooseleaf), plan.target_type,
        plan.numrep, plan.out_size, plan.result_max, plan.tries,
        plan.recurse_tries, plan.vary_r)
    return geo, rule


def device_tables(cm: CompiledMap, wvec: np.ndarray,
                  device) -> torch.Tensor:
    """The packed tables on `device`, uploaded once per (tables, reweight
    vector, device)."""
    key = (cm.items.tobytes(), cm.ids.tobytes(), cm.wsets.tobytes(),
           cm.size.tobytes(), cm.btype.tobytes(), cm.max_devices,
           np.asarray(wvec, dtype=np.int64).tobytes(), str(device))
    global UPLOADS
    with _table_lock:
        tab = _table_cache.get(key)
    if tab is None:
        tab = torch.from_numpy(pack_tables(cm, wvec)).to(device)
        with _count_lock:
            UPLOADS += 1
        with _table_lock:
            if len(_table_cache) >= _TABLE_CACHE_MAX:
                _table_cache.clear()
            _table_cache[key] = tab
    return tab


def clear_tables() -> None:
    """Drops the cached device tables (the next sweep uploads again)."""
    with _table_lock:
        _table_cache.clear()


def kernel_design(cm: CompiledMap, plan: RulePlan, nw: int) -> str:
    """The design the kernel takes for this map and rule."""
    rc = _kernel().crush_straw2_design(*_geometry(cm, plan, nw))
    if rc < 0:
        raise ValueError("crush_straw2 refuses this geometry")
    return DESIGNS[rc]


def launches_by_design() -> dict[str, int]:
    """{design: kernel launches since the last reset}, as the C entry point
    counts them where it launches each instantiation."""
    if _lib is None:            # nothing was built, so nothing launched
        return dict.fromkeys(DESIGNS, 0)
    return {d: int(_lib.crush_straw2_launches(i))
            for i, d in enumerate(DESIGNS)}


def reset_launches() -> None:
    """Sets ``LAUNCHES``, ``UPLOADS`` and the per-design counts to 0."""
    global LAUNCHES, UPLOADS
    with _count_lock:
        LAUNCHES = UPLOADS = 0
        if _lib is not None:
            _lib.crush_straw2_reset_launches()


def kernel_group(cm: CompiledMap, plan: RulePlan, nw: int, n: int) -> int:
    """The lanes that map one seed (G) in a sweep of n seeds on the
    current CUDA device: from the largest bucket and the seeds, as the C
    entry point's make_plan picks it."""
    g = _kernel().crush_straw2_group(*_geometry(cm, plan, nw), n)
    if g < 0:
        raise ValueError("crush_straw2 refuses this geometry (%d)" % g)
    return g


def clock_rows(cm: CompiledMap, plan: RulePlan, nw: int, n: int,
               group: int = 0) -> int:
    """Rows of the `clocks` tensor of a sweep of n seeds: one a warp."""
    return (n * (group or kernel_group(cm, plan, nw, n)) + 31) // 32


def crush_sweep(cm: CompiledMap, plan: RulePlan, xs: torch.Tensor,
                wvec: np.ndarray, work: torch.Tensor | None = None,
                clocks: torch.Tensor | None = None,
                group: int = 0) -> torch.Tensor:
    """Seeds xs [B] int64 -> [B, result_max] int64 (CRUSH_ITEM_NONE holes)
    on xs' device, under the reweight vector `wvec` (numpy int64, as
    ``batched.reweight_vector`` makes it).

    A CUDA tensor takes one launch of the kernel, which raises if it
    cannot build or launch; a CPU tensor takes the plain version. `work`
    (CUDA only, int32 [B, 2]) receives each seed's straw2 draws and
    is_out hashes, for the bound. `clocks` (CUDA only, int64
    [clock_rows(...), 4], zeros) makes a profiled launch, which writes
    each warp's cycles from its first seed to its last, the draw steps it
    issued, the lanes active at them and its SM: the clock split of the
    sweep's time. `group` (a power of two up to 32; 0 as
    :func:`kernel_group` picks it) sets the lanes a seed, for tests and
    timing: the placements are the same at any."""
    if xs.dtype != torch.int64 or xs.dim() != 1:
        raise TypeError("xs must be int64 [B], got %s %s"
                        % (xs.dtype, tuple(xs.shape)))
    if xs.device.type == "cpu":
        if work is not None or clocks is not None:
            raise ValueError("work and clocks come from the CUDA kernel "
                             "only")
        return map_plain(cm, plan, xs, torch.from_numpy(
            np.asarray(wvec, dtype=np.int64)))
    if xs.device.type != "cuda":
        raise ValueError("unsupported device %s" % xs.device)
    global LAUNCHES
    n = xs.shape[0]
    nw = int(np.asarray(wvec).size)
    if work is not None and (work.dtype != torch.int32 or
                             tuple(work.shape) != (n, 2) or
                             work.device != xs.device or
                             not work.is_contiguous()):
        raise ValueError("work must be int32 [B, 2] beside xs")
    if clocks is not None and (
            clocks.dtype != torch.int64 or clocks.device != xs.device or
            tuple(clocks.shape) != (clock_rows(cm, plan, nw, n, group), 4)
            or not clocks.is_contiguous()):
        raise ValueError("clocks must be int64 [clock_rows(...), 4] beside "
                         "xs")
    xs = xs.contiguous()
    with torch.cuda.device(xs.device):
        lib = _kernel()
        tables = device_tables(cm, wvec, xs.device)
        out = torch.empty((n, plan.result_max), dtype=torch.int64,
                          device=xs.device)
        geo, rule = _geometry(cm, plan, nw)
        words = lib.crush_straw2_scratch(geo, rule, group, n)
        if words < 0:
            raise ValueError("crush_straw2 refuses this geometry (%d)"
                             % words)
        scratch = torch.empty(words, dtype=torch.int32, device=xs.device) \
            if words else None
        rc = lib.crush_straw2_map(
            tables.data_ptr(), geo, rule, group, xs.data_ptr(), n,
            out.data_ptr(), None if work is None else work.data_ptr(),
            None if clocks is None else clocks.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(xs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("crush_straw2_map failed with code %d%s"
                           % (rc, _build.launch_failure(lib)))
    if n:
        with _count_lock:
            LAUNCHES += 1
    return out
