"""Op tracing pieces the dispatcher needs.

Port of ``ceph_tpu/common/tracer.py``, as far as this slice uses it:

  NULL_SPAN        the shared no-op span: the disabled-tracing fast path
                   (instrumented code pays one truthiness check).
  device_segments  the one device-call shape everyone shares: run a codec
                   call split into h2d / compute / d2h legs and time each.

The span collector, tail sampler and tree renderer wait for the slice
that ports the daemons.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import host_tensor, pinned_copy, to_numpy

__all__ = ["NULL_SPAN", "device_segments"]


class _NullSpan:
    """Shared no-op span: the disabled-tracing fast path."""

    __slots__ = ()
    trace_id = 0
    span_id = 0

    def valid(self) -> bool:
        return False

    def child_interval(self, name, start, end, **kv) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


def device_segments(fn, batch: np.ndarray, device: torch.device):
    """Run fn on host array `batch` as an explicit h2d -> compute -> d2h
    sequence on `device` and time each leg. Returns (host ndarray result,
    {"h2d", "compute", "d2h"} seconds).

    On CUDA the legs run on the current stream: h2d copies a pinned host
    buffer with ``non_blocking=True``, d2h copies into pinned host memory,
    and each leg is timed between ``torch.cuda.Event``s (the host's
    pinning copy falls inside the h2d leg). On the CPU the legs are
    timed with the host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        x = host_tensor(batch)
        t1 = time.perf_counter()
        out = fn(x)
        t2 = time.perf_counter()
        out = to_numpy(out)
        t3 = time.perf_counter()
        return out, {"h2d": t1 - t0, "compute": t2 - t1, "d2h": t3 - t2}
    stream = torch.cuda.current_stream(device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record(stream)
    dev = host_tensor(batch).pin_memory().to(device, non_blocking=True)
    ev[1].record(stream)
    out = fn(dev)
    ev[2].record(stream)
    host = pinned_copy(out)
    ev[3].record(stream)
    ev[3].synchronize()
    return to_numpy(host), {"h2d": ev[0].elapsed_time(ev[1]) / 1e3,
                          "compute": ev[1].elapsed_time(ev[2]) / 1e3,
                          "d2h": ev[2].elapsed_time(ev[3]) / 1e3}
