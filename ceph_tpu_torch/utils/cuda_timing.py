"""Device timing of a kernel call and its least time on an H100.

Used by ``chip_smoke.py`` and ``tools/gf_kernel_sweep.py``; both run on a
CUDA card only.
"""

from __future__ import annotations

import statistics

import torch

# H100 SXM published peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def time_ms(fn, inputs, reps: int) -> float:
    """Median device time of fn over `reps` calls, each between two CUDA
    events. The calls are queued behind a ~0.1 s spin kernel, so the
    device runs them back to back and the events time the device, not
    the host's launch rate. The inputs rotate so that an input is out of
    the 50 MB L2 by the time it is read again, as the main path finds
    it."""
    fn(inputs[0])
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    marks = []
    for i in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(inputs[i % len(inputs)])
        e.record()
        marks.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def gf_bound(bitmat, data, out, w: int) -> tuple[float, str]:
    """Least time (ms) of a GF bitmatrix product: each input byte read once
    and each output byte written once at the HBM rate, or the GF(2)
    product counted as int8 multiply-adds at the int8 rate, whichever is
    larger, with the name of the bound."""
    nbytes = bitmat.numel() + data.numel() + out.numel()
    columns = data.numel() * 8 // (data.shape[-2] * w)
    ops = 2 * bitmat.shape[0] * bitmat.shape[1] * columns
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
