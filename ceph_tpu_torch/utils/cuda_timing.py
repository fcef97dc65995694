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
# an xxh32 round's dependent chain on one lane: a funnel-shift rotate and
# one multiply-add (the multiply by P1 fused with the next product's add),
# 10.25 cycles a round on an H100 as measured by csrc/write_transform.cu's
# xxh_chain_kernel (tools/gf_kernel_sweep.py --kernel xxh32 --split), at
# the H100 SXM's highest SM clock, 1.98 GHz
XXH_ROUND_CYCLES = 10.25
SM_CLOCK_HZ = 1.98e9


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


def _bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The larger of `nbytes` at the HBM rate and `ops` at the int8 rate
    (ms), with the name of the bound."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gf_bound(bitmat, data, out, w: int) -> tuple[float, str]:
    """Least time (ms) of a GF bitmatrix product: each input byte read once
    and each output byte written once at the HBM rate, or the GF(2)
    product counted as int8 multiply-adds at the int8 rate, whichever is
    larger, with the name of the bound."""
    nbytes = bitmat.numel() + data.numel() + out.numel()
    columns = data.numel() * 8 // (data.shape[-2] * w)
    return _bound(nbytes, 2 * bitmat.shape[0] * bitmat.shape[1] * columns)


def packet_bound(bitmat, data, out) -> tuple[float, str]:
    """Least time (ms) of a packet-layout bitmatrix product: each input
    byte read once and each output byte written once at the HBM rate, or
    the XORs these inputs need at the int8 rate, whichever is larger, with
    the name of the bound. The product only selects whole packets and
    XORs them bytewise: each set bit of the [R, k*w] bitmatrix costs one
    byte XOR per byte of a packet row, B*S*P of them, where data is
    [B, k, S*w*P]."""
    nbytes = bitmat.numel() + data.numel() + out.numel()
    w = bitmat.shape[1] // data.shape[-2]
    return _bound(nbytes, int(bitmat.sum()) *
                  (data.numel() // (data.shape[-2] * w)))


def crc_bound(view, out) -> tuple[float, str]:
    """Least time (ms) of K1: each byte of the rows read once and each crc
    written once at the HBM rate; its table steps (one per byte) are
    counted at the int8 rate, which never binds."""
    return _bound(view.numel() + 4 * out.numel(), view.numel())


def xxh32_bound(rows) -> tuple[float, str]:
    """Least time (ms) of K2: the larger of its bytes (rows read once, a
    word written per row) at the HBM rate and its chain: a row is L/16
    dependent rounds of XXH_ROUND_CYCLES cycles at SM_CLOCK_HZ, and rows
    run side by side, so the chain of one row bounds the launch
    ("operations")."""
    t_bytes = (rows.numel() + 4 * rows.shape[0]) / HBM_BYTES_PER_S * 1e3
    t_chain = (rows.shape[1] // 16) * XXH_ROUND_CYCLES / SM_CLOCK_HZ * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_chain \
        else (t_chain, "operations")


def bitplane_bound(flat, cap2: int) -> tuple[float, str]:
    """Least time (ms) of K3: the N input bytes read once and the stored
    stream [cap2] written once at the HBM rate; its per-byte histogram
    adds and bit moves at the int8 rate never bind."""
    return _bound(flat.numel() + cap2, 8 * flat.numel())


# the H100 SXM's 32-bit integer issue rate: 64 INT32 lanes an SM a clock
# (NVIDIA Hopper architecture white paper: 16 INT32 units in each of an
# SM's 4 partitions), 132 SMs, at SM_CLOCK_HZ
INT32_OPS_PER_S = 132 * 64 * SM_CLOCK_HZ
# integer instructions of one straw2 draw of csrc/crush_straw2.cu, counted
# in its SASS (cuobjdump -sass of the sm_90a build, CUDA 12.8): the draw
# loop's IADD3 59, LOP3 50, IMAD 43, SHF 35, ISETP 13, VIADD 4, SEL 3, FLO
# and VIMNMX 1 each (the hash, crush_ln, the division's integer steps, the
# comparison), beside 9 FP64 and conversion instructions of the division's
# estimate and 26 loads, branches and uniform moves, which are not counted
CRUSH_DRAW_OPS = 209
# is_out's 2-word hash, counted from the code: 3 mixes of 9 steps (a
# 3-input subtraction, a shift and an xor each), the seed's xor, the mask
CRUSH_HASH2_OPS = 3 * 27 + 2


def crush_bound(work, result_max: int) -> tuple[float, str]:
    """Least time (ms) of a CRUSH sweep: the integer operations of the
    draws and is_out hashes this run's seeds needed (`work`, [B, 2] as
    the kernel counts them) at INT32_OPS_PER_S, or the seeds read and
    the [B, result_max] int64 result written at the HBM rate, whichever
    is larger, with the name of the bound."""
    counts = work.to(torch.int64).sum(dim=0).tolist()
    ops = counts[0] * CRUSH_DRAW_OPS + counts[1] * CRUSH_HASH2_OPS
    nbytes = work.shape[0] * 8 * (1 + result_max)
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
