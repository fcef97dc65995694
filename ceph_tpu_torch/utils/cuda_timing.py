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
# GF(2) multiply-adds (AND, then XOR or the low bit of a sum), counted as
# two operations each: the tensor cores' binary path (mma.sync m16n8k256
# b1 with AND and POPC) computes them, and the H100's data sheet gives it
# no rate. The A100's gave it 8 times the dense int8 rate (4,992 against
# 624 TOP/s), and on an H100 m16n8k256 b1 issues at the instruction rate
# of m16n8k32 s8 (PERF.md, tools/gf_kernel_sweep.py --kernel mma_rate),
# 8 times its multiply-adds: 8 times the int8 peak
GF2_OPS_PER_S = 8 * INT8_OPS_PER_S
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


def _bound(nbytes: int, ops: int,
           rate: float = INT8_OPS_PER_S) -> tuple[float, str]:
    """The larger of `nbytes` at the HBM rate and `ops` at `rate` (the
    int8 rate unless given), in ms, with the name of the bound."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gf_bound(bitmat, data, out, w: int) -> tuple[float, str]:
    """Least time (ms) of a GF bitmatrix product: each input byte read once
    and each output byte written once at the HBM rate, or the GF(2)
    product's multiply-adds at GF2_OPS_PER_S, whichever is larger, with
    the name of the bound."""
    nbytes = bitmat.numel() + data.numel() + out.numel()
    columns = data.numel() * 8 // (data.shape[-2] * w)
    return _bound(nbytes, 2 * bitmat.shape[0] * bitmat.shape[1] * columns,
                  GF2_OPS_PER_S)


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


# the H100 SXM's integer rates (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0; NVIDIA Hopper
# architecture white paper): 64 results an SM a clock for 32-bit adds,
# logic, shifts and compares on the ALU pipe (16 INT32 lanes in each of an
# SM's 4 partitions), 64 for IMAD on the FMA pipe beside it, and one warp
# instruction issued a clock in each partition; 132 SMs at SM_CLOCK_HZ
INT32_OPS_PER_S = 132 * 64 * SM_CLOCK_HZ
IMAD_OPS_PER_S = 132 * 64 * SM_CLOCK_HZ
ISSUE_PER_S = 132 * 4 * 32 * SM_CLOCK_HZ
# integer instructions of one straw2 draw of csrc/crush_straw2.cu, counted
# in its SASS (cuobjdump -sass of the sm_90a build, CUDA 12.8; the draw
# loop of the shared-memory instantiation): IADD3 55, LOP3 50, IMAD 46,
# SHF 35, ISETP 7, VIADD 4, SEL 4, FLO, VIMNMX and LEA 1 each (the hash,
# crush_ln, the multiply-high by the weight's reciprocal and its
# correction, the comparison), beside 17 loads, branches and uniform
# moves, which are not counted; the group's shuffles after the loop are
# the design's cost and are not counted either. The thread-a-seed draw
# with a double estimate of the quotient counted 209.
CRUSH_DRAW_OPS = 204
# of them on the ALU pipe for certain: IADD3, LOP3, SHF, ISETP, SEL,
# VIMNMX and LEA. IMAD runs on the FMA pipe; VIADD and FLO, whose pipe the
# guide does not name, are counted off the ALU, which can only shorten
# the bound
CRUSH_DRAW_ALU_OPS = 55 + 50 + 35 + 7 + 4 + 1 + 1
# is_out's 2-word hash, counted from the code: 3 mixes of 9 steps (a
# 3-input subtraction, a shift and an xor each), the seed's xor, the mask,
# all on the ALU pipe
CRUSH_HASH2_OPS = 3 * 27 + 2


def crush_bound(work, result_max: int) -> tuple[float, str]:
    """Least time (ms) of a CRUSH sweep: the integer instructions of the
    draws and is_out hashes this run's seeds needed (`work`, [B, 2] as
    the kernel counts them), on the busier of the ALU pipe
    (INT32_OPS_PER_S) and the FMA pipe (IMAD_OPS_PER_S) or all of them at
    the issue rate, or the seeds read and the [B, result_max] int64
    result written at the HBM rate, whichever is larger, with the name of
    the bound."""
    draws, hashes = work.to(torch.int64).sum(dim=0).tolist()
    alu = draws * CRUSH_DRAW_ALU_OPS + hashes * CRUSH_HASH2_OPS
    fma = draws * (CRUSH_DRAW_OPS - CRUSH_DRAW_ALU_OPS)
    issued = draws * CRUSH_DRAW_OPS + hashes * CRUSH_HASH2_OPS
    t_ops = max(alu / INT32_OPS_PER_S, fma / IMAD_OPS_PER_S,
                issued / ISSUE_PER_S) * 1e3
    nbytes = work.shape[0] * 8 * (1 + result_max)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gf_multi_bound(bitmats, data, out, w: int) -> tuple[float, str]:
    """Least time (ms) of a per-lane GF bitmatrix product (bitmats
    [P, R, k*w], data [P, ..., k, N]): gf_bound summed over the lanes,
    every lane's bitmatrix, data and output bytes once at the HBM rate, or
    every lane's GF(2) product at GF2_OPS_PER_S."""
    nbytes = bitmats.numel() + data.numel() + out.numel()
    columns = data.numel() * 8 // (data.shape[-2] * w)
    return _bound(nbytes, 2 * bitmats.shape[1] * bitmats.shape[2] * columns,
                  GF2_OPS_PER_S)


# integer instructions of one 16-byte step of csrc/hbm_digest.cu's fast
# path, counted in its SASS (cuobjdump -sass of the sm_90a build, CUDA
# 12.8): IDP.4A 8, IMAD and IMAD.IADD 3, VIADD 2 (the weight's step and
# wrap), ISETP 2 (the wrap test and the straddle test), beside the load,
# the branches and barriers and the uniform moves of the constants, which
# are not counted
DIGEST_VECTOR_OPS = 15


def digest_bound(nbytes: int, rows: int) -> tuple[float, str]:
    """Least time (ms) of the chunk digest over `rows` rows of `nbytes`
    bytes in all: the bytes read once and two uint32 written a row at the
    HBM rate, or DIGEST_VECTOR_OPS a 16-byte step at INT32_OPS_PER_S,
    whichever is larger, with the name of the bound."""
    t_bytes = (nbytes + 8 * rows) / HBM_BYTES_PER_S * 1e3
    t_ops = nbytes / 16 * DIGEST_VECTOR_OPS / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
