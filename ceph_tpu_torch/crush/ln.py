"""crush_ln: fixed-point 2^44 * log2(x+1), bit-exact.

Port of ``ceph_tpu/crush/ln.py``, semantics from Ceph's
src/crush/mapper.c:247-290 (normalize to [2^15, 2^17), two-level table
lookup). Two forms: numpy (``crush_ln``, ``straw2_draw_divide``; the
scalar mapper's) and torch int64 (``crush_ln_t``,
``straw2_draw_divide_t``; the plain version of the CUDA kernel).

The C multiplies ``(__s64)x * RH`` and lets it wrap for x = 0x10000;
only bits 48..55 of the product are used, and those are the same in the
wrapped and the exact product, so the torch form computes them exactly
in two halves (no int64 overflow, which is undefined in C++ and so in
torch's kernels) and the CUDA kernel in uint64, which wraps by rule.
"""

from __future__ import annotations

import numpy as np
import torch

from .ln_tables import LL_TBL, RH_LH_TBL


def _floor_log2(x):
    """floor(log2(x)) for x in [1, 2^17), via 17 comparisons (vector-safe)."""
    thresholds = np.left_shift(np.int64(1), np.arange(1, 18))
    return (x[..., None] >= thresholds).sum(axis=-1).astype(np.int64)


def crush_ln(xin):
    """2^44*log2(input+1) as int64. Input: any uint array (straw2 passes
    values in [0, 0xffff])."""
    x = np.asarray(xin).astype(np.int64) + 1

    # normalize into [2^15, 2^17): if neither bit 15 nor 16 is set,
    # left-shift so bit 15 becomes the top bit (mapper.c:257-265)
    needs_norm = (x & 0x18000) == 0
    fl = _floor_log2(x)
    bits = np.where(needs_norm, 15 - fl, 0)
    x = np.left_shift(x, bits)
    iexpon = np.where(needs_norm, fl, np.int64(15))

    index1 = (x >> 8) << 1
    rh = RH_LH_TBL[index1 - 256]       # ~2^56/index1
    lh = RH_LH_TBL[index1 + 1 - 256]   # ~2^48*log2(index1/256)

    # RH*x ~ 2^48 * (2^15 + xf); deliberately allowed to wrap like the C
    # (__s64) multiply for x = 0x10000
    with np.errstate(over="ignore"):
        xl64 = (x * rh) >> 48
    index2 = (xl64 & 0xFF).astype(np.int64)
    ll = LL_TBL[index2]

    result = iexpon << 44
    result = result + ((lh + ll) >> 4)
    return result


LN_MIN_OFFSET = 0x1000000000000  # straw2 subtracts 2^48 to map into <= 0


def straw2_draw_divide(ln, weight):
    """div64_s64(ln, weight): C truncating division (toward zero).

    ln <= 0 (after the 2^48 offset), weight > 0 -> -((-ln) // w).
    """
    return -((-ln) // weight)


# -- torch int64 form ---------------------------------------------------------

_TABLES: dict = {}


def ln_tables(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(RH_LH_TBL, LL_TBL) as int64 tensors on `device`, made once."""
    key = str(torch.device(device))
    tabs = _TABLES.get(key)
    if tabs is None:
        tabs = (torch.from_numpy(RH_LH_TBL).to(device),
                torch.from_numpy(LL_TBL).to(device))
        _TABLES[key] = tabs
    return tabs


def crush_ln_t(u: torch.Tensor) -> torch.Tensor:
    """crush_ln on an int64 tensor of values in [0, 0xffff]."""
    rh_lh, ll_tbl = ln_tables(u.device)
    x = u + 1
    needs_norm = (x & 0x18000) == 0
    # floor(log2(x)) for x < 2^17 by a binary search of five steps
    fl = torch.zeros_like(x)
    for step in (16, 8, 4, 2, 1):
        fl = fl + step * ((x >> (fl + step)) > 0).to(torch.int64)
    x = x << torch.where(needs_norm, 15 - fl, 0)
    iexpon = torch.where(needs_norm, fl, 15)

    index1 = (x >> 8) << 1
    rh = rh_lh[index1 - 256]
    lh = rh_lh[index1 + 1 - 256]
    # bits 48..55 of x * rh (x <= 2^16, rh <= 2^48): with rh = hi*2^24 + lo,
    # x*rh >> 48 = (x*hi + (x*lo >> 24)) >> 24, no term past 2^42
    hi = rh >> 24
    lo = rh & 0xFFFFFF
    index2 = ((x * hi + ((x * lo) >> 24)) >> 24) & 0xFF
    return (iexpon << 44) + ((lh + ll_tbl[index2]) >> 4)


def straw2_draw_divide_t(ln: torch.Tensor, weight: torch.Tensor):
    """ln / weight truncated toward zero (ln <= 0, weight > 0)."""
    return torch.div(ln, weight, rounding_mode="trunc")
