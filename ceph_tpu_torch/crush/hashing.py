"""rjenkins1 — the only hash CRUSH uses.

Port of ``ceph_tpu/crush/hashing.py``: Robert Jenkins' 32-bit mix
(public algorithm, burtleburtle.net/bob/hash/evahash.html), with CRUSH's
seed and argument framing (Ceph's src/crush/hash.c).

Two forms of the same functions:

- ``hash32_2/3/4`` on numpy uint32 (the reference's numpy form, used by
  the scalar mapper ``crush/mapper_ref.py``): uint32 wraps by itself;
- ``hash32_2_t/3_t`` on torch int64 tensors holding values in
  [0, 2^32) (the plain version of the CUDA kernel): torch has no
  ``<<``, ``>>`` or ``+`` for uint32 on the CPU, so every ``-`` and
  ``<<`` is masked to 32 bits. Inputs are masked first, so a seed below 0
  or at 2^31 and above hashes as its uint32 value, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

CRUSH_HASH_SEED = 1315423911
CRUSH_HASH_RJENKINS1 = 0

_M32 = 0xFFFFFFFF
_X, _Y = 231232, 1232


def _mix(a, b, c):
    """One Jenkins mix round on uint32 numpy values, which wrap."""
    a = a - b; a = a - c; a = a ^ (c >> 13)      # noqa: E702
    b = b - c; b = b - a; b = b ^ (a << 8)       # noqa: E702
    c = c - a; c = c - b; c = c ^ (b >> 13)      # noqa: E702
    a = a - b; a = a - c; a = a ^ (c >> 12)      # noqa: E702
    b = b - c; b = b - a; b = b ^ (a << 16)      # noqa: E702
    c = c - a; c = c - b; c = c ^ (b >> 5)       # noqa: E702
    a = a - b; a = a - c; a = a ^ (c >> 3)       # noqa: E702
    b = b - c; b = b - a; b = b ^ (a << 10)      # noqa: E702
    c = c - a; c = c - b; c = c ^ (b >> 15)      # noqa: E702
    return a, b, c


def _u32(x):
    return np.asarray(x).astype(np.uint32)


def _quiet(fn):
    """Silence numpy's intended-uint32-wraparound overflow warnings."""
    def wrapped(*args, **kwargs):
        with np.errstate(over="ignore"):
            return fn(*args, **kwargs)
    return wrapped


@_quiet
def hash32_2(a, b):
    a = _u32(a); b = _u32(b)                     # noqa: E702
    x = np.uint32(_X)
    y = np.uint32(_Y)
    h = np.uint32(CRUSH_HASH_SEED) ^ a ^ b
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


@_quiet
def hash32_3(a, b, c):
    a = _u32(a); b = _u32(b); c = _u32(c)       # noqa: E702
    x = np.uint32(_X)
    y = np.uint32(_Y)
    h = np.uint32(CRUSH_HASH_SEED) ^ a ^ b ^ c
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


@_quiet
def hash32_4(a, b, c, d):
    a = _u32(a); b = _u32(b)                     # noqa: E702
    c = _u32(c); d = _u32(d)                     # noqa: E702
    x = np.uint32(_X)
    y = np.uint32(_Y)
    h = np.uint32(CRUSH_HASH_SEED) ^ a ^ b ^ c ^ d
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


# -- torch int64 form ---------------------------------------------------------

def _mix_t(a, b, c):
    """One Jenkins mix round on int64 tensors in [0, 2^32): each
    difference and left shift is masked back to 32 bits; a right shift of
    a value in range needs none."""
    a = (a - b - c) & _M32; a = a ^ (c >> 13)             # noqa: E702
    b = (b - c - a) & _M32; b = b ^ ((a << 8) & _M32)     # noqa: E702
    c = (c - a - b) & _M32; c = c ^ (b >> 13)             # noqa: E702
    a = (a - b - c) & _M32; a = a ^ (c >> 12)             # noqa: E702
    b = (b - c - a) & _M32; b = b ^ ((a << 16) & _M32)    # noqa: E702
    c = (c - a - b) & _M32; c = c ^ (b >> 5)              # noqa: E702
    a = (a - b - c) & _M32; a = a ^ (c >> 3)              # noqa: E702
    b = (b - c - a) & _M32; b = b ^ ((a << 10) & _M32)    # noqa: E702
    c = (c - a - b) & _M32; c = c ^ (b >> 15)             # noqa: E702
    return a, b, c


def _args_t(*args):
    """Broadcast int tensors (any sign) to int64 uint32 values."""
    ts = torch.broadcast_tensors(*[torch.as_tensor(a).to(torch.int64)
                                   for a in args])
    return [t & _M32 for t in ts]


def hash32_2_t(a, b) -> torch.Tensor:
    """hash32_2 on int64 tensors; returns int64 values in [0, 2^32)."""
    a, b = _args_t(a, b)
    x = torch.full_like(a, _X)
    y = torch.full_like(a, _Y)
    h = CRUSH_HASH_SEED ^ a ^ b
    a, b, h = _mix_t(a, b, h)
    x, a, h = _mix_t(x, a, h)
    b, y, h = _mix_t(b, y, h)
    return h


def hash32_3_t(a, b, c) -> torch.Tensor:
    """hash32_3 on int64 tensors; returns int64 values in [0, 2^32)."""
    a, b, c = _args_t(a, b, c)
    x = torch.full_like(a, _X)
    y = torch.full_like(a, _Y)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    a, b, h = _mix_t(a, b, h)
    c, x, h = _mix_t(c, x, h)
    y, a, h = _mix_t(y, a, h)
    b, x, h = _mix_t(b, x, h)
    y, c, h = _mix_t(y, c, h)
    return h

