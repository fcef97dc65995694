"""Device selection shared by every entry point of the port.

An entry point defaults to ``cuda`` and raises when CUDA is absent: it
never carries on on the CPU unless the caller passed ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on (``None`` means cuda).

    A bare ``cuda`` is pinned to the current CUDA device so that caches
    keyed by device ("cuda:0") agree however the caller spelled it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the "
                "host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("unsupported device %s" % dev)
    return dev


def device_label(device) -> str:
    """Stable short label of a torch device ("cuda:0", "cpu:0"), or
    "default" when unpinned (None); the telemetry's and the chunk tier's
    `device` field (ref ``ceph_tpu/parallel/placement.py:34``)."""
    if device is None:
        return "default"
    device = torch.device(device)
    return "%s:%d" % (device.type, device.index or 0)


def pinned_copy(out):
    """Pinned host copies of a device result (a tensor, or a dict of
    them), queued on the current stream: the caller synchronises before
    reading them."""
    if isinstance(out, dict):
        return {k: pinned_copy(v) for k, v in out.items()}
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    return host


def to_numpy(out):
    """numpy views of host tensors (a tensor, or a dict of them)."""
    if isinstance(out, dict):
        return {k: to_numpy(v) for k, v in out.items()}
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def host_tensor(a) -> torch.Tensor:
    """A CPU uint8 tensor over numpy array `a` (copied only when numpy
    cannot lend its buffer: not C-contiguous, or read-only)."""
    a = np.asarray(a, dtype=np.uint8)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()
    return torch.from_numpy(a)
