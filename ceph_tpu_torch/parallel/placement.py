"""Device placement registry: one OSD per card.

Port of ``ceph_tpu/parallel/placement.py``. Each OSD resolves a *home
device* at startup (``osd_device_index``; round-robin over the visible
CUDA devices by default), and the registry is process-global so that a
shared-process cluster can render its whole placement table.

``DevicePlacement(devices=[...])`` round-robins over an explicit list
instead, which may repeat a device (``["cpu"] * 8`` in the tests, as the
reference round-robins over its 8 virtual devices). With no CUDA and no
list, ``resolve`` returns None, as the reference does on a host without
devices; a consumer then resolves None through
``device.resolve_device``, which raises unless the caller asked for the
CPU.
"""

from __future__ import annotations

import threading

import torch

from ..device import device_label

__all__ = ["DevicePlacement", "PLACEMENT", "device_label", "local_device_count"]


def _local_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_device_count() -> int:
    """Visible CUDA devices (0 on a host without CUDA)."""
    return len(_local_devices())


class DevicePlacement:
    """Process-global OSD -> home-device table.

    `resolve(osd_id, device_index)` is the single policy point:

      - device_index >= 0: explicit pin (modulo the device count, so an
        8-way conf survives a 1-card box);
      - device_index < 0 (the `osd_device_index` default): round-robin
        by osd_id, deterministic, so two processes hosting the same OSD
        id agree without coordination;
      - no devices: None.
    """

    def __init__(self, devices=None):
        self._devices = None if devices is None else \
            [torch.device(d) for d in devices]
        self._lock = threading.Lock()
        self._table: dict = {}      # osd_id -> (index, device-or-None)

    def _visible(self) -> list[torch.device]:
        return list(self._devices) if self._devices is not None \
            else _local_devices()

    def resolve(self, osd_id: int, device_index: int = -1):
        devices = self._visible()
        if not devices:
            with self._lock:
                self._table[int(osd_id)] = (-1, None)
            return None
        if device_index is None or device_index < 0:
            index = int(osd_id) % len(devices)
        else:
            index = int(device_index) % len(devices)
        device = devices[index]
        with self._lock:
            self._table[int(osd_id)] = (index, device)
        return device

    def lookup(self, osd_id: int):
        """Previously resolved home device for osd_id (None if unknown
        or unpinned)."""
        with self._lock:
            row = self._table.get(int(osd_id))
        return row[1] if row else None

    def forget(self, osd_id: int) -> None:
        with self._lock:
            self._table.pop(int(osd_id), None)

    def assignments(self) -> dict:
        """`mesh status` payload: osd id -> {index, device} plus the
        visible device inventory."""
        devices = self._visible()
        with self._lock:
            table = {str(osd): {"index": idx, "device": device_label(dev)}
                     for osd, (idx, dev) in sorted(self._table.items())}
        return {"local_devices": [device_label(d) for d in devices],
                "num_devices": len(devices),
                "osds": table}


PLACEMENT = DevicePlacement()
