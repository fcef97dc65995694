"""Multi-device placement, the device mesh and rateless dispatch (port of
``ceph_tpu/parallel``)."""

from .mesh import make_mesh, encode_sharded  # noqa: F401
from .placement import PLACEMENT, DevicePlacement, device_label  # noqa: F401
from .rateless import (DEVICE_FAULTS, DeviceFaultSet,  # noqa: F401
                       RatelessDispatcher, get_dispatcher)
