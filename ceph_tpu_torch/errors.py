"""Framework error type (errno-carrying, like the reference's int returns).

Port of ``ceph_tpu/errors.py``. The reference signals errors as negative
errnos through every interface (ErasureCodeInterface.h:28-34); the Python
rendition raises this exception with .errno set, so callers (profile
validation, the registry, the pipeline) can branch on the same codes.
"""

from __future__ import annotations

import errno as _errno


class ErasureCodeError(Exception):
    def __init__(self, err: int, message: str = ""):
        self.errno = err
        super().__init__(message or _errno.errorcode.get(err, str(err)))
