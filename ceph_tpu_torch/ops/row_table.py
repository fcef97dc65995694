"""Tables of row addresses: kernels that read rows where they lie.

The device chunk tier keeps its objects in upload batches, and a
consumer names objects from many batches. Rather than gather their rows
into one array first, a kernel reads each row where it lies, through a
device table of the rows' addresses: the chunk digest
(``digest_kernel``, a scrub's rows) and the per-lane GF product
(``gf_kernel.matrix_encode_multi_rows``, a rebuild's survivors).
:func:`row_table` builds one; it is the only copy of that code.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["row_indices", "row_table"]


def row_indices(parts: list[torch.Tensor], rows=None) -> list[np.ndarray]:
    """Per part, the int64 indices of its rows of n bytes to read: rows[i]
    (indices into parts[i].reshape(-1, n)), or all of them where `rows`
    or rows[i] is None."""
    out = []
    for i, t in enumerate(parts):
        if rows is not None and rows[i] is not None:
            out.append(np.asarray(rows[i], dtype=np.int64).reshape(-1))
            continue
        n = t.shape[-1]
        count = t.numel() // n if n else int(torch.Size(t.shape[:-1]).numel())
        out.append(np.arange(count, dtype=np.int64))
    return out


def row_table(parts: list[torch.Tensor], rows=None
              ) -> tuple[torch.Tensor, int, int | None]:
    """(the device addresses of the rows to read, int64 [rows] in part
    order; n; the first address not on 16 bytes, or None). Each part is
    a contiguous [..., n] uint8 tensor, all on one CUDA device with one
    n; `rows` as :func:`row_indices` takes it. The table is uploaded from
    pinned memory without blocking, in order on the current stream. The
    caller keeps `parts` alive, and from reuse, while a launch over the
    table may read them."""
    if not parts:
        raise ValueError("no rows to address")
    n, device = parts[0].shape[-1], parts[0].device
    for t in parts:
        if t.dtype != torch.uint8 or not t.is_contiguous():
            raise ValueError("rows must be contiguous uint8, got %s"
                             % t.dtype)
        if t.shape[-1] != n or t.device != device:
            raise ValueError("parts must share one row length and device")
    if device.type != "cuda":
        raise ValueError("a row table addresses CUDA memory, not %s"
                         % device)
    idx = row_indices(parts, rows)
    for t, i in zip(parts, idx):
        if i.size and (i.min() < 0 or i.max() * n >= max(t.numel(), 1)):
            raise IndexError("row index out of range of a part of %d rows"
                             % (t.numel() // max(n, 1)))
    addrs = np.concatenate([
        np.uint64(t.data_ptr()) + np.uint64(n) * i.astype(np.uint64)
        for t, i in zip(parts, idx)])
    bad = np.flatnonzero(addrs % np.uint64(16))
    table = torch.from_numpy(addrs.view(np.int64)).pin_memory().to(
        device, non_blocking=True)
    return table, int(n), int(addrs[bad[0]]) if bad.size else None
