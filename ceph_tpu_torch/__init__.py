"""ceph_tpu_torch: the PyTorch/CUDA port of ceph_tpu.

A second package beside ``ceph_tpu`` (the JAX reference, unchanged). It
imports ``torch`` and numpy, never ``jax`` and nothing of ``ceph_tpu``:
modules it needs from there are kept here as its own copies. Every entry
point takes an explicit ``device`` and defaults to ``cuda``; it raises
when CUDA is absent unless the caller asked for ``device="cpu"``.

Slice 1 ports the Reed-Solomon main path: registry -> RS codec ->
decode-table bank -> GF bitmatrix kernel (``csrc/gf_bitmatrix.cu``) ->
the coalescing h2d/compute/d2h dispatcher (``osd/gpu_dispatch.py``).
"""
