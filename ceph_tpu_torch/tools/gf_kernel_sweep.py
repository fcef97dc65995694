"""Device time of the GF bitmatrix kernel against the batch size.

    python -m ceph_tpu_torch.tools.gf_kernel_sweep [--batches 1,2,4]

For the Reed-Solomon k=8, m=3, w=8 encode bitmatrix ([24, 64]) and the
decode bitmatrix of signature (3..10) ([88, 64]), at data [B, 8, 131072]
(the main path's objects of 1 MiB) for each batch size B: the kernel's median device time over 40 launches, its
bound, the design the geometry takes and the threads it needs (one per
32 columns in the bit-sliced design). The inputs rotate through 256 MiB,
so that each launch finds its input out of L2. One JSON line per point,
then the card's name and power limit as nvidia-smi prints them. Needs a
CUDA card; it fails without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import gf, gf_kernel
from ..utils.cuda_timing import gf_bound, time_ms

K, M, W, N = 8, 3, 8, 131072
ROTATE_BYTES = 256 << 20


def bitmatrices() -> dict[str, np.ndarray]:
    coding = gf.rs_vandermonde_generator(K, M, W)
    avail = (3, 4, 5, 6, 7, 8, 9, 10)
    dec = gf.decode_matrix(coding, K, avail, W)
    full = np.concatenate([dec, gf.gf_matmul(coding, dec, W)])
    return {"encode": gf.generator_to_bitmatrix(coding, W),
            "decode345678910": gf.generator_to_bitmatrix(full, W)}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", default="1,2,4,6,8,10,11,12,13,14,16",
                   help="comma-separated batch sizes B")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gf_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(20261016)
    pool = torch.randint(0, 256, (ROTATE_BYTES,), dtype=torch.uint8,
                         device=dev, generator=gen)
    for name, bm_np in bitmatrices().items():
        bm = torch.from_numpy(bm_np).to(dev)
        for b in (int(x) for x in args.batches.split(",")):
            size = b * K * N
            inputs = [pool[o:o + size].view(b, K, N)
                      for o in range(0, ROTATE_BYTES - size + 1, size)]
            out = gf_kernel.matrix_encode(bm, inputs[0], W)
            ms = time_ms(lambda x: gf_kernel.matrix_encode(bm, x, W),
                         inputs, 40)
            bound_ms, bound_by = gf_bound(bm, inputs[0], out, W)
            print(json.dumps({
                "bitmat": name, "shape": [b, K, N], "ms": ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / ms,
                "design": gf_kernel.kernel_design(bm.shape[0], K, W, dev),
                "threads": b * -(-N // 32)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
