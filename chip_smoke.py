#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ceph_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path at the bench's real size — Reed-Solomon
reed_sol_van k=8, m=3, w=8 on batches of 16 objects of 1 MiB
([16, 8, 131072] uint8) — through the entry points a user calls, and
holds every kernel of the path against its plain PyTorch version on the
card. Phases, each printing one JSON line:

  1. setup       build every ``ceph_tpu_torch/csrc/*.cu`` (one nvcc each,
                 all at once) and report the card.
  2. kernel      the GF bitmatrix kernel against ``matrix_encode_plain``
                 on CUDA tensors (encode, three decode bitmatrices, w=16,
                 w=32, a ragged N): byte equality, kernel / plain times.
  3. main_path   ``registry.factory("torch_cuda", ...)``: encode_batch,
                 then decode_batch for all C(11,8)=165 erasure signatures
                 (reconstruction must equal the original rows; one object
                 also equals the numpy oracle ``gf_ref``).
  4. dispatcher  8 threads submit host batches of 1 MiB objects through
                 ``GpuDispatcher`` (encode_async and decode_async over
                 random signatures); every result is verified.
  5. kernels     one JSON line per the port's kernel table: launches on
                 the main path (phases 3-4), max_abs_err, ms, plain_ms,
                 bound_ms, bound_by, library_ms.

Then the card's name and power limit as nvidia-smi prints them, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without that line. It needs one CUDA card and the checkout the
script sits in; without either it fails. Every phase line also goes to
``chiprun_out/chip_smoke.jsonl``.
"""

from __future__ import annotations

import itertools
import json
import random
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

BATCH, K, M, W, N = 16, 8, 3, 8, 131072
PROFILE = {"technique": "reed_sol_van", "k": str(K), "m": str(M), "w": str(W)}

_records: list[dict] = []


def emit(phase: str, **fields) -> None:
    rec = {"phase": phase, **fields}
    _records.append(rec)
    print(json.dumps(rec), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError("check failed: " + what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi answered")
    return out.stdout.strip().splitlines()[0]


def bound(bitmat, data, out, w: int) -> tuple[float, str]:
    """Least time (ms) for the kernel's work: each input byte read once
    and each output byte written once at the HBM rate, or the GF(2)
    product counted as int8 multiply-adds at the int8 rate."""
    nbytes = bitmat.numel() + data.numel() + out.numel()
    columns = data.numel() * 8 // (data.shape[-2] * w)
    ops = 2 * bitmat.shape[0] * bitmat.shape[1] * columns
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, inputs, reps: int) -> float:
    """Median device time of fn over `reps` calls, each between two CUDA
    events. The calls are queued behind a ~0.1 s spin kernel, so the
    device runs them back to back and the events time the device, not
    the host's launch rate. The inputs rotate so that an input is out of
    the 50 MB L2 by the time it is read again, as the main path finds
    it."""
    import torch
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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "ceph_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(ceph_tpu_torch/ not found beside the script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from ceph_tpu_torch import registry
    from ceph_tpu_torch.ops import _build, gf, gf_kernel, gf_ref
    from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher

    torch.backends.cuda.matmul.allow_tf32 = False  # plain version exact
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261016)
    smi = nvidia_smi()

    # -- 1. setup ------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    emit("setup", build_s=time.perf_counter() - t0,
         compiled={k: round(v, 3) for k, v in built.items()},
         gpu=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # -- 2. kernel against its plain version on the card ------------------
    coding = gf.rs_vandermonde_generator(K, M, W)

    def dec_bitmat(avail, w=W, cod=coding):
        full = np.concatenate(
            [gf.decode_matrix(cod, K, avail, w),
             gf.gf_matmul(cod, gf.decode_matrix(cod, K, avail, w), w)])
        return gf.generator_to_bitmatrix(full, w)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    data_sets = [on_dev(rng.integers(0, 256, (BATCH, K, N), dtype=np.uint8))
                 for _ in range(4)]
    cases = [("encode", W, gf.generator_to_bitmatrix(coding, W), data_sets)]
    for avail in [(3, 4, 5, 6, 7, 8, 9, 10), (0, 1, 2, 4, 5, 6, 9, 10),
                  (1, 2, 3, 5, 6, 7, 8, 9)]:
        cases.append(("decode" + "".join(map(str, avail)), W,
                      dec_bitmat(avail), data_sets))
    for w in (16, 32):
        cases.append(("encode_w%d" % w, w, gf.generator_to_bitmatrix(
            gf.rs_vandermonde_generator(K, M, w), w), data_sets[:1]))
    ragged = on_dev(rng.integers(0, 256, (BATCH, K, N - 1001),
                                 dtype=np.uint8))
    cases.append(("encode_ragged", W, gf.generator_to_bitmatrix(coding, W),
                  [ragged]))

    timings = {}
    worst = 0
    for name, w, bm_np, inputs in cases:
        bm = on_dev(bm_np)
        out = gf_kernel.matrix_encode(bm, inputs[0], w)
        torch.cuda.synchronize()
        ref = gf_kernel.matrix_encode_plain(bm, inputs[0], w)
        err = int((out.to(torch.int16) - ref.to(torch.int16)).abs().max())
        worst = max(worst, err)
        rec = {"case": name, "w": w, "bitmat": list(bm.shape),
               "data": list(inputs[0].shape), "equal": err == 0,
               "max_abs_err": err}
        if name == "encode" or name.startswith("decode3"):
            rec["ms"] = time_ms(
                lambda x: gf_kernel.matrix_encode(bm, x, w), inputs, 40)
            rec["plain_ms"] = time_ms(
                lambda x: gf_kernel.matrix_encode_plain(bm, x, w),
                inputs, 8)
            rec["bound_ms"], rec["bound_by"] = bound(bm, inputs[0], out, w)
            timings[name] = rec
        emit("kernel", **rec)
        check(err == 0, "kernel equals plain version for " + name)
    del cases, ragged

    # -- 3. main path: registry -> RS codec -> bank -> kernel -------------
    gf_kernel.LAUNCHES = 0
    codec = registry.factory("torch_cuda", dict(PROFILE))
    check(codec.device.type == "cuda", "codec on the card by default")
    data = data_sets[0]
    parity = codec.encode_batch(data)
    torch.cuda.synchronize()
    check(tuple(parity.shape) == (BATCH, M, N) and parity.is_cuda,
          "parity shape and device")
    host0 = data[0].cpu().numpy()
    check(np.array_equal(parity[0].cpu().numpy(),
                         gf_ref.matrix_encode_ref(codec.coding, host0, W)),
          "encode equals gf_ref on one object")
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        codec.encode_batch(data)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    full = torch.cat([data, parity], 1)

    sigs = list(itertools.combinations(range(K + M), K))
    t0 = time.perf_counter()
    for avail in sigs:           # first pass also builds the bank
        out = codec.decode_batch(avail, full[:, list(avail)].contiguous())
        check(torch.equal(out, full), "decode %s reconstructs" % (avail,))
    bank_s = time.perf_counter() - t0
    survivors = [full[:, list(a)].contiguous() for a in sigs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for avail, chunks in zip(sigs, survivors):
        codec.decode_batch(avail, chunks)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    del survivors
    avail = (3, 4, 5, 6, 7, 8, 9, 10)
    full0 = full[0].cpu().numpy()
    ref = gf_ref.decode_ref(codec.coding, K, W,
                            {i: full0[i] for i in avail})
    got = codec.decode_batch(avail, full[:1, list(avail)].contiguous())
    check(all(np.array_equal(got[0, i].cpu().numpy(), ref[i])
              for i in range(K + M)), "decode equals gf_ref on one object")
    launches_main = gf_kernel.LAUNCHES
    check(launches_main > 0, "main path launched the kernel")
    obj_bytes = BATCH * K * N
    emit("main_path", signatures=len(sigs), bank=list(codec._bank_dev.shape),
         encode_MBps=obj_bytes * reps / enc_s / 1e6,
         decode_MBps=obj_bytes * len(sigs) / dec_s / 1e6,
         first_decode_pass_s=bank_s, launches=launches_main,
         table_cache=codec.table_cache_stats())

    # -- 4. coalescing dispatcher, host batches of 1 MiB objects ----------
    host_data = data.cpu().numpy()
    host_full = full.cpu().numpy()
    del full, parity
    disp = GpuDispatcher()
    check(disp.device.type == "cuda", "dispatcher on the card by default")
    sig_pool = [sigs[i] for i in rng.choice(len(sigs), 6, replace=False)]
    threads, iters, per_op = 8, 24, 2
    errors: list[str] = []
    moved = [0]
    lock = threading.Lock()

    def submitter(tid: int, n_iters: int) -> None:
        r = random.Random(tid)
        try:
            for _ in range(n_iters):
                i = r.randrange(BATCH - per_op + 1)
                sl = slice(i, i + per_op)
                avail = sig_pool[r.randrange(len(sig_pool))]
                f_enc = disp.encode_async(codec, host_data[sl])
                f_dec = disp.decode_async(
                    codec, avail, host_full[sl][:, list(avail)])
                if not np.array_equal(f_enc.result(300), host_full[sl, K:]):
                    errors.append("encode mismatch")
                if not np.array_equal(f_dec.result(300), host_full[sl]):
                    errors.append("decode mismatch %s" % (avail,))
                with lock:
                    moved[0] += 2 * per_op * K * N
        except Exception as e:  # reported below; the run then fails
            errors.append(repr(e))

    def run_submitters(n_iters: int) -> tuple[float, bool]:
        t0 = time.perf_counter()
        pool = [threading.Thread(target=submitter, args=(t, n_iters))
                for t in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(600)
        return time.perf_counter() - t0, any(t.is_alive() for t in pool)

    before = gf_kernel.LAUNCHES
    run_submitters(2)            # warm the pinned-memory caches
    disp.perf.reset()
    moved[0] = 0
    ops0, disp0 = disp.stats["ops"], disp.stats["dispatches"]
    wall, alive = run_submitters(iters)
    perf = disp.perf.dump()
    disp.shutdown()
    launches_disp = gf_kernel.LAUNCHES - before
    emit("dispatcher", threads=threads, timed_ops=disp.stats["ops"] - ops0,
         timed_dispatches=disp.stats["dispatches"] - disp0,
         ops=disp.stats["ops"], dispatches=disp.stats["dispatches"],
         coalesced=disp.stats["coalesced"], streaming_MBps=moved[0] / wall
         / 1e6, wall_s=wall, h2d_s=perf["l_gpu_h2d"]["sum"],
         compute_s=perf["l_gpu_compute"]["sum"],
         d2h_s=perf["l_gpu_d2h"]["sum"],
         queue_s=perf["l_gpu_dispatch_queue"]["sum"],
         reused=perf["l_gpu_reused"], launches=launches_disp,
         errors=errors[:5])
    check(not alive, "submitters finished")
    check(not errors, "dispatcher results verified")
    check(disp.stats["dispatches"] < disp.stats["ops"], "ops coalesced")
    check(launches_disp > 0, "dispatcher launched the kernel")
    launches = gf_kernel.LAUNCHES

    # -- 5. kernels line --------------------------------------------------
    enc = timings["encode"]
    dec = timings["decode345678910"]
    kernels = [{
        "name": "gf_bitmatrix_encode", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_bitmatrix.cu",
        "replaces": "ceph_tpu/ops/pallas_gf.py:58",
        "launches": launches, "matched": worst == 0, "max_abs_err": worst,
        "ms": enc["ms"], "kernel_ms": enc["ms"],
        "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"], "library_ms": None,
        "decode_ms": dec["ms"], "decode_plain_ms": dec["plain_ms"],
        "decode_bound_ms": dec["bound_ms"],
        "shape": {"bitmat": enc["bitmat"], "data": enc["data"],
                  "decode_bitmat": dec["bitmat"]}}]
    _records.append({"kernels": kernels})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "chip_smoke.jsonl", "w") as f:
        for rec in _records:
            f.write(json.dumps(rec) + "\n")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
