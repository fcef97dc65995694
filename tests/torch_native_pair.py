"""Both packages' native runtimes in one process, loaded in a given order.

    python tests/torch_native_pair.py ref_first|port_first

Loads the reference's runtime (``ceph_tpu.native``, opened RTLD_GLOBAL)
and the port's (``ceph_tpu_torch.native``, opened RTLD_LOCAL) in that
order, creates and encodes a ``jerasure`` codec in each right after
loading it, then drives each bridge: the port's through
``install_cuda_dispatcher(device="cpu")``, the reference's through a
plain ctypes dispatcher that writes the reference codec's parity (so no
JAX is needed). Prints one JSON object of what it saw; the isolation
test asserts on it.
"""

import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, M = 4, 2
PROFILE = {"technique": "reed_sol_van", "k": str(K), "m": str(M), "w": "8"}


def run(order: str) -> dict:
    sys.path.insert(0, ROOT)
    import ceph_tpu.native as rn
    import ceph_tpu_torch.native as pn

    data = bytes(range(256)) * 40 + b"tail"
    enc = {}
    for name in (("ref", "port") if order == "ref_first"
                 else ("port", "ref")):
        mod = rn if name == "ref" else pn
        enc[name] = mod.NativeCodec("jerasure", dict(PROFILE)).encode(data)
    chunks = [enc["ref"][i] for i in range(K)]
    parity = [enc["ref"][K + j] for j in range(M)]

    ref_codec = rn.NativeCodec("jerasure", dict(PROFILE))
    ref_calls = []

    def ref_dispatch(reqs_ptr, count, _user):
        reqs = ctypes.cast(reqs_ptr,
                           ctypes.POINTER(rn._ECRequest * count)).contents
        for req in reqs:
            bs = int(req.blocksize)
            out = ref_codec.encode(b"".join(
                ctypes.string_at(req.data[j], bs) for j in range(K)))
            for j in range(M):
                ctypes.memmove(req.parity[j], out[K + j], bs)
        ref_calls.append(count)
        return 0

    thunk = rn._DISPATCH_CFUNC(ref_dispatch)
    RL, PL = rn.lib(), pn.lib()
    RL.ec_tpu_register_dispatcher(thunk, None, 8, 0)
    pn.install_cuda_dispatcher(max_batch=8, max_delay_us=0, device="cpu")

    def counts():
        return [RL.ec_tpu_batches_dispatched(),
                PL.ec_tpu_batches_dispatched()]

    c0 = counts()
    port_parity = pn.bridge_encode(K, M, 8, "reed_sol_van", chunks)
    c1 = counts()
    ref_parity = rn.bridge_encode(K, M, 8, "reed_sol_van", chunks)
    c2 = counts()
    pn.uninstall_dispatcher()
    RL.ec_tpu_unregister_dispatcher()

    renamed = pn.renamed_symbols()
    cdll = pn.lib()._cdll
    maps = open("/proc/self/maps").read()
    return {
        "order": order,
        "port_equals_ref": enc["port"] == enc["ref"],
        "port_parity_ok": port_parity == parity,
        "ref_parity_ok": ref_parity == parity,
        "after_port_bridge": [c1[0] - c0[0], c1[1] - c0[1]],
        "after_ref_bridge": [c2[0] - c1[0], c2[1] - c1[1]],
        "ref_dispatcher_calls": len(ref_calls),
        "renamed": len(renamed),
        "exported_renamed": [s for s in renamed if hasattr(cdll, s)],
        "prefixed_missing": [s for s in renamed
                             if not hasattr(cdll, pn.SYMBOL_PREFIX + s)],
        "ref_plugin_mapped": str(rn.BUILD_DIR) + "/libec_jerasure.so" in maps,
        "port_plugin_mapped":
            str(pn.BUILD_DIR) + "/libec_jerasure.so" in maps,
    }


if __name__ == "__main__":
    print(json.dumps(run(sys.argv[1])))
