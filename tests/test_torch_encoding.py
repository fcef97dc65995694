"""The port's ``encoding`` against the reference's: the same bytes.

A seeded corpus of values (ints of every size and sign, floats, bytes,
bytearrays, strings, None and booleans, lists, tuples, dicts, sets,
frozensets, numpy arrays and scalars, nesting, and the rows a PG
persists: its log rows and snapsets) encodes to the same bytes in both
packages and decodes back to the value in each; every truncation of an
encoding raises ``DecodeError`` in both, and so do the malformed
payloads the reference's decoder refuses.
"""

import numpy as np
import pytest

from ceph_tpu import encoding as ref
from ceph_tpu_torch import encoding as port


def corpus(seed: int = 20) -> list:
    rng = np.random.default_rng(seed)
    ints = [0, 1, -1, 127, 128, -129, 2 ** 31, -(2 ** 63), 2 ** 70,
            *(int(x) for x in rng.integers(-2 ** 40, 2 ** 40, 8))]
    out = list(ints)
    out += [0.0, -1.5, 3.141592653589793, float("inf"), None, True, False]
    out += [b"", bytes(rng.integers(0, 256, 300, dtype=np.uint8)),
            bytearray(b"\x00\xff" * 7), "", "pg 1.a", "é中"]
    out += [[1, "a", b"b"], (2, (3, (4,))), {"k": [1, 2], 7: None},
            {1, 2, 3}, frozenset({"x", "y"}), [], (), {}]
    out += [rng.integers(0, 256, (4, 5), dtype=np.uint8),
            rng.standard_normal(6).astype(np.float32),
            np.arange(12, dtype=np.int64).reshape(3, 2, 2),
            np.uint32(4000000000), np.int8(-5), np.float64(2.5),
            np.bool_(True)]
    # a PG's durable rows: log entries (pg.py log_operation and
    # _persist_log_full) and a snapset (make_writeable)
    out += [(2, 17, "rbd_data.0001", "modify", 16),
            (3, 18, "obj@4", "delete", 17, "client.4", 99),
            {"seq": 4, "clones": [2, 4], "snaps": {2: [1, 2], 4: [3, 4]},
             "sizes": {2: 4096, 4: 8192}}]
    nested = {"rows": out[-3:], "arr": out[-10], "deep": [[[[1]]]]}
    out.append(nested)
    return out


CORPUS = corpus()


def same(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, dict):
        return type(b) is dict and a.keys() == b.keys() and \
            all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_encoding_equals_the_reference(i):
    v = CORPUS[i]
    blob = port.encode_any(v)
    assert blob == ref.encode_any(v)
    back = port.decode_any(blob)
    want = v.item() if isinstance(v, np.generic) else v
    assert same(back, want) and same(ref.decode_any(blob), back)


@pytest.mark.parametrize("i", range(0, len(CORPUS), 3))
def test_truncation_raises_in_both(i):
    blob = ref.encode_any(CORPUS[i])
    for cut in range(len(blob)):
        with pytest.raises(ref.DecodeError):
            ref.decode_any(blob[:cut])
        with pytest.raises(port.DecodeError):
            port.decode_any(blob[:cut])


@pytest.mark.parametrize("blob", [
    b"\x63",                       # unknown tag
    b"\x06\x02\xff\xfe",           # bad UTF-8
    b"\x09\x01\x07\x00\x00",       # unhashable key (a list)
    b"\x0d\x03bad\x00\x00",        # bogus dtype
    b"\x0b\x03xyz",                # unregistered struct
])
def test_malformed_payloads_raise_in_both(blob):
    with pytest.raises(ref.DecodeError):
        ref.decode_any(blob)
    with pytest.raises(port.DecodeError):
        port.decode_any(blob)


def test_encoders_refuse_alike():
    for bad in (object(), complex(1, 2)):
        with pytest.raises(ref.EncodeError):
            ref.encode_any(bad)
        with pytest.raises(port.EncodeError):
            port.encode_any(bad)
    with pytest.raises(port.EncodeError):
        port.Encoder().varint(-1)
