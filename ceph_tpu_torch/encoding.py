"""Versioned binary encoding — the wire/at-rest serialization seam.

Role of the reference's src/include/encoding.h + denc.h: every message
and every stored payload is encoded with explicit little-endian
primitives wrapped in ENCODE_START/DECODE_START framing — `u8 struct_v,
u8 compat_v, u32 length` — so newer encoders may append fields that
older decoders skip (forward compat), and older payloads decode with
defaults for fields they predate (backward compat). A decoder that sees
`compat_v` newer than the version it understands refuses the payload,
exactly like the reference's DECODE_START version gate.

Two layers:

1. **Primitives** — Encoder/Decoder with u8..u64, varint/svarint,
   float64, bytes, str, plus a tagged `any` codec for heterogeneous
   containers. `any` constructs ONLY a closed set of builtins and
   *registered* struct types — there is no arbitrary-object execution
   (unlike pickle), so inbound frames are safe to parse even before a
   connection authenticates. A `restricted` decode mode additionally
   refuses registered-struct construction, for pre-auth banner frames.

2. **Structs** — classes registered with @encodable carry a
   (version, compat) pair and encode their fields inside a versioned
   frame. Dataclasses derive field order automatically: appending new
   fields (with defaults) IS the version bump; old payloads simply
   stop early and the new fields keep their defaults.

Port of ``ceph_tpu/encoding.py``, host code the port keeps its own
copy of: the same tags and framing, so the port writes the bytes the
reference writes (the PG log rows and snapsets a PG persists among
them). Its struct registrations (``codecs.py``) and the dencoder tool
wait for the messenger's slice, which brings the addresses they name.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = [
    "Encoder", "Decoder", "EncodeError", "DecodeError",
    "encodable", "register_codec", "encode", "decode",
    "encode_any", "decode_any", "registered_types",
]


class EncodeError(Exception):
    pass


class DecodeError(Exception):
    pass


_F64 = struct.Struct("<d")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

# -- any() tags ---------------------------------------------------------

_T_NONE = 0
_T_FALSE = 1
_T_TRUE = 2
_T_INT = 3          # svarint
_T_FLOAT = 4        # f64
_T_BYTES = 5
_T_STR = 6
_T_LIST = 7
_T_TUPLE = 8
_T_DICT = 9
_T_SET = 10
_T_STRUCT = 11      # registered type: name + versioned frame
_T_BYTEARRAY = 12
_T_NDARRAY = 13     # dtype str, ndim, shape..., raw C-order bytes
_T_FROZENSET = 14

# name -> (cls, version, compat, encode_fields, decode_fields)
_REGISTRY: dict[str, tuple] = {}
# cls -> name (fast path on encode)
_BY_CLASS: dict[type, str] = {}


def registered_types() -> list[str]:
    return sorted(_REGISTRY)


class Encoder:
    def __init__(self):
        self.buf = bytearray()

    # primitives

    def u8(self, v: int) -> None:
        self.buf.append(v & 0xFF)

    def u16(self, v: int) -> None:
        self.buf += _U16.pack(v & 0xFFFF)

    def u32(self, v: int) -> None:
        self.buf += _U32.pack(v & 0xFFFFFFFF)

    def u64(self, v: int) -> None:
        self.buf += _U64.pack(v & 0xFFFFFFFFFFFFFFFF)

    def varint(self, v: int) -> None:
        if v < 0:
            raise EncodeError("varint of negative %d" % v)
        buf = self.buf
        while v >= 0x80:
            buf.append((v & 0x7F) | 0x80)
            v >>= 7
        buf.append(v)

    def svarint(self, v: int) -> None:
        # zigzag; exact for unbounded Python ints
        self.varint(v << 1 if v >= 0 else ((-v) << 1) - 1)

    def float64(self, v: float) -> None:
        self.buf += _F64.pack(v)

    def bool_(self, v: bool) -> None:
        self.buf.append(1 if v else 0)

    def bytes_(self, v) -> None:
        self.varint(len(v))
        self.buf += v

    def str_(self, v: str) -> None:
        self.bytes_(v.encode("utf-8"))

    # versioned framing (ENCODE_START / ENCODE_FINISH)

    def start(self, version: int, compat: int) -> int:
        """Open a versioned frame; returns a token for finish()."""
        self.u8(version)
        self.u8(compat)
        self.u32(0)                  # length placeholder
        return len(self.buf)

    def finish(self, token: int) -> None:
        length = len(self.buf) - token
        self.buf[token - 4:token] = _U32.pack(length)

    # tagged heterogeneous value

    def any(self, v) -> None:
        buf = self.buf
        if v is None:
            buf.append(_T_NONE)
        elif v is True:
            buf.append(_T_TRUE)
        elif v is False:
            buf.append(_T_FALSE)
        elif type(v) is int:
            buf.append(_T_INT)
            self.svarint(v)
        elif type(v) is float:
            buf.append(_T_FLOAT)
            buf += _F64.pack(v)
        elif type(v) is bytes:
            buf.append(_T_BYTES)
            self.bytes_(v)
        elif type(v) is str:
            buf.append(_T_STR)
            self.str_(v)
        elif type(v) is list:
            buf.append(_T_LIST)
            self.varint(len(v))
            for item in v:
                self.any(item)
        elif type(v) is tuple:
            buf.append(_T_TUPLE)
            self.varint(len(v))
            for item in v:
                self.any(item)
        elif type(v) is dict:
            buf.append(_T_DICT)
            self.varint(len(v))
            for k, item in v.items():
                self.any(k)
                self.any(item)
        elif type(v) is bytearray:
            buf.append(_T_BYTEARRAY)
            self.bytes_(v)
        elif type(v) is set:
            buf.append(_T_SET)
            self.varint(len(v))
            for item in v:
                self.any(item)
        elif type(v) is frozenset:
            buf.append(_T_FROZENSET)
            self.varint(len(v))
            for item in v:
                self.any(item)
        elif isinstance(v, np.ndarray):
            buf.append(_T_NDARRAY)
            self.str_(str(v.dtype))
            self.varint(v.ndim)
            for d in v.shape:
                self.varint(d)
            self.bytes_(np.ascontiguousarray(v).tobytes())
        elif isinstance(v, np.bool_):
            buf.append(_T_TRUE if v else _T_FALSE)
        elif isinstance(v, np.integer):
            buf.append(_T_INT)
            self.svarint(int(v))
        elif isinstance(v, np.floating):
            buf.append(_T_FLOAT)
            buf += _F64.pack(float(v))
        elif isinstance(v, int):        # bool handled above; int subclass
            buf.append(_T_INT)
            self.svarint(int(v))
        else:
            name = _struct_name_for(v)
            if name is None:
                raise EncodeError("unencodable type %s" % type(v).__name__)
            buf.append(_T_STRUCT)
            self.str_(name)
            _encode_struct(self, name, v)

    def getvalue(self) -> bytes:
        return bytes(self.buf)


def _struct_name_for(v) -> str | None:
    return _BY_CLASS.get(type(v))


class Decoder:
    MAX_DEPTH = 100      # nesting bound: malformed frames can't blow
                         # the interpreter stack

    def __init__(self, data, restricted: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self._depth = 0
        # restricted decoding refuses registered-struct construction —
        # for pre-auth frames, only closed-set builtins may materialize
        self.restricted = restricted

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise DecodeError("truncated: need %d at %d/%d"
                              % (n, self.pos, len(self.data)))

    def u8(self) -> int:
        self._need(1)
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        self._need(2)
        v = _U16.unpack_from(self.data, self.pos)[0]
        self.pos += 2
        return v

    def u32(self) -> int:
        self._need(4)
        v = _U32.unpack_from(self.data, self.pos)[0]
        self.pos += 4
        return v

    def u64(self) -> int:
        self._need(8)
        v = _U64.unpack_from(self.data, self.pos)[0]
        self.pos += 8
        return v

    def varint(self) -> int:
        shift = 0
        v = 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 640:
                raise DecodeError("runaway varint")

    def svarint(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def float64(self) -> float:
        self._need(8)
        v = _F64.unpack_from(self.data, self.pos)[0]
        self.pos += 8
        return v

    def bool_(self) -> bool:
        return self.u8() != 0

    def bytes_(self) -> bytes:
        n = self.varint()
        self._need(n)
        v = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return v

    def str_(self) -> str:
        return self.bytes_().decode("utf-8")

    # versioned framing (DECODE_START / DECODE_FINISH)

    def start(self, supported: int) -> tuple[int, int]:
        """Returns (struct_v, frame_end). Raises if the payload says
        decoders older than `compat_v` cannot read it and we are one."""
        struct_v = self.u8()
        compat_v = self.u8()
        length = self.u32()
        if compat_v > supported:
            raise DecodeError(
                "payload requires version >= %d, have %d"
                % (compat_v, supported))
        end = self.pos + length
        if end > len(self.data):
            raise DecodeError("frame overruns buffer")
        return struct_v, end

    def finish(self, end: int) -> None:
        if self.pos > end:
            raise DecodeError("frame overread")
        self.pos = end              # skip fields newer than us

    def any(self):
        self._depth += 1
        if self._depth > self.MAX_DEPTH:
            raise DecodeError("nesting exceeds %d" % self.MAX_DEPTH)
        try:
            return self._any()
        finally:
            self._depth -= 1

    def _any(self):
        tag = self.u8()
        if tag == _T_NONE:
            return None
        if tag == _T_TRUE:
            return True
        if tag == _T_FALSE:
            return False
        if tag == _T_INT:
            return self.svarint()
        if tag == _T_FLOAT:
            return self.float64()
        if tag == _T_BYTES:
            return self.bytes_()
        if tag == _T_STR:
            return self.str_()
        if tag == _T_LIST:
            return [self.any() for _ in range(self.varint())]
        if tag == _T_TUPLE:
            return tuple(self.any() for _ in range(self.varint()))
        if tag == _T_DICT:
            out = {}
            for _ in range(self.varint()):
                k = self.any()
                out[k] = self.any()
            return out
        if tag == _T_SET:
            return {self.any() for _ in range(self.varint())}
        if tag == _T_FROZENSET:
            return frozenset(self.any() for _ in range(self.varint()))
        if tag == _T_BYTEARRAY:
            return bytearray(self.bytes_())
        if tag == _T_NDARRAY:
            dtype = np.dtype(self.str_())
            shape = tuple(self.varint() for _ in range(self.varint()))
            raw = self.bytes_()
            return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
        if tag == _T_STRUCT:
            if self.restricted:
                raise DecodeError("struct decode refused (restricted)")
            name = self.str_()
            return _decode_struct(self, name)
        raise DecodeError("unknown tag %d" % tag)


# -- struct registry ----------------------------------------------------

def register_codec(name: str, cls, version: int, compat: int,
                   encode_fields, decode_fields) -> None:
    """encode_fields(enc, obj); decode_fields(dec, struct_v, end) -> obj.
    decode_fields must tolerate the frame ending early (older payload):
    check dec.pos < end before each optional trailing field."""
    if name in _REGISTRY:
        raise EncodeError("codec %r already registered" % name)
    _REGISTRY[name] = (cls, version, compat, encode_fields, decode_fields)
    _BY_CLASS[cls] = name


def _encode_struct(enc: Encoder, name: str, obj) -> None:
    _, version, compat, encode_fields, _ = _REGISTRY[name]
    token = enc.start(version, compat)
    encode_fields(enc, obj)
    enc.finish(token)


def _decode_struct(dec: Decoder, name: str):
    entry = _REGISTRY.get(name)
    if entry is None:
        raise DecodeError("unknown struct type %r" % name)
    cls, version, _, _, decode_fields = entry
    struct_v, end = dec.start(version)
    obj = decode_fields(dec, struct_v, end)
    dec.finish(end)
    return obj


def encodable(name: str, version: int = 1, compat: int = 1,
              fields: list[str] | None = None):
    """Class decorator: register a dataclass (or any class with
    declared `fields`) for versioned encoding.

    Field order is the version contract: appending new fields (which
    must have defaults) is the compatible version bump. Decoding an
    older payload stops at the frame end and leaves newer fields at
    their constructor defaults; decoding a newer payload skips the
    trailing unknown fields (DECODE_FINISH semantics).
    """
    def wrap(cls):
        import dataclasses
        if fields is not None:
            names = list(fields)

            def make(kw):
                obj = cls.__new__(cls)
                obj.__init__()
                for k, v in kw.items():
                    setattr(obj, k, v)
                return obj
        elif dataclasses.is_dataclass(cls):
            names = [f.name for f in dataclasses.fields(cls)]

            def make(kw):
                return cls(**kw)
        else:
            raise EncodeError(
                "%s: not a dataclass and no fields declared" % cls)

        def encode_fields(enc, obj):
            for fname in names:
                enc.any(getattr(obj, fname))

        def decode_fields(dec, struct_v, end):
            kw = {}
            for fname in names:
                if dec.pos >= end:
                    break               # older payload: defaults apply
                kw[fname] = dec.any()
            return make(kw)

        register_codec(name, cls, version, compat,
                       encode_fields, decode_fields)
        cls._denc_name = name
        return cls
    return wrap


# -- top level ----------------------------------------------------------

def encode_any(v) -> bytes:
    enc = Encoder()
    enc.any(v)
    return enc.getvalue()


def decode_any(data, restricted: bool = False):
    """Decode one tagged value. Every failure mode of a malformed or
    hostile payload — bad UTF-8, unhashable dict keys, bogus dtypes,
    a registered type's constructor refusing the fields — surfaces as
    DecodeError, so callers need exactly one except clause."""
    dec = Decoder(data, restricted=restricted)
    try:
        return dec.any()
    except DecodeError:
        raise
    except Exception as e:
        raise DecodeError("malformed payload: %s: %s"
                          % (type(e).__name__, e)) from e


def encode(v) -> bytes:
    """Alias of encode_any — the module's default entry point."""
    return encode_any(v)


def decode(data):
    return decode_any(data)
