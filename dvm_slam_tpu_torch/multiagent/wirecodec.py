"""Safe typed value codec — the pickle replacement for untrusted bytes.

The reference exchanges typed DDS/ROS 2 messages: the wire can only carry
the declared message fields, never code (`src/interfaces/msg/*.msg`). This
module restores that property for our transport and checkpoint paths:
a small tagged binary format that round-trips exactly the value shapes the
protocol uses — None/bool/int/float/str/bytes, lists/tuples/dicts of those,
numpy arrays with allowlisted dtypes, and the registered message dataclasses
from `messages.py`. Decoding never executes code and validates every length
against the remaining buffer.

Used by `socket_transport.py` (TCP frames) and `models/system.py`
(atlas checkpoints, `System::SaveAtlas/LoadAtlas` parity).

A copy of `dvm_slam_tpu/multiagent/wirecodec.py`, line for line: the port imports
nothing of the JAX package, and the two copies keep the wire identical.
"""

from __future__ import annotations

import dataclasses
import io
import struct

import numpy as np

from . import messages

_T_NONE = 0
_T_FALSE = 1
_T_TRUE = 2
_T_INT = 3
_T_FLOAT = 4
_T_STR = 5
_T_BYTES = 6
_T_LIST = 7
_T_TUPLE = 8
_T_DICT = 9
_T_NDARRAY = 10
_T_OBJECT = 11

# dtypes a peer may ask us to materialize (mirrors codec._DTYPES + f8)
_DTYPES = {
    0: np.dtype("<u1"), 1: np.dtype("<i4"), 2: np.dtype("<f4"),
    3: np.dtype("<u8"), 4: np.dtype("<i8"), 5: np.dtype("bool"),
    6: np.dtype("<f8"), 7: np.dtype("<u4"),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}

# the only object types the wire may construct (typed-message allowlist)
_REGISTRY = {
    cls.__name__: cls
    for cls in (
        messages.Sim3Transform, messages.KeyFrameBowVector,
        messages.NewKeyFrameBows, messages.NewKeyFrames,
        messages.SuccessfullyMerged, messages.MapToAttemptMerge,
        messages.IsLostFromBaseMap, messages.LoopClosureTriggers,
        messages.ChangeCoordinateFrame, messages.GetCurrentMapRequest,
        messages.GetCurrentMapResponse, messages.GetMapPointsRequest,
        messages.GetMapPointsResponse,
    )
}

_MAX_DEPTH = 32
MAX_DECODED_BYTES = 1 << 30  # 1 GiB hard cap on any single field


def register(cls):
    """Allowlist an additional dataclass for the wire (e.g. test doubles)."""
    _REGISTRY[cls.__name__] = cls
    return cls


def _w_varlen(buf, n: int):
    buf.write(struct.pack("<Q", n))


def _encode(buf: io.BytesIO, v, depth: int):
    if depth > _MAX_DEPTH:
        raise ValueError("wirecodec: value too deeply nested")
    if v is None:
        buf.write(bytes([_T_NONE]))
    elif v is False:
        buf.write(bytes([_T_FALSE]))
    elif v is True:
        buf.write(bytes([_T_TRUE]))
    elif isinstance(v, (int, np.integer)):
        v = int(v)
        nb = max(1, (v.bit_length() + 8) // 8)
        buf.write(bytes([_T_INT, nb]))
        buf.write(v.to_bytes(nb, "little", signed=True))
    elif isinstance(v, (float, np.floating)):
        buf.write(bytes([_T_FLOAT]))
        buf.write(struct.pack("<d", float(v)))
    elif isinstance(v, str):
        b = v.encode()
        buf.write(bytes([_T_STR]))
        _w_varlen(buf, len(b))
        buf.write(b)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        buf.write(bytes([_T_BYTES]))
        _w_varlen(buf, len(b))
        buf.write(b)
    elif isinstance(v, list):
        buf.write(bytes([_T_LIST]))
        _w_varlen(buf, len(v))
        for item in v:
            _encode(buf, item, depth + 1)
    elif isinstance(v, tuple):
        buf.write(bytes([_T_TUPLE]))
        _w_varlen(buf, len(v))
        for item in v:
            _encode(buf, item, depth + 1)
    elif isinstance(v, dict):
        buf.write(bytes([_T_DICT]))
        _w_varlen(buf, len(v))
        for k, item in v.items():
            _encode(buf, k, depth + 1)
            _encode(buf, item, depth + 1)
    elif isinstance(v, np.ndarray):
        arr = np.ascontiguousarray(v)
        dt = (np.dtype("bool") if arr.dtype == bool
              else np.dtype(arr.dtype).newbyteorder("<"))
        code = _DTYPE_CODES[np.dtype(dt)]
        buf.write(bytes([_T_NDARRAY, code, arr.ndim]))
        for d in arr.shape:
            buf.write(struct.pack("<Q", d))
        buf.write(arr.astype(dt, copy=False).tobytes())
    elif dataclasses.is_dataclass(v) and type(v).__name__ in _REGISTRY:
        buf.write(bytes([_T_OBJECT]))
        name = type(v).__name__.encode()
        buf.write(bytes([len(name)]))
        buf.write(name)
        fields = dataclasses.fields(v)
        buf.write(struct.pack("<I", len(fields)))
        for f in fields:
            fn = f.name.encode()
            buf.write(bytes([len(fn)]))
            buf.write(fn)
            _encode(buf, getattr(v, f.name), depth + 1)
    else:
        raise TypeError(f"wirecodec: unsupported type {type(v)!r}")


class _Reader:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, n: int) -> bytes:
        if n < 0 or n > MAX_DECODED_BYTES or self.off + n > len(self.buf):
            raise ValueError("wirecodec: truncated or oversized field")
        out = self.buf[self.off:self.off + n]
        self.off += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]


def _decode(r: _Reader, depth: int):
    if depth > _MAX_DEPTH:
        raise ValueError("wirecodec: value too deeply nested")
    tag = r.u8()
    if tag == _T_NONE:
        return None
    if tag == _T_FALSE:
        return False
    if tag == _T_TRUE:
        return True
    if tag == _T_INT:
        nb = r.u8()
        return int.from_bytes(r.take(nb), "little", signed=True)
    if tag == _T_FLOAT:
        return struct.unpack("<d", r.take(8))[0]
    if tag == _T_STR:
        return r.take(r.u64()).decode()
    if tag == _T_BYTES:
        return r.take(r.u64())
    if tag in (_T_LIST, _T_TUPLE):
        n = r.u64()
        if n > len(r.buf) - r.off:  # each element is >= 1 byte
            raise ValueError("wirecodec: bogus collection length")
        items = [_decode(r, depth + 1) for _ in range(n)]
        return items if tag == _T_LIST else tuple(items)
    if tag == _T_DICT:
        n = r.u64()
        if n > len(r.buf) - r.off:
            raise ValueError("wirecodec: bogus dict length")
        out = {}
        for _ in range(n):
            k = _decode(r, depth + 1)
            if not isinstance(k, (str, int, float, bool, tuple, bytes, type(None))):
                raise ValueError("wirecodec: unhashable dict key")
            out[k] = _decode(r, depth + 1)
        return out
    if tag == _T_NDARRAY:
        code, ndim = r.u8(), r.u8()
        if code not in _DTYPES or ndim > 8:
            raise ValueError("wirecodec: bad array header")
        dims = tuple(r.u64() for _ in range(ndim))
        dt = _DTYPES[code]
        count = 1
        for d in dims:
            count *= d
        nbytes = count * dt.itemsize
        raw = r.take(nbytes)
        return np.frombuffer(raw, dtype=dt, count=count).reshape(dims).copy()
    if tag == _T_OBJECT:
        name = r.take(r.u8()).decode()
        cls = _REGISTRY.get(name)
        if cls is None:
            raise ValueError(f"wirecodec: unregistered message type {name!r}")
        (nf,) = struct.unpack("<I", r.take(4))
        if nf > 64:
            raise ValueError("wirecodec: bogus field count")
        allowed = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for _ in range(nf):
            fn = r.take(r.u8()).decode()
            val = _decode(r, depth + 1)
            if fn in allowed:
                kwargs[fn] = val
        return cls(**kwargs)
    raise ValueError(f"wirecodec: unknown tag {tag}")


def dumps(v) -> bytes:
    buf = io.BytesIO()
    _encode(buf, v, 0)
    return buf.getvalue()


def loads(b: bytes):
    r = _Reader(bytes(b))
    v = _decode(r, 0)
    if r.off != len(r.buf):
        raise ValueError("wirecodec: trailing bytes")
    return v
