"""msgpack's wire format in the standard library.

The compile service writes msgpack in three places: the plan record
(``codec.encode_plan``), the sha256 payloads of the request key
(``canonical``) and the cache record's wrapper (``cache``).  The machine
with the GPU has no msgpack package, so this module writes and reads the
format itself.

:func:`packb` writes exactly what ``msgpack.packb(obj, use_bin_type=True)``
writes, byte for byte, for the types the service uses:

* ``None``, ``True``, ``False`` (tested before int, as msgpack does: a
  ``bool`` is an ``int``);
* ``int`` and its subclasses in the smallest format: positive fixint,
  uint8/16/32/64 for values >= 0, negative fixint, int8/16/32/64 below 0;
  outside [-2**63, 2**64) ``OverflowError``;
* ``float`` and its subclasses (``numpy.float64`` among them) as float64;
* ``str`` as fixstr / str8 / str16 / str32 by its UTF-8 length;
* ``bytes``, ``bytearray``, ``memoryview`` as bin8 / bin16 / bin32;
* ``list`` and ``tuple`` as fixarray / array16 / array32;
* ``dict`` as fixmap / map16 / map32, in insertion order.

Anything else raises ``TypeError``, as msgpack does for ``numpy.int64``,
``numpy.bool_`` or ``numpy.float32``.

:func:`unpackb` reads every format :func:`packb` writes, and float32, as
``msgpack.unpackb(data, raw=False)`` reads them: arrays as lists, str as
``str``, bin as ``bytes``.  It raises ``ValueError`` on truncated input, on
bytes left after the object (msgpack's ``ExtraData``), on ext types and
reserved bytes, and on a map key that is neither str nor bytes (msgpack's
``strict_map_key``).
"""
from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]

_U8, _U16, _U32, _U64 = (struct.Struct(f">B{c}").pack for c in "BHIQ")
_I8, _I16, _I32, _I64 = (struct.Struct(f">B{c}").pack for c in "bhiq")
_F64 = struct.Struct(">Bd").pack


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes (``use_bin_type=True``)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, c8, c16,
              c32) -> None:
    """A length header: ``fix | n`` up to ``fix_max``, then the 8-bit (if
    the type has one), 16-bit and 32-bit forms."""
    if n <= fix_max:
        out.append(fix | n)
    elif c8 is not None and n <= 0xFF:
        out += _U8(c8, n)
    elif n <= 0xFFFF:
        out += _U16(c16, n)
    elif n <= 0xFFFFFFFF:
        out += _U32(c32, n)
    else:
        raise ValueError(f"object of length {n} is too large for msgpack")


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v <= 0xFF:
            out += _U8(0xCC, v)
        elif v <= 0xFFFF:
            out += _U16(0xCD, v)
        elif v <= 0xFFFFFFFF:
            out += _U32(0xCE, v)
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out += _U64(0xCF, v)
        else:
            raise OverflowError(f"int {v} too large for msgpack (>= 2**64)")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -0x80:
        out += _I8(0xD0, v)
    elif v >= -0x8000:
        out += _I16(0xD1, v)
    elif v >= -0x80000000:
        out += _I32(0xD2, v)
    elif v >= -0x8000000000000000:
        out += _I64(0xD3, v)
    else:
        raise OverflowError(f"int {v} too small for msgpack (< -2**63)")


def _pack(obj, out: bytearray) -> None:
    # the order of msgpack's own packer: None and the two bools by
    # identity, then int, float, bin, str, map, array
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += _F64(0xCB, obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = obj.tobytes() if isinstance(obj, memoryview) else obj
        _pack_len(out, len(raw), 0, -1, 0xC4, 0xC5, 0xC6)
        out += raw
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, 0xD9, 0xDA, 0xDB)
        out += raw
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, None, 0xDE, 0xDF)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, None, 0xDC, 0xDD)
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


# ------------------------------------------------------------------ reading
# fixed-size formats: lead byte -> (struct, size)
_FIXED = {0xCA: struct.Struct(">f"), 0xCB: struct.Struct(">d"),
          0xCC: struct.Struct(">B"), 0xCD: struct.Struct(">H"),
          0xCE: struct.Struct(">I"), 0xCF: struct.Struct(">Q"),
          0xD0: struct.Struct(">b"), 0xD1: struct.Struct(">h"),
          0xD2: struct.Struct(">i"), 0xD3: struct.Struct(">q")}
# length-prefixed formats: lead byte -> (kind, struct of the length)
_SIZED = {0xC4: ("bin", _FIXED[0xCC]), 0xC5: ("bin", _FIXED[0xCD]),
          0xC6: ("bin", _FIXED[0xCE]), 0xD9: ("str", _FIXED[0xCC]),
          0xDA: ("str", _FIXED[0xCD]), 0xDB: ("str", _FIXED[0xCE]),
          0xDC: ("array", _FIXED[0xCD]), 0xDD: ("array", _FIXED[0xCE]),
          0xDE: ("map", _FIXED[0xCD]), 0xDF: ("map", _FIXED[0xCE])}


def unpackb(data):
    """The object of one msgpack message (``raw=False``): ``ValueError``
    on truncated input, trailing bytes, ext types, reserved bytes and map
    keys other than str or bytes."""
    data = bytes(data)
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"extra data: {len(data) - end} bytes after the "
                         f"object")
    return obj


def _take(data: bytes, i: int, n: int) -> bytes:
    if i + n > len(data):
        raise ValueError("unpack failed: incomplete input")
    return data[i:i + n]


def _unpack(data: bytes, i: int):
    if i >= len(data):
        raise ValueError("unpack failed: incomplete input")
    b = data[i]
    i += 1
    if b <= 0x7F:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b <= 0x9F:
        kind, n = "array", b & 0x0F
    elif 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif b == 0xC0:
        return None, i
    elif b == 0xC2:
        return False, i
    elif b == 0xC3:
        return True, i
    elif b in _FIXED:
        st = _FIXED[b]
        return st.unpack(_take(data, i, st.size))[0], i + st.size
    elif b in _SIZED:
        kind, st = _SIZED[b]
        n = st.unpack(_take(data, i, st.size))[0]
        i += st.size
    elif 0xC7 <= b <= 0xC9 or 0xD4 <= b <= 0xD8:
        raise ValueError(f"ext type 0x{b:02x} is not supported")
    else:
        raise ValueError(f"reserved byte 0x{b:02x}")
    if kind == "str":
        return _take(data, i, n).decode("utf-8"), i + n
    if kind == "bin":
        return _take(data, i, n), i + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, i = _unpack(data, i)
            items.append(v)
        return items, i
    out = {}
    for _ in range(n):
        k, i = _unpack(data, i)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map "
                             f"key")
        out[k], i = _unpack(data, i)
    return out, i
