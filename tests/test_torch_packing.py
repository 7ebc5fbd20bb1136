"""The port's standard-library msgpack codec (``repro_torch.service.
packing``) against the msgpack package, which is installed on this host:
``packb`` byte for byte against ``msgpack.packb(..., use_bin_type=True)``
at every format boundary, ``unpackb`` against ``msgpack.unpackb(...,
raw=False)``, and the same refusals."""
import math
import struct

import msgpack
import numpy as np
import pytest

from hypothesis_compat import given, settings, st
from repro_torch.service.packing import packb, unpackb
import torch_parity

torch_parity.one_thread()


def ref_packb(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


INTS = [0, 1, 127, 128, 255, 256, 2 ** 16 - 1, 2 ** 16, 2 ** 32 - 1,
        2 ** 32, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, -1, -32, -33, -128, -129,
        -2 ** 15, -2 ** 15 - 1, -2 ** 31, -2 ** 31 - 1, -2 ** 63]


@pytest.mark.parametrize("v", INTS, ids=str)
def test_ints_in_the_smallest_format(v):
    assert packb(v) == ref_packb(v)
    assert unpackb(packb(v)) == v


@pytest.mark.parametrize("v", [None, True, False])
def test_nil_and_bools_before_int(v):
    assert packb(v) == ref_packb(v)
    assert unpackb(packb(v)) is v
    assert packb(True) != packb(1) and packb(False) != packb(0)


@pytest.mark.parametrize("v", [0.0, -0.0, 1.5, -2.25, 1e308, 5e-324,
                               math.inf, -math.inf, math.nan,
                               np.float64(0.1)], ids=repr)
def test_float64_and_its_subclasses(v):
    raw = packb(v)
    assert raw == ref_packb(v) and raw[0] == 0xCB and len(raw) == 9
    back = unpackb(raw)
    assert type(back) is float
    assert struct.pack(">d", back) == struct.pack(">d", float(v))


def test_float32_is_read():
    raw = b"\xca" + struct.pack(">f", 1.1)
    assert unpackb(raw) == msgpack.unpackb(raw) == struct.unpack(">f",
                                                                 raw[1:])[0]


@pytest.mark.parametrize("n", [0, 1, 31, 32, 255, 256, 65535, 65536])
def test_str_lengths(n):
    s = "x" * n
    assert packb(s) == ref_packb(s)
    assert unpackb(packb(s)) == s
    multi = "é" * (n // 2)                # UTF-8 length, not characters
    assert packb(multi) == ref_packb(multi)
    assert unpackb(packb(multi)) == multi


@pytest.mark.parametrize("n", [0, 1, 255, 256, 65535, 65536])
def test_bin_lengths(n):
    b = bytes(range(256)) * (n // 256) + bytes(n % 256)
    for v in (b, bytearray(b), memoryview(b)):
        assert packb(v) == ref_packb(v)
    back = unpackb(packb(b))
    assert type(back) is bytes and back == b
    wide = memoryview(np.arange(6, dtype=np.uint32))       # its bytes
    assert packb(wide) == ref_packb(wide)


@pytest.mark.parametrize("n", [0, 15, 16, 65535, 65536])
def test_array_and_map_lengths(n):
    arr = list(range(n))
    assert packb(arr) == ref_packb(arr) == packb(tuple(arr))
    assert unpackb(packb(arr)) == arr
    m = {f"k{i}": i for i in range(n)}
    assert packb(m) == ref_packb(m)
    assert unpackb(packb(m)) == m


def test_map_keeps_insertion_order_and_nesting():
    obj = {"z": [1, {"y": b"\x00", "a": None}], "a": (2.5, -7, "s"),
           b"k": {"": [[], {}]}}
    assert packb(obj) == ref_packb(obj)
    assert unpackb(packb(obj)) == msgpack.unpackb(ref_packb(obj), raw=False)


@pytest.mark.parametrize("v", [np.int64(1), np.int32(-3), np.bool_(True),
                               np.float32(1.0), object(), {1, 2}, 1j],
                         ids=lambda v: type(v).__name__)
def test_refuses_what_msgpack_refuses(v):
    with pytest.raises(TypeError):
        ref_packb(v)
    with pytest.raises(TypeError):
        packb(v)
    with pytest.raises(TypeError):
        packb({"nested": [v]})


@pytest.mark.parametrize("v", [2 ** 64, -2 ** 63 - 1, 10 ** 30])
def test_int_out_of_range_overflows(v):
    with pytest.raises(OverflowError):
        ref_packb(v)
    with pytest.raises(OverflowError):
        packb(v)


def test_unpack_refuses_trailing_truncated_ext_and_reserved():
    good = packb({"a": [1, 2, 3], "b": "xyz"})
    with pytest.raises(ValueError, match="extra data"):
        unpackb(good + b"\x00")
    with pytest.raises(msgpack.ExtraData):
        msgpack.unpackb(good + b"\x00")
    for cut in range(len(good)):
        with pytest.raises(ValueError):
            unpackb(good[:cut])
        with pytest.raises(ValueError):
            msgpack.unpackb(good[:cut])
    for ext in (b"\xd4\x01\x00", b"\xc7\x01\x05\x00",
                msgpack.packb(msgpack.ExtType(3, b"abc"))):
        with pytest.raises(ValueError, match="ext"):
            unpackb(ext)
    with pytest.raises(ValueError, match="reserved"):
        unpackb(b"\xc1")
    with pytest.raises(ValueError):
        unpackb(b"\xd9\x05ab")                # str8 cut short


@pytest.mark.parametrize("key", [1, None, 2.5, True, [1]], ids=repr)
def test_unpack_refuses_map_keys_that_are_not_str_or_bytes(key):
    raw = b"\x81" + ref_packb(key) + b"\x00"
    with pytest.raises(ValueError):
        msgpack.unpackb(raw, raw=False)
    with pytest.raises(ValueError, match="map key"):
        unpackb(raw)


def test_unpack_accepts_bytes_like_input():
    raw = packb([1, "a", b"b"])
    assert unpackb(bytearray(raw)) == unpackb(memoryview(raw)) == [1, "a",
                                                                   b"b"]


_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=40)
            | st.binary(max_size=40))
_values = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text(max_size=10) | st.binary(
                       max_size=10), inner, max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_values)
def test_round_trip_of_nested_values(obj):
    raw = packb(obj)
    assert raw == ref_packb(obj)
    assert unpackb(raw) == msgpack.unpackb(raw, raw=False)
