"""Round-trip and property tests for the format primitives."""

import io

import numpy as np
import pytest

from jampack_jax.format.checksum import integrity_check
from jampack_jax.format.framing import read_block, write_block
from jampack_jax.format.tables import EXPONENT, LOG, MANTISSA, MODEL_ALPHABET
from jampack_jax.format.varint import (
    CONSTANTS,
    decode_leb128,
    encode_leb128,
    size_of_value,
)


def test_tables_match_reference_luts():
    # spot values from tables.hpp
    assert LOG[0] == 0 and LOG[1] == 0 and LOG[2] == 1 and LOG[3] == 1
    assert LOG[16] == 4 and LOG[255] == 7 and LOG[256] == 7
    assert MANTISSA[0] == 0 and MANTISSA[1] == 1 and MANTISSA[6] == 2
    assert MANTISSA[256] == 128
    assert list(MODEL_ALPHABET) == [2, 2, 4, 8, 16, 32, 64, 129]
    # reconstruction identity
    s = np.arange(257)
    assert (EXPONENT[LOG[s]] + MANTISSA[s] == s).all()


@pytest.mark.parametrize(
    "val",
    [0, 1, 126, 127, 128, 1000, 16509, 16510, 16511, 2113661, 2113662,
     270549115, 270549116, 2**31 - 1],
)
def test_varint_roundtrip(val):
    enc = encode_leb128(val)
    assert len(enc) == size_of_value(val)
    dec, pos = decode_leb128(enc)
    assert dec == val and pos == len(enc)


def test_varint_ranges_are_disjoint():
    # the length boundaries are exactly the cumulative constants
    for i, c in enumerate(CONSTANTS):
        assert len(encode_leb128(c - 1)) == i + 1
        assert len(encode_leb128(c)) == i + 2


def test_varint_stream():
    vals = [0, 5, 127, 300, 65000, 123456789]
    buf = b"".join(encode_leb128(v) for v in vals)
    pos = 0
    out = []
    while pos < len(buf):
        v, pos = decode_leb128(buf, pos)
        out.append(v)
    assert out == vals


def test_checksum_reference_values():
    # hand-computed against the C algorithm semantics
    assert integrity_check(b"") == 3
    # one byte: S0 = 3 ^ ((97 + (1<<(3&7))) * 0x9E3779B1) mod 2^32
    v = (3 ^ (((97 + 8) * 0x9E3779B1) & 0xFFFFFFFF))
    assert integrity_check(b"a") == v


def test_checksum_sizes_and_determinism():
    rng = np.random.default_rng(0)
    for size in [0, 1, 15, 16, 17, 31, 32, 33, 100, 1000]:
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        assert integrity_check(data) == integrity_check(data)
        assert 0 <= integrity_check(data) < 2**32


def test_framing_roundtrip():
    payload = b"hello world" * 10
    buf = io.BytesIO()
    write_block(buf, 0xDEADBEEF, payload, 8 << 20)
    write_block(buf, 1, b"", 1 << 20)
    buf.seek(0)
    h1, p1 = read_block(buf)
    assert h1.crc == 0xDEADBEEF and p1 == payload and h1.blocksize == 8 << 20
    h2, p2 = read_block(buf)
    assert h2.crc == 1 and p2 == b""
    assert read_block(buf) is None


def test_framing_rejects_corrupt():
    buf = io.BytesIO(b"XAM" + b"\x00" * 12)
    with pytest.raises(ValueError):
        read_block(buf)
