"""Full-pipeline round trip and cross-validation against the reference binary.

The cross tests are the real format spec: archives produced by the compiled
reference must decode bit-exactly here, and archives produced here must
decode bit-exactly in the reference.
"""

import io

import numpy as np
import pytest

from jampack_jax.runtime.pipeline import (
    Options,
    compress_block,
    compress_stream,
    decompress_block,
    decompress_stream,
)

RNG = np.random.default_rng(123)


def sample_inputs():
    text = (
        b"It was the best of times, it was the worst of times, it was the age "
        b"of wisdom, it was the age of foolishness, it was the epoch of belief, "
    )
    yield "text", np.frombuffer(text * 400, dtype=np.uint8)
    yield "zeros", np.zeros(70000, dtype=np.uint8)
    yield "random", RNG.integers(0, 256, 60000, dtype=np.uint8)
    yield "struct", ((np.arange(65536) // 4) % 251).astype(np.uint8)
    yield "tiny", np.frombuffer(b"abc", dtype=np.uint8)
    yield "repeats", np.tile(RNG.integers(0, 256, 997, dtype=np.uint8), 70)


@pytest.mark.parametrize("name,data", list(sample_inputs()))
def test_block_roundtrip(name, data):
    opt = Options(filters=1)
    crc, payload = compress_block(data, opt)
    out = decompress_block(payload, crc)
    assert np.array_equal(out, data)


def test_stream_roundtrip_multiblock():
    data = RNG.integers(0, 256, (1 << 20) + 12345, dtype=np.uint8).tobytes()
    src, dst, back = io.BytesIO(data), io.BytesIO(), io.BytesIO()
    compress_stream(src, dst, Options(blocksize=1 << 20, filters=0))
    dst.seek(0)
    decompress_stream(dst, back)
    assert back.getvalue() == data


def test_corrupt_block_detected():
    data = np.frombuffer(b"hello hello hello hello " * 100, dtype=np.uint8)
    crc, payload = compress_block(data, Options())
    with pytest.raises(ValueError):
        decompress_block(payload, crc ^ 1)


@pytest.mark.parametrize("name,data", list(sample_inputs()))
def test_ref_encodes_we_decode(tmp_path, oracle, name, data):
    """Reference-produced archives must decode bit-exactly here."""
    raw = tmp_path / "in.bin"
    jam = tmp_path / "out.jam"
    raw.write_bytes(data.tobytes())
    oracle.compress(raw, jam)
    out = io.BytesIO()
    with open(jam, "rb") as f:
        decompress_stream(f, out)
    assert out.getvalue() == data.tobytes()


@pytest.mark.parametrize("name,data", list(sample_inputs()))
@pytest.mark.parametrize("filters", [0, 1])
def test_we_encode_ref_decodes(tmp_path, oracle, name, data, filters):
    """Our archives must decode bit-exactly in the reference binary."""
    jam = tmp_path / "ours.jam"
    back = tmp_path / "back.bin"
    with open(jam, "wb") as f:
        compress_stream(io.BytesIO(data.tobytes()), f, Options(filters=filters))
    oracle.decompress(jam, back)
    assert back.read_bytes() == data.tobytes()


@pytest.mark.parametrize("fopt", ["-f0", "-f1", "-f2"])
def test_ref_filter_modes_cross_decode(tmp_path, oracle, fopt):
    data = ((np.arange(150000) // 3) % 256).astype(np.uint8)
    raw = tmp_path / "in.bin"
    jam = tmp_path / "out.jam"
    raw.write_bytes(data.tobytes())
    oracle.compress(raw, jam, fopt)
    out = io.BytesIO()
    with open(jam, "rb") as f:
        decompress_stream(f, out)
    assert out.getvalue() == data.tobytes()


def test_ref_m1_m2_cross_decode(tmp_path, oracle):
    chunk = RNG.integers(0, 200, 3000, dtype=np.uint8).tobytes()
    data = chunk * 30
    for mopt in ["-m1", "-m2"]:
        raw = tmp_path / "in.bin"
        jam = tmp_path / f"out{mopt}.jam"
        raw.write_bytes(data)
        oracle.compress(raw, jam, mopt)
        out = io.BytesIO()
        with open(jam, "rb") as f:
            decompress_stream(f, out)
        assert out.getvalue() == data


# ---- decoder fuzz: arbitrary garbage must raise cleanly, never hang ----

def test_garbage_streams_raise_cleanly():
    import io

    from jampack_jax.runtime.pipeline import decompress_stream

    rng = np.random.default_rng(0xF00D)
    for trial in range(20):
        n = int(rng.integers(1, 4000))
        blob = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        try:
            decompress_stream(io.BytesIO(blob), io.BytesIO())
        except (ValueError, Exception):
            continue


def test_valid_header_garbage_payload_raises():
    import io
    import struct

    from jampack_jax.runtime.pipeline import decompress_stream

    rng = np.random.default_rng(0xBEEF)
    payload = bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
    blob = struct.pack("<3sIii", b"JAM", 0, len(payload), 1 << 23) + payload
    with pytest.raises(ValueError):
        decompress_stream(io.BytesIO(blob), io.BytesIO())


def test_lz_decode_rejects_bad_offset():
    from jampack_jax.stages.lz77 import lz77_decode, write_token

    from jampack_jax.format.constants import LZ_MIN_MATCH

    # token demands a copy from before the start of output
    bad = (write_token(300, 0, 9999)
           + write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0))
    with pytest.raises(ValueError):
        lz77_decode(np.frombuffer(bad, dtype=np.uint8))
