"""Native JTX stream mode: tunable anchor counts and ANS chunk sizes."""

import io

import numpy as np
import pytest

from jampack_jax.runtime.engines import NativeEngine, DeviceEngine
from jampack_jax.runtime.pipeline import (
    Engine,
    Options,
    compress_stream,
    decompress_stream,
)

RNG = np.random.default_rng(99)
DATA = (
    b"native mode stream with more anchors " * 2000
    + bytes(RNG.integers(0, 256, 40000, dtype=np.uint8))
)


@pytest.mark.parametrize("units", [120, 480, 1920])
@pytest.mark.parametrize("chunk_kb", [64, 256, 1024])
def test_native_mode_roundtrip(units, chunk_kb):
    opt = Options(filters=0, anchor_units=units, ans_chunk=chunk_kb << 10)
    arc = io.BytesIO()
    compress_stream(io.BytesIO(DATA), arc, opt, engine=NativeEngine())
    back = io.BytesIO()
    decompress_stream(io.BytesIO(arc.getvalue()), back, engine=NativeEngine())
    assert back.getvalue() == DATA


def test_native_mode_cross_engine():
    opt = Options(filters=0, anchor_units=960, ans_chunk=128 << 10)
    arc = io.BytesIO()
    compress_stream(io.BytesIO(DATA), arc, opt, engine=NativeEngine())
    for engine in (Engine(), NativeEngine(), DeviceEngine()):
        back = io.BytesIO()
        decompress_stream(io.BytesIO(arc.getvalue()), back, engine=engine)
        assert back.getvalue() == DATA


def test_small_chunks_stay_ref_compatible(oracle, tmp_path):
    """Sub-1MB ANS chunks are legal in the reference format: the reference
    binary must decode archives using them (anchors stay at 120)."""
    opt = Options(filters=0, ans_chunk=128 << 10)
    jam = tmp_path / "chunked.jam"
    back = tmp_path / "back.bin"
    with open(jam, "wb") as f:
        compress_stream(io.BytesIO(DATA), f, opt, engine=NativeEngine())
    oracle.decompress(jam, back)
    assert back.read_bytes() == DATA


def test_jtx_magic_only_for_native_units():
    arc = io.BytesIO()
    compress_stream(io.BytesIO(DATA), arc,
                    Options(filters=0, anchor_units=480), engine=NativeEngine())
    assert arc.getvalue()[:3] == b"JTX"
    arc2 = io.BytesIO()
    compress_stream(io.BytesIO(DATA), arc2, Options(filters=0),
                    engine=NativeEngine())
    assert arc2.getvalue()[:3] == b"JAM"


# ---- JTX wide-interleave rANS lanes (survey P6 generalization) ----

@pytest.mark.parametrize("lanes", [2, 8, 32])
def test_lanes_roundtrip_spec(lanes):
    from jampack_jax.stages.ans import ans_decode, ans_encode

    data = np.frombuffer(DATA[:50000], dtype=np.uint8)
    blob = ans_encode(data, 1 << 20, lanes)
    assert np.array_equal(ans_decode(blob, lanes=lanes), data)


@pytest.mark.parametrize("lanes", [2, 16])
def test_lanes_native_matches_spec(lanes):
    from jampack_jax import native
    from jampack_jax.stages.ans import ans_decode, ans_encode

    data = np.frombuffer(DATA[:30000], dtype=np.uint8)
    spec_blob = ans_encode(data, 1 << 20, lanes)
    nat_blob = native.ans_encode(data, 0, lanes)
    assert bytes(nat_blob) == spec_blob
    out = native.ans_decode(np.frombuffer(spec_blob, dtype=np.uint8),
                            data.size + 1024, 0, lanes)
    assert np.array_equal(out, data)


def test_lanes_device_decode_matches_spec():
    from jampack_jax.runtime.engines import DeviceEngine
    from jampack_jax.stages.ans import ans_encode

    data = np.frombuffer(DATA[:30000], dtype=np.uint8)
    blob = ans_encode(data, 1 << 20, lanes=8)
    out = DeviceEngine().ans_decode(np.frombuffer(blob, dtype=np.uint8), lanes=8)
    assert np.array_equal(out, data)


@pytest.mark.parametrize("lanes", [4, 64])
def test_lanes_stream_roundtrip_cross_engine(lanes):
    opt = Options(filters=0, rans_lanes=lanes)
    arc = io.BytesIO()
    compress_stream(io.BytesIO(DATA), arc, opt, engine=NativeEngine())
    assert arc.getvalue()[:3] == b"JTX"
    for engine in (Engine(), NativeEngine(), DeviceEngine()):
        back = io.BytesIO()
        decompress_stream(io.BytesIO(arc.getvalue()), back, engine=engine)
        assert back.getvalue() == DATA


def test_lanes_with_units_and_chunks():
    opt = Options(filters=1, anchor_units=960, ans_chunk=128 << 10,
                  rans_lanes=16)
    arc = io.BytesIO()
    compress_stream(io.BytesIO(DATA), arc, opt, engine=NativeEngine())
    back = io.BytesIO()
    decompress_stream(io.BytesIO(arc.getvalue()), back, engine=NativeEngine())
    assert back.getvalue() == DATA


def test_lanes_edge_sizes():
    from jampack_jax.stages.ans import ans_decode, ans_encode

    for n in (0, 1, 2, 7):
        data = np.frombuffer(DATA[:n], dtype=np.uint8)
        blob = ans_encode(data, 1 << 20, lanes=8)
        assert np.array_equal(ans_decode(blob, lanes=8), data)


# ---- corrupt-stream probes for JTX streams (fail-stop invariants, SURVEY §4) ----

def _lane_archive(lanes=8, units=480):
    opt = Options(filters=0, anchor_units=units, rans_lanes=lanes)
    arc = io.BytesIO()
    compress_stream(io.BytesIO(DATA), arc, opt, engine=NativeEngine())
    return bytearray(arc.getvalue())


def test_lanes_corrupt_payload_byte_detected():
    arc = _lane_archive()
    arc[len(arc) // 2] ^= 0x40
    with pytest.raises(ValueError):
        decompress_stream(io.BytesIO(bytes(arc)), io.BytesIO(),
                          engine=NativeEngine())


def test_lanes_truncated_block_detected():
    arc = _lane_archive()
    with pytest.raises(ValueError, match="truncated"):
        decompress_stream(io.BytesIO(bytes(arc[:-10])), io.BytesIO(),
                          engine=NativeEngine())


def test_lanes_crc_flip_detected():
    arc = _lane_archive()
    arc[4] ^= 0xFF  # crc field of the first block header
    with pytest.raises(ValueError):
        decompress_stream(io.BytesIO(bytes(arc)), io.BytesIO(),
                          engine=NativeEngine())


def test_lanes_corrupt_lane_table_detected_spec():
    from jampack_jax.stages.ans import ans_decode, ans_encode

    data = np.frombuffer(DATA[:20000], dtype=np.uint8)
    blob = bytearray(ans_encode(data, 1 << 20, lanes=4))
    # wrong lane count on decode must not silently succeed
    with pytest.raises(ValueError):
        got = ans_decode(bytes(blob), lanes=8)
        if not np.array_equal(got, data):
            raise ValueError("mismatch")


def test_rans_lanes_validated_at_boundary():
    # lanes < 2 normalize to the classic 4-state stream; lanes beyond the
    # supported interleave are rejected before any engine can frame a
    # header that disagrees with its payload (native clamps at 4096)
    from jampack_jax.runtime.pipeline import validate_rans_lanes

    assert Options(rans_lanes=0).rans_lanes == 0
    assert Options(rans_lanes=1).rans_lanes == 0
    assert Options(rans_lanes=4096).rans_lanes == 4096
    with pytest.raises(ValueError):
        Options(rans_lanes=4097)
    with pytest.raises(ValueError):
        validate_rans_lanes(1 << 20)


def test_framing_rejects_out_of_range_lanes():
    from jampack_jax.format import framing

    buf = io.BytesIO()
    framing.write_block(buf, 0, b"xx", 1 << 20, units=480, lanes=4)
    raw = bytearray(buf.getvalue())
    # patch the lanes ext word beyond the supported range
    import struct

    raw[framing.HEADER_SIZE + 4 : framing.HEADER_SIZE + 8] = struct.pack(
        "<i", 8192
    )
    with pytest.raises(ValueError):
        framing.read_block(io.BytesIO(bytes(raw)))


def test_device_decode_rejects_corrupt_lane_table():
    from jampack_jax.stages.ans import ans_encode

    data = np.frombuffer(DATA[:20000], dtype=np.uint8)
    blob = ans_encode(data, 1 << 20, lanes=4)
    with pytest.raises(ValueError):
        got = DeviceEngine().ans_decode(
            np.frombuffer(blob, dtype=np.uint8), lanes=8
        )
        if not np.array_equal(got, data):
            raise ValueError("mismatch")


@pytest.mark.parametrize("spans", [1, 16, 256])
def test_lpx_spans_cross_engine(spans):
    """JT3 container: the Lpx span count is a stream parameter; spec and
    native archives are byte-identical and cross-decode."""
    opt = Options(blocksize=1 << 20, filters=1, lpx_spans=spans)
    a1 = io.BytesIO()
    compress_stream(io.BytesIO(DATA), a1, opt, engine=Engine())
    a2 = io.BytesIO()
    compress_stream(io.BytesIO(DATA), a2, opt, engine=NativeEngine())
    assert a1.getvalue() == a2.getvalue()
    assert a1.getvalue()[:3] == b"JT3"
    o = io.BytesIO()
    decompress_stream(io.BytesIO(a1.getvalue()), o, engine=NativeEngine())
    assert o.getvalue() == DATA


def test_lpx_spans_default_stays_jam():
    opt = Options(blocksize=1 << 20, filters=0, lpx_spans=4)
    a = io.BytesIO()
    compress_stream(io.BytesIO(DATA[:30000]), a, opt, engine=NativeEngine())
    assert a.getvalue()[:3] == b"JAM"


def test_lpx_spans_validated():
    from jampack_jax.runtime.pipeline import validate_lpx_spans

    # 0 is VALID since round 4 (Lpx stage skipped, framing.py); negatives
    # and oversize still rejected
    assert Options(lpx_spans=0).lpx_spans == 0
    with pytest.raises(ValueError):
        Options(lpx_spans=-1)
    with pytest.raises(ValueError):
        validate_lpx_spans((1 << 16) + 1)
    # framing rejects out-of-range span words
    from jampack_jax.format import framing
    import struct

    buf = io.BytesIO()
    framing.write_block(buf, 0, b"xx", 1 << 20, units=120, lanes=0,
                        lpx_spans=64)
    raw = bytearray(buf.getvalue())
    assert raw[:3] == b"JT3"
    raw[framing.HEADER_SIZE + 8: framing.HEADER_SIZE + 12] = struct.pack(
        "<i", -5)
    with pytest.raises(ValueError):
        framing.read_block(io.BytesIO(bytes(raw)))
