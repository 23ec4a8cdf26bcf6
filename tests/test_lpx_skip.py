"""Lpx skip flag (JT3 ext word lpx_spans == 0) and the per-block auto gate.

Round-4 native-container freedom: the encoder may skip the
Lpx stage on blocks where its measured gain is below threshold, writing
spans=0 into the JT3 ext word; the decoder then skips the decode chain's
dominant serial-walk term.  Reference parity context: the reference always
runs Lpx (jampack.cpp:38, lpx.cpp:150-169) — skipping is only ever framed
in the native container, never in ref-compat JAM streams."""

import io

import numpy as np
import pytest

from jampack_jax.format import framing
from jampack_jax.runtime.pipeline import (
    Engine, Options, compress_block, compress_block_ex, compress_stream,
    decompress_block, decompress_stream)

RNG = np.random.default_rng(41)


def _records(n: int) -> np.ndarray:
    """Log-like records: field names repeat per line (Lpx-predictable,
    XOR runs of zeros), ids vary (no >=256 B exact repeats, so the m0
    dedupe pre-pass leaves the structure for Lpx)."""
    out = bytearray()
    i = 0
    while len(out) < n:
        out += b"ts=2026-08-20T09:%02d:%02d level=INFO module=core id=%06d\n" \
            % (i // 60 % 60, i % 60, i)
        i += 1
    return np.frombuffer(bytes(out[:n]), np.uint8)


def _random(n: int) -> np.ndarray:
    return RNG.integers(0, 256, n, dtype=np.uint8).astype(np.uint8)


def test_spans0_roundtrip_numpy():
    data = _records(6000)
    opt = Options(blocksize=1 << 20, lpx_spans=0)
    crc, payload, spans = compress_block_ex(data, opt, Engine())
    assert spans == 0
    out = decompress_block(payload, crc, Engine(), opt.blocksize,
                           lpx_spans=0)
    assert np.array_equal(out, data)


def test_spans0_differs_from_spans4():
    """The skip genuinely removes the stage (payload differs on data Lpx
    transforms; the per-span model needs ~16 KB of warmup to fire)."""
    data = _records(48000)
    _, p0, _ = compress_block_ex(
        data, Options(blocksize=1 << 20, lpx_spans=0), Engine())
    _, p4, _ = compress_block_ex(
        data, Options(blocksize=1 << 20, lpx_spans=4), Engine())
    assert p0 != p4


def test_auto_gate_skips_on_random_keeps_on_records():
    eng = Engine()
    opt = Options(blocksize=1 << 20, lpx_spans=4, lpx_auto=True)
    _, _, s_rand = compress_block_ex(_random(48000), opt, eng)
    _, _, s_rec = compress_block_ex(_records(48000), opt, eng)
    assert s_rand == 0
    assert s_rec == 4


def test_compress_block_raises_when_auto_diverges():
    opt = Options(blocksize=1 << 20, lpx_auto=True)
    with pytest.raises(ValueError):
        compress_block(_random(8000), opt, Engine())


def test_auto_stream_roundtrip_mixed_blocks():
    """compress_stream frames each block with ITS chosen span word; the
    stock decoder reads the mix back bit-exactly.  Blocks are the 1 MB
    framing minimum (Options clamps below it)."""
    from jampack_jax.runtime.engines import NativeEngine

    mb = 1 << 20
    blocks = [_records(mb), _random(mb)]
    plain = b"".join(b.tobytes() for b in blocks)
    opt = Options(blocksize=mb, lpx_spans=8, lpx_auto=True)
    arc = io.BytesIO()
    eng = NativeEngine()
    compress_stream(io.BytesIO(plain), arc, opt, eng)
    # headers carry per-block span words (8 where kept, 0 where skipped)
    arc.seek(0)
    spans_seen = []
    while True:
        rec = framing.read_block(arc, want_payload=False)
        if rec is None:
            break
        spans_seen.append(rec[0].lpx_spans)
    assert 0 in spans_seen and 8 in spans_seen
    out = io.BytesIO()
    decompress_stream(io.BytesIO(arc.getvalue()), out, eng)
    assert out.getvalue() == plain


def test_native_engine_spans0_roundtrip():
    from jampack_jax.runtime.engines import NativeEngine

    data = _records(6000)
    opt = Options(blocksize=1 << 20, lpx_spans=0)
    ne = NativeEngine()
    crc, payload, spans = compress_block_ex(data, opt, ne)
    assert spans == 0
    out = decompress_block(payload, crc, ne, opt.blocksize, lpx_spans=0)
    assert np.array_equal(out, data)
    # engine-independent bytes
    _, p_np, _ = compress_block_ex(data, opt, Engine())
    assert payload == p_np


def test_framing_spans0_header():
    buf = io.BytesIO()
    framing.write_block(buf, 7, b"xyz", 1 << 20, 120, 0, 0)
    buf.seek(0)
    h, payload = framing.read_block(buf)
    assert h.lpx_spans == 0 and payload == b"xyz"
    # spans=0 forces the JT3 container even at default units/lanes
    assert buf.getvalue()[:3] == framing.MAGIC_NATIVE3


def test_framing_negative_spans_corrupt():
    buf = io.BytesIO()
    framing.write_block(buf, 7, b"xyz", 1 << 20, 120, 0, 5)
    raw = bytearray(buf.getvalue())
    # patch the spans ext word (last of three i32 after the 15-byte header)
    raw[15 + 8: 15 + 12] = (-3).to_bytes(4, "little", signed=True)
    with pytest.raises(ValueError):
        framing.read_block(io.BytesIO(bytes(raw)))


def test_fused_device_decode_spans0():
    from jampack_jax.runtime.device_decode import decode_block_device

    data = _records(9000)
    opt = Options(blocksize=1 << 20, filters=1, rans_lanes=4, ans_chunk=2048,
                  anchor_units=16, lpx_spans=0)
    crc, payload, spans = compress_block_ex(data, opt, Engine())
    assert spans == 0
    out = decode_block_device(payload, crc, opt.blocksize, opt.anchor_units,
                              opt.rans_lanes, 0)
    assert np.array_equal(out, data)


def test_fused_device_encode_spans0():
    from jampack_jax.runtime.device_encode import encode_block_device

    data = _records(5000)
    opt = Options(blocksize=1 << 20, match_finder=3, filters=0, rans_lanes=4,
                  ans_chunk=2048, anchor_units=8, lpx_spans=0)
    crc_d, pay_d = encode_block_device(data, opt)
    crc_h, pay_h, spans = compress_block_ex(data, opt, Engine())
    assert spans == 0
    assert (crc_d, pay_d) == (crc_h, pay_h)


def test_cli_auto_flag_roundtrip(tmp_path):
    from jampack_jax.cli import _parse, run

    _, _, _, opt, _ = _parse(["jam", "c", "a", "b", "-Sa"])
    assert opt.lpx_auto
    _, _, _, opt2, _ = _parse(["jam", "c", "a", "b", "-S0"])
    assert opt2.lpx_spans == 0 and not opt2.lpx_auto

    mb = 1 << 20
    data = _records(mb).tobytes() + _random(mb).tobytes()
    src = tmp_path / "in.bin"
    jam = tmp_path / "out.jam"
    back = tmp_path / "back.bin"
    src.write_bytes(data)
    run(["jam", "c", str(src), str(jam), "-b1", "-Sa"])
    run(["jam", "d", str(jam), str(back)])
    assert back.read_bytes() == data
    # the records block kept Lpx (spans=4), the random block skipped it
    spans = []
    with open(jam, "rb") as f:
        while True:
            rec = framing.read_block(f, want_payload=False)
            if rec is None:
                break
            spans.append(rec[0].lpx_spans)
    assert 0 in spans and 4 in spans


def test_fused_archive_encode_auto_routes_to_host_gate(tmp_path):
    """encode_archive_sharded must not silently drop -Sa: the m0 path
    falls back to the host encoder (which gates per block), and the m3
    path runs the gate ON DEVICE per block (encode_front_core) with
    byte-identical choices."""
    import io

    from jampack_jax.runtime.sharding import encode_archive_sharded, make_mesh

    mesh = make_mesh(1)
    mb = 1 << 20
    data = _records(mb).tobytes() + _random(mb).tobytes()
    opt = Options(blocksize=mb, match_finder=0, filters=1, rans_lanes=4,
                  ans_chunk=2048, anchor_units=16, lpx_spans=8,
                  lpx_auto=True)
    arc = io.BytesIO()
    encode_archive_sharded(io.BytesIO(data), arc, opt, mesh)
    arc.seek(0)
    spans = []
    while True:
        rec = framing.read_block(arc, want_payload=False)
        if rec is None:
            break
        spans.append(rec[0].lpx_spans)
    assert 0 in spans and 8 in spans  # per-block gate took effect

    # m3: the DEVICE gate — whole archive must equal the host encoder's
    sopt = Options(blocksize=mb, match_finder=3, filters=0, rans_lanes=4,
                   ans_chunk=2048, anchor_units=16, lpx_spans=8,
                   lpx_auto=True)
    darc = io.BytesIO()
    encode_archive_sharded(io.BytesIO(data), darc, sopt, mesh)
    harc = io.BytesIO()
    compress_stream(io.BytesIO(data), harc, sopt, Engine())
    assert darc.getvalue() == harc.getvalue()
    darc.seek(0)
    dspans = []
    while True:
        rec = framing.read_block(darc, want_payload=False)
        if rec is None:
            break
        dspans.append(rec[0].lpx_spans)
    assert 0 in dspans and 8 in dspans


def test_device_gate_matches_host_gate():
    """encode_block_device_ex under lpx_auto makes the SAME per-block
    span choice and the SAME bytes as compress_block_ex (the gate is
    shared integer arithmetic, host np vs device int32)."""
    from jampack_jax.runtime.device_encode import encode_block_device_ex

    for gen in (_records, _random):
        data = gen(200_000)
        opt = Options(blocksize=1 << 20, match_finder=3, filters=1,
                      rans_lanes=4, ans_chunk=2048, anchor_units=16,
                      lpx_spans=8, lpx_auto=True)
        got = encode_block_device_ex(data, opt)
        want = compress_block_ex(data, opt, Engine())
        assert got == want
