"""Native C++ engine vs the numpy executable spec — must agree bit-exactly."""

import io

import numpy as np
import pytest

pytest.importorskip("jampack_jax.native")

from jampack_jax import native
from jampack_jax.format.checksum import integrity_check
from jampack_jax.runtime.engines import NativeEngine
from jampack_jax.runtime.pipeline import (
    Engine,
    Options,
    compress_stream,
    decompress_stream,
)
from jampack_jax.stages.ans import ans_decode, ans_encode
from jampack_jax.stages.bwt import forward_bwt, inverse_bwt, suffix_array
from jampack_jax.stages.filters import filters_decode, filters_encode
from jampack_jax.stages.lpx import lpx_decode, lpx_encode
from jampack_jax.stages.lz77 import lz77_decode, lz77_dedupe_encode

RNG = np.random.default_rng(555)


def inputs():
    yield np.zeros(0, dtype=np.uint8)
    yield RNG.integers(0, 256, 1, dtype=np.uint8)
    yield np.zeros(10000, dtype=np.uint8)
    yield RNG.integers(0, 256, 30000, dtype=np.uint8)
    yield np.tile(np.arange(17, dtype=np.uint8), 3000)
    yield np.frombuffer(b"the quick brown fox " * 2500, dtype=np.uint8)
    yield np.repeat(RNG.integers(0, 9, 700, dtype=np.uint8), RNG.integers(1, 80, 700)).astype(np.uint8)


@pytest.mark.parametrize("idx", range(7))
def test_checksum_parity(idx):
    data = list(inputs())[idx]
    assert native.checksum(data) == integrity_check(data.tobytes())


@pytest.mark.parametrize("idx", range(7))
def test_sais_parity(idx):
    data = list(inputs())[idx]
    assert np.array_equal(native.sais(data), suffix_array(data))


@pytest.mark.parametrize("idx", range(7))
def test_bwt_parity(idx):
    data = list(inputs())[idx]
    enc = native.bwt_forward(data)
    assert np.array_equal(enc, forward_bwt(data))
    assert np.array_equal(native.bwt_inverse(enc), data)
    assert np.array_equal(inverse_bwt(enc), data)


@pytest.mark.parametrize("idx", range(7))
def test_ans_parity(idx):
    data = list(inputs())[idx]
    try:
        expected = ans_encode(data)
    except ValueError:
        # wrap-regime chunk: both engines must refuse identically
        with pytest.raises(ValueError, match="model failure"):
            native.ans_encode(data)
        return
    enc = native.ans_encode(data)
    assert bytes(enc) == expected
    assert np.array_equal(native.ans_decode(enc, data.size + 64), data)
    assert np.array_equal(ans_decode(bytes(enc)), data)


@pytest.mark.parametrize("idx", range(7))
def test_lpx_parity(idx):
    data = list(inputs())[idx]
    enc = native.lpx_encode(data)
    assert np.array_equal(enc, lpx_encode(data))
    assert np.array_equal(native.lpx_decode(enc), data)


@pytest.mark.parametrize("idx", range(7))
def test_lz_dedupe_parity(idx):
    data = list(inputs())[idx]
    enc = native.lz_encode(data, 0)
    assert np.array_equal(enc, lz77_dedupe_encode(data))
    assert np.array_equal(native.lz_decode(enc, data.size + 64), data)
    assert np.array_equal(lz77_decode(enc), data)


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("idx", range(7))
def test_lz_m1_m2_roundtrip(mode, idx):
    data = list(inputs())[idx]
    enc = native.lz_encode(data, mode)
    assert np.array_equal(native.lz_decode(enc, data.size + 64), data)
    assert np.array_equal(lz77_decode(enc), data)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("idx", range(7))
def test_filters_native_roundtrip(mode, idx):
    data = list(inputs())[idx]
    enc = native.filters_encode(data, mode)
    assert np.array_equal(native.filters_decode(enc), data)
    assert np.array_equal(filters_decode(enc), data)
    # spec decode of spec encode must also decode natively
    enc2 = filters_encode(data, 0)
    assert np.array_equal(native.filters_decode(enc2), data)


def test_native_engine_roundtrip_and_interop():
    data = (
        RNG.integers(0, 256, 50000, dtype=np.uint8).tobytes()
        + b"repeat me, repeat me, repeat me! " * 3000
    )
    arc_native, arc_spec = io.BytesIO(), io.BytesIO()
    compress_stream(io.BytesIO(data), arc_native, Options(filters=1), engine=NativeEngine())
    compress_stream(io.BytesIO(data), arc_spec, Options(filters=1), engine=Engine())
    # both engines decode both archives
    for arc in (arc_native, arc_spec):
        for engine in (NativeEngine(), Engine()):
            out = io.BytesIO()
            decompress_stream(io.BytesIO(arc.getvalue()), out, engine=engine)
            assert out.getvalue() == data


def test_native_engine_vs_oracle(oracle, tmp_path):
    data = (b"oracle interop " * 5000) + bytes(RNG.integers(0, 256, 30000, dtype=np.uint8))
    raw = tmp_path / "in.bin"
    jam = tmp_path / "nat.jam"
    back = tmp_path / "back.bin"
    raw.write_bytes(data)
    with open(jam, "wb") as f:
        compress_stream(io.BytesIO(data), f, Options(filters=1), engine=NativeEngine())
    oracle.decompress(jam, back)
    assert back.read_bytes() == data
    # and our native engine decodes the oracle's archive
    jam2 = tmp_path / "ref.jam"
    oracle.compress(raw, jam2)
    out = io.BytesIO()
    with open(jam2, "rb") as f:
        decompress_stream(f, out, engine=NativeEngine())
    assert out.getvalue() == data


# ---- decoder hardening: crafted/corrupt inputs must fail cleanly ----

def test_native_decoders_survive_garbage():
    from jampack_jax import native

    rng = np.random.default_rng(0xDEAD)
    for trial in range(30):
        blob = rng.integers(0, 256, int(rng.integers(1, 5000)), dtype=np.uint8)
        for fn in (
            lambda b: native.ans_decode(b, 1 << 20, 0, 0),
            lambda b: native.ans_decode(b, 1 << 20, 0, 8),
            lambda b: native.lz_decode(b, 1 << 20),
            lambda b: native.bwt_inverse(b, 0, 120),
        ):
            try:
                fn(blob)
            except ValueError:
                pass


def test_native_rle0_overflow_stream_rejected():
    """64+ consecutive {0,1} RLE symbols must not overflow the run counter
    into an out-of-bounds zero fill (crafted-chunk hardening)."""
    from jampack_jax import native
    from jampack_jax.stages.ans import encode_pairs, write_chunk_header

    syms = np.ones(80, dtype=np.uint16)  # 80 run-extension bits
    payload = encode_pairs(syms)
    freqs = [0] * 256
    freqs[0] = 100
    blob = write_chunk_header(freqs, 100, len(payload), 80) + payload
    with pytest.raises(ValueError):
        native.ans_decode(np.frombuffer(blob, np.uint8), 1 << 20, 0, 0)


def test_native_bwt_inverse_bad_anchors_rejected():
    from jampack_jax import native

    good = native.bwt_forward(np.arange(240, dtype=np.uint8) % 251, 120)
    bad = good.copy()
    bad[-480:] = 0xFF  # absurd anchor block
    with pytest.raises(ValueError):
        native.bwt_inverse(bad, 0, 120)


def test_native_ans_truncated_payload_tail_fails_cleanly():
    """Chunks whose rANS payload is cut to within 2 bytes of the end
    exercise the refill fallback (rdec_advance's fast path needs >= 2
    bytes); every truncation point must fail cleanly, never crash."""
    from jampack_jax import native

    data = (np.arange(5000, dtype=np.int32) % 37).astype(np.uint8)
    blob = np.asarray(native.ans_encode(data), dtype=np.uint8)
    for cut in range(1, 40):
        trunc = blob[: blob.size - cut]
        try:
            out = native.ans_decode(trunc, 1 << 20, 0, 0)
            # a shorter prefix may parse as zero complete chunks
            assert out.size < data.size
        except ValueError:
            pass
