"""Device kernels (run here on the CPU backend) vs the numpy executable spec."""

import numpy as np
import pytest

from jampack_jax.stages.bwt import forward_bwt, inverse_bwt, suffix_array
from jampack_jax.stages.ans import ans_encode_chunk, read_chunk_header
from jampack_jax.stages.rank import rank_decode
from jampack_jax.stages.rle0 import rle0_decode, rle0_encode
from jampack_jax.stages.rank import rank_encode
from jampack_jax.kernels.ibwt import inverse_bwt_device
from jampack_jax.kernels.sa import forward_bwt_device, suffix_array_device
from jampack_jax.kernels.rans_decode import decode_chunk_device

RNG = np.random.default_rng(99)


def bwt_inputs():
    yield np.zeros(0, dtype=np.uint8)
    yield RNG.integers(0, 256, 119, dtype=np.uint8)  # below one unit
    yield RNG.integers(0, 256, 120, dtype=np.uint8)
    yield RNG.integers(0, 256, 10000, dtype=np.uint8)
    yield np.zeros(5000, dtype=np.uint8)
    yield np.tile(np.arange(9, dtype=np.uint8), 2000)
    yield np.frombuffer(b"mississippi banana abracadabra " * 700, dtype=np.uint8)


@pytest.mark.parametrize("idx", range(7))
def test_suffix_array_device_matches_spec(idx):
    data = list(bwt_inputs())[idx]
    n = (data.size // 120) * 120
    if n == 0:
        return
    assert np.array_equal(suffix_array_device(data[:n]), suffix_array(data[:n]))


@pytest.mark.parametrize("idx", range(7))
def test_forward_bwt_device_matches_spec(idx):
    data = list(bwt_inputs())[idx]
    assert np.array_equal(forward_bwt_device(data), forward_bwt(data))


@pytest.mark.parametrize("idx", range(7))
def test_inverse_bwt_device_roundtrip(idx):
    data = list(bwt_inputs())[idx]
    enc = forward_bwt(data)
    assert np.array_equal(inverse_bwt_device(enc), data)


def test_bwt_device_full_cycle():
    data = RNG.integers(0, 256, 50000, dtype=np.uint8)
    assert np.array_equal(inverse_bwt_device(forward_bwt_device(data)), data)


def ans_chunk_inputs():
    yield RNG.integers(0, 256, 5000, dtype=np.uint8)
    yield np.zeros(3000, dtype=np.uint8)
    yield RNG.integers(0, 4, 20000, dtype=np.uint8)
    yield np.repeat(RNG.integers(0, 16, 300, dtype=np.uint8), RNG.integers(1, 50, 300)).astype(np.uint8)
    # exercise quasi rescales heavily (> 64K symbols through high classes)
    yield RNG.integers(0, 256, 80000, dtype=np.uint8)


@pytest.mark.parametrize("idx", range(5))
def test_rans_decode_device_matches_spec(idx):
    data = list(ans_chunk_inputs())[idx]
    blob = ans_encode_chunk(data)
    freqs, olen, clen, rlen, pos = read_chunk_header(blob, 0)
    payload = np.frombuffer(blob[pos : pos + clen], dtype=np.uint8)
    syms = decode_chunk_device(payload, rlen)
    ranked = rle0_decode(syms, olen)
    out = rank_decode(ranked, freqs)
    assert np.array_equal(out, data)


@pytest.mark.parametrize("idx", range(5))
def test_rans_encode_device_matches_spec(idx):
    from jampack_jax.kernels.rans_encode import encode_pairs_device
    from jampack_jax.stages.ans import encode_pairs
    from jampack_jax.stages.rank import rank_encode as _re
    from jampack_jax.stages.rle0 import rle0_encode as _rle

    data = list(ans_chunk_inputs())[idx]
    ranked, _ = _re(data.copy())
    syms = _rle(ranked)
    assert encode_pairs_device(syms) == encode_pairs(syms)


def test_rans_encode_lanes_device_matches_spec():
    from jampack_jax.kernels.rans_encode import encode_lanes_device
    from jampack_jax.stages.ans import encode_pairs
    from jampack_jax.stages.rank import rank_encode as _re
    from jampack_jax.stages.rle0 import rle0_encode as _rle

    data = RNG.integers(0, 64, 30000, dtype=np.uint8)
    ranked, _ = _re(data.copy())
    syms = _rle(ranked)
    lanes = 8
    got = encode_lanes_device([syms[l::lanes] for l in range(lanes)])
    want = [encode_pairs(syms[l::lanes]) for l in range(lanes)]
    assert got == want


def test_device_engine_ans_encode_stream_matches_spec():
    from jampack_jax.runtime.engines import DeviceEngine
    from jampack_jax.stages.ans import ans_encode

    data = RNG.integers(0, 200, 70000, dtype=np.uint8)
    for lanes in (0, 4):
        assert DeviceEngine().ans_encode(data, 16 << 10, lanes) == ans_encode(
            data, 16 << 10, lanes
        )


def lz_stream_inputs():
    # dedupe-heavy, periodic (overlapping copies), random, and native m1/m2
    big = bytes(RNG.integers(0, 256, 4096, dtype=np.uint8))
    yield big * 4 + b"tail" + big
    yield b"ab" * 5000 + b"x" + b"ab" * 300
    yield bytes(RNG.integers(0, 256, 20000, dtype=np.uint8))
    yield (b"the quick brown fox jumps over the lazy dog " * 400
           + bytes(RNG.integers(0, 256, 3000, dtype=np.uint8)))
    yield b""


@pytest.mark.parametrize("idx", range(5))
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_lz_expand_device_matches_spec(idx, mode):
    from jampack_jax import native
    from jampack_jax.kernels.lz_expand import lz77_decode_device
    from jampack_jax.stages.lz77 import lz77_decode

    raw = np.frombuffer(list(lz_stream_inputs())[idx], dtype=np.uint8)
    enc = native.lz_encode(raw, mode)
    assert np.array_equal(lz77_decode_device(enc), lz77_decode(enc))
    assert np.array_equal(lz77_decode_device(enc), raw)


def test_wide_decoder_matches_scalar_kernel():
    """Lane-vectorized decoder vs scalar chain kernel, uneven lane lengths."""
    from jampack_jax.kernels.rans_decode import decode_lanes_device
    from jampack_jax.stages.ans import (
        ans_encode_chunk,
        lane_rlen,
        read_chunk_header,
        read_lane_table,
    )
    from jampack_jax.stages.ans import decode_pairs

    data = np.repeat(RNG.integers(0, 40, 900, dtype=np.uint8),
                     RNG.integers(1, 30, 900)).astype(np.uint8)[:17001]
    lanes = 8
    blob = ans_encode_chunk(data, lanes)
    view = memoryview(blob)
    freqs, olen, clen, rlen, pos = read_chunk_header(view, 0)
    lane_clens, p = read_lane_table(view, pos, rlen, lanes)
    starts = np.cumsum([p] + lane_clens[:-1]).astype(np.int32)
    rlens = np.asarray([lane_rlen(rlen, lanes, l) for l in range(lanes)],
                       np.int32)
    buf = np.frombuffer(blob, np.uint8)
    got = decode_lanes_device(buf, starts, rlens)
    for l in range(lanes):
        want = decode_pairs(view, int(starts[l]), int(rlens[l]))
        assert np.array_equal(got[l, : rlens[l]], want), l


def test_ibwt_device_past_2_23_boundary():
    """Regression: the combined LF-map packing overflowed int32 once
    nlen > 2^23 (lf << 8 needs 24+8 bits) — silently corrupting inverse
    BWT on stage buffers over 8,388,608 bytes (seen at 8,388,840)."""
    import numpy as np

    from jampack_jax.kernels.ibwt import inverse_bwt_device
    from jampack_jax.stages.bwt import forward_bwt

    n = (1 << 23) + 240  # nlen lands just past the int32-packing boundary
    rng = np.random.default_rng(9)
    alpha = np.frombuffer(b" etaoinshrdlu.,\n", dtype=np.uint8)
    data = alpha[rng.integers(0, alpha.size, n)]
    buf = forward_bwt(data, 120)
    out = inverse_bwt_device(buf, 120)
    assert np.array_equal(out, data)
