"""Per-stage round-trip tests on random and adversarial inputs."""

import numpy as np
import pytest

from jampack_jax.stages.bwt import forward_bwt, inverse_bwt, suffix_array
from jampack_jax.stages.filters import (
    delta_decode,
    delta_encode,
    filters_decode,
    filters_encode,
    inline_delta,
    inline_undelta,
    lpc_decode,
    lpc_encode,
    reorder,
    unreorder,
)
from jampack_jax.stages.lpx import lpx_decode, lpx_encode
from jampack_jax.stages.lz77 import lz77_decode, lz77_dedupe_encode
from jampack_jax.stages.rank import rank_decode, rank_encode
from jampack_jax.stages.rle0 import rle0_decode, rle0_encode

RNG = np.random.default_rng(42)


def adversarial_inputs():
    yield "empty", np.zeros(0, dtype=np.uint8)
    yield "one", np.array([7], dtype=np.uint8)
    yield "zeros", np.zeros(1000, dtype=np.uint8)
    yield "ones", np.full(513, 255, dtype=np.uint8)
    yield "short-tail", RNG.integers(0, 256, 119, dtype=np.uint8)
    yield "distinct", np.arange(256, dtype=np.uint8)
    yield "periodic", np.tile(np.arange(7, dtype=np.uint8), 500)
    yield "random", RNG.integers(0, 256, 5000, dtype=np.uint8)
    yield "binary", RNG.integers(0, 2, 4096, dtype=np.uint8)
    yield "text", np.frombuffer(
        (b"the quick brown fox jumps over the lazy dog " * 200), dtype=np.uint8
    )
    yield "runs", np.repeat(
        RNG.integers(0, 4, 100, dtype=np.uint8), RNG.integers(1, 60, 100)
    ).astype(np.uint8)


@pytest.mark.parametrize("name,data", list(adversarial_inputs()))
def test_rle0_roundtrip(name, data):
    syms = rle0_encode(data)
    assert syms.size <= max(data.size, 0) + 1
    assert (syms <= 256).all()
    out = rle0_decode(syms, data.size)
    assert np.array_equal(out, data)


@pytest.mark.parametrize("name,data", list(adversarial_inputs()))
def test_rank_roundtrip(name, data):
    ranks, freq = rank_encode(data)
    assert sum(freq) == data.size
    out = rank_decode(ranks, freq)
    assert np.array_equal(out, data)


def test_suffix_array_small():
    t = np.frombuffer(b"banana", dtype=np.uint8)
    sa = suffix_array(t)
    # suffixes sorted: a, ana, anana, banana, na, nana
    assert list(sa) == [5, 3, 1, 0, 4, 2]


def test_suffix_array_matches_naive():
    for _ in range(10):
        n = int(RNG.integers(1, 400))
        t = RNG.integers(0, 4, n, dtype=np.uint8)
        sa = suffix_array(t)
        b = t.tobytes()
        naive = sorted(range(n), key=lambda i: b[i:])
        assert list(sa) == naive


@pytest.mark.parametrize("name,data", list(adversarial_inputs()))
def test_bwt_roundtrip(name, data):
    enc = forward_bwt(data)
    assert enc.size == data.size + 480
    out = inverse_bwt(enc)
    assert np.array_equal(out, data)


def test_bwt_multiple_of_120():
    data = RNG.integers(0, 256, 120 * 13, dtype=np.uint8)
    assert np.array_equal(inverse_bwt(forward_bwt(data)), data)


@pytest.mark.parametrize("name,data", list(adversarial_inputs()))
def test_lpx_roundtrip(name, data):
    enc = lpx_encode(data)
    assert enc.size == data.size
    assert np.array_equal(lpx_decode(enc), data)


@pytest.mark.parametrize("name,data", list(adversarial_inputs()))
def test_lz77_dedupe_roundtrip(name, data):
    enc = lz77_dedupe_encode(data)
    assert np.array_equal(lz77_decode(enc), data)


def test_lz77_finds_dupes():
    chunk = RNG.integers(0, 256, 4096, dtype=np.uint8)
    data = np.concatenate([chunk, chunk, chunk])
    enc = lz77_dedupe_encode(data)
    assert enc.size < data.size * 0.67
    assert np.array_equal(lz77_decode(enc), data)


@pytest.mark.parametrize("width", [1, 2, 3, 4, 7, 16, 32])
def test_filter_transforms_roundtrip(width):
    data = RNG.integers(0, 256, 1000, dtype=np.uint8)
    assert np.array_equal(delta_decode(delta_encode(data)), data)
    assert np.array_equal(lpc_decode(lpc_encode(data)), data)
    assert np.array_equal(unreorder(reorder(data, width), width), data)
    assert np.array_equal(inline_undelta(inline_delta(data, width), width), data)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("name,data", list(adversarial_inputs()))
def test_filters_roundtrip(mode, name, data):
    if mode == 2 and data.size > 4096:
        pytest.skip("brute force is slow in the spec engine")
    enc = filters_encode(data, mode)
    assert np.array_equal(filters_decode(enc), data)


def test_filters_detects_structure():
    # interleaved 4-channel ramps: delta with width 4 should win over raw
    t = np.arange(4096, dtype=np.int64)
    data = ((t // 4) + (t % 4) * 50).astype(np.uint8)
    enc = filters_encode(data, 2)
    assert enc[1] > 0  # some non-raw width chosen
    assert np.array_equal(filters_decode(enc), data)
