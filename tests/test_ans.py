"""Entropy-stage (rank -> RLE0 -> structured rANS) round-trip tests."""

import numpy as np
import pytest

from jampack_jax.stages.ans import ans_decode, ans_encode
from jampack_jax.stages.models import AdaptiveModel, QuasiModel
from jampack_jax.format.constants import PROB_SCALE

RNG = np.random.default_rng(7)


def test_adaptive_model_invariants():
    m = AdaptiveModel(8)
    m.reset()
    assert m.cum_freqs[0] == 0 and m.cum_freqs[8] == PROB_SCALE
    for sym in RNG.integers(0, 8, 500):
        lo, fq = m.sym_to_low(sym), m.sym_to_freq(sym)
        assert fq > 0 and 0 <= lo < PROB_SCALE
        # every range value inside [lo, lo+fq) maps back to sym
        assert m.range_to_sym(lo) == sym
        assert m.range_to_sym(lo + fq - 1) == sym
        m.update(int(sym))
        assert m.cum_freqs[0] == 0 and m.cum_freqs[8] == PROB_SCALE
        assert (np.diff(m.cum_freqs) > 0).all()


def test_quasi_model_invariants():
    m = QuasiModel(129)
    m.reset()
    syms = RNG.integers(0, 129, 300000)
    for i, sym in enumerate(syms):
        lo, fq = m.sym_to_low(sym), m.sym_to_freq(sym)
        assert fq > 0
        assert m.range_to_sym(lo) == sym
        assert m.range_to_sym(lo + fq - 1) == sym
        m.update(int(sym))
    assert m.cum_freqs[129] == PROB_SCALE


def test_quasi_model_skewed_rescale():
    # hammer one symbol to push the stretch-up through maximal scaled counts
    m = QuasiModel(4)
    m.reset()
    for _ in range(70000):
        m.update(0)
        assert m.cum_freqs[4] == PROB_SCALE


def ans_inputs():
    yield np.zeros(0, dtype=np.uint8)
    yield np.array([0], dtype=np.uint8)
    yield np.zeros(10000, dtype=np.uint8)
    yield RNG.integers(0, 256, 50000, dtype=np.uint8)
    yield RNG.integers(0, 3, 100000, dtype=np.uint8)
    yield np.repeat(RNG.integers(0, 8, 500, dtype=np.uint8), RNG.integers(1, 100, 500)).astype(np.uint8)


@pytest.mark.parametrize("idx", range(6))
def test_ans_roundtrip(idx):
    data = list(ans_inputs())[idx]
    enc = ans_encode(data)
    out = ans_decode(enc, expect_size=data.size)
    assert np.array_equal(out, data)


def test_ans_heavy_quasi_rescale_roundtrip():
    # A constant high MTF rank hammers one quasi-model mantissa through many
    # rescales with large scaled counts.  The reference's stretch-up
    # (model.cpp:183) is UNSIGNED arithmetic — ProbScale is unsigned int —
    # so it never wraps and such chunks encode fine; an earlier revision
    # mis-modeled this as int32 wrap and refused them.
    data = np.tile(np.arange(251, dtype=np.uint8), 97)
    enc = ans_encode(data)
    assert np.array_equal(ans_decode(enc, expect_size=data.size), data)


def test_ans_compresses_skewed():
    data = np.repeat(np.uint8(0), 50000)
    data[::97] = 1
    enc = ans_encode(data)
    assert len(enc) < 3000  # mostly header + tiny payload
