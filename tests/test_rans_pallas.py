"""Pallas (Triton route) wide-rANS kernels vs the XLA lockstep forms.

Interpret mode on the CPU backend checks the kernels' semantics (the
arithmetic, masking and layout); the GPU compiler's lowering is checked on
the card by the gpu-marked tests and chip_smoke.py.
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from jampack_jax.kernels.rans_pallas import decode_lanes_wide_pallas
from jampack_jax.kernels.rans_wide import decode_lanes_wide
from jampack_jax.stages.ans import (
    ans_encode_chunk,
    lane_rlen,
    read_chunk_header,
    read_lane_table,
)

RNG = np.random.default_rng(11)


def _chunk_case(n, lanes, seed, hi=60):
    rng = np.random.default_rng(seed)
    data = np.repeat(rng.integers(0, hi, n, dtype=np.uint8),
                     rng.integers(1, 20, n)).astype(np.uint8)[:n]
    blob = ans_encode_chunk(data, lanes)
    view = memoryview(blob)
    freqs, olen, clen, rlen, pos = read_chunk_header(view, 0)
    lane_clens, p = read_lane_table(view, pos, rlen, lanes)
    starts = np.cumsum([p] + lane_clens[:-1]).astype(np.int32)
    rlens = np.asarray([lane_rlen(rlen, lanes, l) for l in range(lanes)],
                       np.int32)
    buf = np.zeros(len(blob) + 64, np.uint8)
    buf[:len(blob)] = np.frombuffer(blob, np.uint8)
    return buf, starts, rlens


def _both(buf, starts, rlens, mr, groups=0):
    a, aok = decode_lanes_wide(jnp.asarray(buf), jnp.asarray(starts),
                               jnp.asarray(rlens), mr, groups=groups)
    b, bok = decode_lanes_wide_pallas(
        jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(rlens), mr,
        groups=groups, interpret=True)
    return (np.asarray(a), np.asarray(aok)), (np.asarray(b),
                                              np.asarray(bok))


@pytest.mark.parametrize("n,lanes,seed", [
    (3000, 4, 1), (6000, 8, 2), (900, 2, 3), (20000, 16, 4)])
def test_pallas_decode_matches_wide(n, lanes, seed):
    buf, starts, rlens = _chunk_case(n, lanes, seed)
    mr = 1 << int(np.max(rlens) - 1).bit_length()
    (a, aok), (b, bok) = _both(buf, starts, rlens, mr)
    assert np.array_equal(aok, bok)
    assert aok.all()
    assert np.array_equal(a, b)


def test_pallas_decode_grouped_slab_and_padding_lanes():
    buf, starts, rlens = _chunk_case(4000, 4, 9)
    # batch-pad to 8 lanes (rlens = -1): slab layout with 2 groups
    starts = np.concatenate([starts, np.zeros(4, np.int32)])
    rlens = np.concatenate([rlens, np.full(4, -1, np.int32)])
    mr = 1 << int(np.max(rlens) - 1).bit_length()
    (a, aok), (b, bok) = _both(buf, starts, rlens, mr, groups=2)
    assert np.array_equal(aok, bok) and np.array_equal(a, b)


def test_pallas_decode_garbage_stream_parity():
    """Hardened-decode path: corrupted payloads must produce the SAME
    bytes and the SAME ok verdict as the XLA kernel (u16 wrap, unsigned
    renorm compare, logical shifts — the garbage-regime bit emulations)."""
    buf, starts, rlens = _chunk_case(5000, 4, 21)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        bad = buf.copy()
        flips = rng.integers(int(starts[0]), buf.size, 25)
        bad[flips] ^= rng.integers(1, 255, 25).astype(np.uint8)
        mr = 1 << int(np.max(rlens) - 1).bit_length()
        (a, aok), (b, bok) = _both(bad, starts, rlens, mr)
        assert np.array_equal(aok, bok), seed
        assert np.array_equal(a, b), seed


def test_pallas_decode_empty_and_tiny_lanes():
    # rlen 0 lanes freeze immediately; uneven tiny lanes exercise the
    # active-mask edges
    buf, starts, rlens = _chunk_case(40, 2, 5)
    mr = max(1 << int(max(np.max(rlens), 1) - 1).bit_length(), 2)
    (a, aok), (b, bok) = _both(buf, starts, rlens, mr)
    assert np.array_equal(aok, bok) and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# Encode pairs kernel (round 4): known-symbol model pass parity


def _pairs_case(L, max_rlen, seed, hi=250):
    rng = np.random.default_rng(seed)
    chains = np.zeros((L, max_rlen), np.uint16)
    rlens = rng.integers(0, max_rlen + 1, L).astype(np.int32)
    for l in range(L):
        # rank-decode-like symbol stream: zero-heavy RLE0 output values
        v = rng.integers(0, hi, rlens[l])
        v = np.where(rng.random(rlens[l]) < 0.5, rng.integers(0, 3, rlens[l]),
                     v)
        chains[l, :rlens[l]] = v
    return chains, rlens


@pytest.mark.parametrize("L,mr,seed", [(4, 64, 0), (8, 200, 1), (16, 96, 2)])
def test_pallas_pairs_matches_wide(L, mr, seed):
    from jampack_jax.kernels.rans_pallas import model_pairs_wide_pallas
    from jampack_jax.kernels.rans_wide import model_pairs_wide

    chains, rlens = _pairs_case(L, mr, seed)
    a_lo, a_fq, a_ok = model_pairs_wide(
        jnp.asarray(chains), jnp.asarray(rlens), mr)
    b_lo, b_fq, b_ok = model_pairs_wide_pallas(
        jnp.asarray(chains), jnp.asarray(rlens), mr, interpret=True)
    assert np.array_equal(np.asarray(a_ok), np.asarray(b_ok))
    # compare only the live pair slots (padding lanes/steps carry garbage
    # in both kernels but are masked by rlens downstream)
    for l in range(L):
        k = 2 * int(rlens[l])
        assert np.array_equal(np.asarray(a_lo)[l, :k],
                              np.asarray(b_lo)[l, :k]), l
        assert np.array_equal(np.asarray(a_fq)[l, :k],
                              np.asarray(b_fq)[l, :k]), l


def test_pallas_pairs_wrap_regime_failure_parity():
    """A chains stream engineered into the zero-frequency regime must
    report ok=False in BOTH kernels."""
    from jampack_jax.kernels.rans_pallas import model_pairs_wide_pallas
    from jampack_jax.kernels.rans_wide import model_pairs_wide

    L, mr = 4, 512
    rng = np.random.default_rng(3)
    chains = np.zeros((L, mr), np.uint16)
    # hammer one rare quasi symbol so the adaptive mass collapses elsewhere
    chains[:, :] = rng.integers(16000, 16200, (L, mr))
    rlens = np.full(L, mr, np.int32)
    a_lo, a_fq, a_ok = model_pairs_wide(
        jnp.asarray(chains), jnp.asarray(rlens), mr)
    b_lo, b_fq, b_ok = model_pairs_wide_pallas(
        jnp.asarray(chains), jnp.asarray(rlens), mr, interpret=True)
    assert np.array_equal(np.asarray(a_ok), np.asarray(b_ok))
    for l in range(L):
        assert np.array_equal(np.asarray(a_lo)[l], np.asarray(b_lo)[l]), l
        assert np.array_equal(np.asarray(a_fq)[l], np.asarray(b_fq)[l]), l


def test_pallas_decode_under_vmap():
    """decode_blocks_device vmaps decode_block_core over a block axis, so
    the Pallas step kernel must stay bit-exact under jax.vmap (the
    batching rule extends the grid)."""
    from functools import partial

    cases = [_chunk_case(800, 4, s) for s in range(3)]
    cap = max(c[0].size for c in cases)
    bufs = jnp.asarray(np.stack([np.pad(c[0], (0, cap - c[0].size))
                                 for c in cases]))
    starts = jnp.asarray(np.stack([c[1] for c in cases]))
    rlens = jnp.asarray(np.stack([c[2] for c in cases]))
    mr = 1 << int(max(int(c[2].max()) for c in cases) - 1).bit_length()
    a, aok = jax.vmap(partial(decode_lanes_wide, max_rlen=mr))(
        bufs, starts, rlens)
    b, bok = jax.vmap(partial(decode_lanes_wide_pallas, max_rlen=mr,
                              interpret=True))(bufs, starts, rlens)
    assert np.array_equal(np.asarray(aok), np.asarray(bok))
    assert np.array_equal(np.asarray(a), np.asarray(b))
