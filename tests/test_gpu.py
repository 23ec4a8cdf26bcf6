"""Checks that only mean something on an NVIDIA GPU: the Pallas kernels as
the GPU compiler builds them (no interpret mode), and the float products
the codec relies on being exact under the GPU's matmul precision.  They
skip elsewhere; chip_smoke.py runs them on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jampack_jax.kernels.rans_wide import decode_lanes_wide, model_pairs_wide
from jampack_jax.stages.ans import (
    ans_decode,
    ans_encode_chunk,
    lane_rlen,
    read_chunk_header,
    read_lane_table,
)

pytestmark = pytest.mark.gpu


def _stream(n, lanes, seed):
    rng = np.random.default_rng(seed)
    data = np.repeat(rng.integers(0, 60, n, dtype=np.uint8),
                     rng.integers(1, 20, n)).astype(np.uint8)[:n]
    blob = ans_encode_chunk(data, lanes)
    view = memoryview(blob)
    _, _, _, rlen, pos = read_chunk_header(view, 0)
    lane_clens, p = read_lane_table(view, pos, rlen, lanes)
    starts = np.cumsum([p] + lane_clens[:-1]).astype(np.int32)
    rlens = np.asarray([lane_rlen(rlen, lanes, l) for l in range(lanes)],
                       np.int32)
    buf = np.zeros(len(blob) + 64, np.uint8)
    buf[:len(blob)] = np.frombuffer(blob, np.uint8)
    return data, blob, buf, starts, rlens


@pytest.mark.parametrize("n,lanes,seed", [(20000, 16, 1), (60000, 64, 2)])
def test_compiled_decode_kernel_matches_xla(gpu, n, lanes, seed):
    from jampack_jax.kernels.rans_pallas import decode_lanes_wide_pallas

    _, _, buf, starts, rlens = _stream(n, lanes, seed)
    mr = 1 << int(np.max(rlens) - 1).bit_length()
    args = (jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(rlens), mr)
    a, aok = decode_lanes_wide(*args)
    b, bok = decode_lanes_wide_pallas(*args)
    assert np.asarray(aok).all()
    assert np.array_equal(np.asarray(aok), np.asarray(bok))
    assert np.array_equal(np.asarray(a), np.asarray(b))


def test_compiled_pairs_kernel_matches_xla(gpu):
    from jampack_jax.kernels.rans_pallas import model_pairs_wide_pallas

    rng = np.random.default_rng(4)
    L, mr = 48, 700
    rlens = rng.integers(0, mr + 1, L).astype(np.int32)
    chains = np.where(rng.random((L, mr)) < 0.5, rng.integers(0, 3, (L, mr)),
                      rng.integers(0, 257, (L, mr))).astype(np.uint16)
    a = model_pairs_wide(jnp.asarray(chains), jnp.asarray(rlens), mr)
    b = model_pairs_wide_pallas(jnp.asarray(chains), jnp.asarray(rlens), mr)
    assert np.array_equal(np.asarray(a[2]), np.asarray(b[2]))
    for l in range(L):
        k = 2 * int(rlens[l])
        for x, y in zip(a[:2], b[:2]):
            assert np.array_equal(np.asarray(x)[l, :k], np.asarray(y)[l, :k])


def test_xla_decode_exact_under_gpu_matmul_precision(gpu):
    """decode_lanes_wide sums the model bank with one f32 dot of integers
    up to 2^24; it must name HIGHEST precision, because TF32 would round
    them.  The symbols must equal the host spec decoder's."""
    data, blob, buf, starts, rlens = _stream(50000, 32, 3)
    mr = 1 << int(np.max(rlens) - 1).bit_length()
    syms, ok = decode_lanes_wide(jnp.asarray(buf), jnp.asarray(starts),
                                 jnp.asarray(rlens), mr)
    assert np.asarray(ok).all()
    want = ans_decode(np.frombuffer(blob, np.uint8), lanes=32)
    assert np.array_equal(np.asarray(want), data)
    # the decoded chains interleave back into the spec's symbol order
    from jampack_jax.stages.ans import interleave_lanes

    got = interleave_lanes([np.asarray(syms)[l, :rlens[l]]
                            for l in range(32)], int(rlens.sum()), 32)
    from jampack_jax.stages.rank import rank_decode
    from jampack_jax.stages.rle0 import rle0_decode

    freqs, olen, _, _, _ = read_chunk_header(memoryview(blob), 0)
    assert np.array_equal(rank_decode(rle0_decode(got, olen), freqs), data)


def test_fused_block_roundtrip_on_gpu(gpu):
    from jampack_jax.runtime.device_decode import decode_block_device
    from jampack_jax.runtime.device_encode import encode_block_device
    from jampack_jax.runtime.engines import NativeEngine
    from jampack_jax.runtime.pipeline import Options, compress_block

    rng = np.random.default_rng(5)
    data = np.repeat(rng.integers(0, 40, 200_000, dtype=np.uint8),
                     rng.integers(1, 6, 200_000))[:300_000].astype(np.uint8)
    opt = Options(blocksize=1 << 20, match_finder=3, filters=0,
                  rans_lanes=4, ans_chunk=16 << 10, anchor_units=960,
                  lpx_spans=64)
    crc, payload = encode_block_device(data, opt)
    assert (crc, payload) == compress_block(data, opt, NativeEngine())
    back = decode_block_device(payload, crc, opt.blocksize,
                               opt.anchor_units, opt.rans_lanes,
                               opt.lpx_spans)
    assert np.array_equal(back, data)
    assert jax.devices()[0].platform == "gpu"
