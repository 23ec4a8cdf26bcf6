"""Device Lpx kernel vs the numpy executable spec (and hence lpx.cpp)."""

import numpy as np
import pytest

from jampack_jax.kernels.lpx_device import lpx_decode_device, lpx_encode_device
from jampack_jax.stages.lpx import lpx_decode, lpx_encode

RNG = np.random.default_rng(77)


def lpx_inputs():
    yield np.zeros(0, dtype=np.uint8)
    yield RNG.integers(0, 256, 3, dtype=np.uint8)           # degenerate < 4
    yield RNG.integers(0, 256, 4001, dtype=np.uint8)        # uneven spans
    # strongly LPX-triggering: repeated records with a shared prefix byte
    rec = b"\x10ABCDEFGH" * 40
    yield np.frombuffer((rec + b"\x10ABCDxFGH" + rec) * 12, dtype=np.uint8)
    yield np.zeros(9000, dtype=np.uint8)                    # all-zero runs
    yield np.tile(np.arange(7, dtype=np.uint8), 3000)       # periodic
    yield np.frombuffer(b"the quick brown fox " * 800, dtype=np.uint8)


@pytest.mark.parametrize("idx", range(7))
def test_lpx_device_encode_matches_spec(idx):
    data = list(lpx_inputs())[idx]
    assert np.array_equal(lpx_encode_device(data), lpx_encode(data))


@pytest.mark.parametrize("idx", range(7))
def test_lpx_device_decode_matches_spec(idx):
    data = list(lpx_inputs())[idx]
    enc = lpx_encode(data)
    assert np.array_equal(lpx_decode_device(enc), lpx_decode(enc))
    assert np.array_equal(lpx_decode_device(enc), data)


@pytest.mark.parametrize("idx", [2, 3, 5, 6])
@pytest.mark.parametrize("decode", [False, True])
def test_lpx_packed_span_matches_wide(idx, decode):
    """The packed-record span walk (spans < 2^15 bytes) is bit-identical to
    the unpacked variant — keeps the wide path covered now that every
    small-span call dispatches to the packed one."""
    import jax.numpy as jnp

    from jampack_jax.kernels.lpx_device import _code_span_packed, _code_span_wide

    data = list(lpx_inputs())[idx]
    n = data.size
    d = jnp.asarray(data)
    w = np.asarray(_code_span_wide(d, jnp.int32(n), n, decode))
    p = np.asarray(_code_span_packed(d, jnp.int32(n), n, decode))
    assert np.array_equal(w, p)
