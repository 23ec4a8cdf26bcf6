"""Filtered prefix doubling vs the executable-spec suffix array.

The filtered-doubling experiment lives in tools/sa_filtered.py (not wired
into the package); this test keeps the tool honest against the spec since
it remains the documented starting point for a device-resident
cond-switch variant."""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
from sa_filtered import suffix_array_device_filtered  # noqa: E402

from jampack_jax.stages.bwt import suffix_array  # noqa: E402

RNG = np.random.default_rng(99)


def cases():
    yield np.zeros(0, np.uint8)
    yield np.asarray([7], np.uint8)
    yield RNG.integers(0, 256, 10000, np.uint8)
    yield np.zeros(5000, np.uint8)
    yield np.tile(np.arange(9, dtype=np.uint8), 2000)
    yield RNG.integers(0, 2, 30000, np.uint8).astype(np.uint8)  # binary alpha
    yield np.repeat(RNG.integers(0, 5, 200),
                    RNG.integers(1, 400, 200)).astype(np.uint8)  # runs
    # fibonacci string: worst-case overlapping-repeat structure
    s, t = b"a", b"ab"
    while len(t) < 20000:
        s, t = t, t + s
    yield np.frombuffer(t[:20000], np.uint8)


@pytest.mark.parametrize("idx", range(8))
def test_filtered_matches_spec(idx):
    data = list(cases())[idx]
    assert np.array_equal(suffix_array_device_filtered(data), suffix_array(data))


@pytest.mark.parametrize("idx", range(8))
def test_device_resident_filtered_matches_spec(idx):
    import jax
    import jax.numpy as jnp

    from sa_filtered import _sa_doubling_filtered

    data = list(cases())[idx]
    if data.size < 2:
        return
    order, isa, _ = _sa_doubling_filtered(jnp.asarray(data), int(data.size))
    want = suffix_array(data)
    assert np.array_equal(np.asarray(jax.device_get(order)), want)
    assert np.array_equal(
        np.asarray(jax.device_get(isa)),
        np.argsort(want, kind="stable").astype(np.int32),
    )
